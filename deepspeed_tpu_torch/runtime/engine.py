"""Training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``).

``initialize(config, model)`` returns an :class:`Engine` whose
``train_batch(batch)`` runs one optimizer step over ``train_batch_size``
samples, in the JAX step's order (``_train_step_impl``):

1. the compute params: the fp32 master cast to the compute dtype, as leaf
   tensors (one per layer for the stacked weights, so each layer's grad is
   its own tensor and nothing sums a whole stack per layer);
2. gradient accumulation (``_gas_scan``): per micro-batch, backward of
   ``loss * scale / (gas * dp_world)``; the accumulator
   (``grad_accum_dtype``, default fp32) is seeded from the first
   micro-batch's grads; the loss is summed;
3. grads reduced over the ranks, unscaled to fp32, the finite check (fp16
   only), the global norm and ``min(1, clip / (gnorm + 1e-6))``, the lr at
   the old step, the update (or a skip) and the loss-scale update.

The JAX engine compiles all of that into one program over a device mesh
and its ZeRO stage into sharding constraints (``runtime/zero/``). Here it
runs eagerly, one process per device; in a ``torch.distributed`` world
(``platform/distributed.py``) each ZeRO choice of ``runtime/zero/
partitioning.py`` is an explicit collective over the mesh's process groups
(``runtime/zero/shards.py``):

- stage 0: grads all-reduced once a step;
- stage 1: the master and moments cut over the partition group; grads
  all-reduced, each rank updates its shard, the cast shards all-gathered;
- stage 2: grads reduce-scattered into the master layout in flat buckets
  of ``reduce_bucket_size`` elements;
- stage 3: compute leaves cut too and gathered layer by layer on use, their
  grads reduce-scattered as each layer's backward ends; leaves under
  ``param_persistence_threshold`` stay whole;
- hpZ: the compute shard spans ``zero`` and is built by one all-gather over
  ``data`` after the update (int8 with qwZ); MiCS: the partition group is
  ``zero`` and grads are all-reduced across ``data`` after it.

Tensor and expert parallelism (``mesh.model`` / ``mesh.expert``): with a
process group the engine stamps the rank's ``TPLayout`` on the model, holds
the rank's cut of every leaf (``TPLayout.cut``: heads, FFN columns,
vocabulary rows, experts), and composes each ZeRO cut with it over the
leaf's ``data`` / ``zero`` line, inside its ``model`` line; the model's
forward issues Megatron's collectives (``models/transformer.py``). Each
leaf's grads are reduced over the batch lines its copies see (an expert
bank over ``("data", "zero")``, a dense leaf over ``BATCH_AXES``), a KV
head several ranks hold summed over them, and the global norm counts
every element once.

With no process group the engine holds every leaf whole and runs no
collective; in a world of one it runs them all over a group of one rank.

The compute cast keeps the leaves the model names in
``fp32_param_names()`` (an MoE router) in fp32, and the ``moe`` section
sets an MoE model's knobs; the eval step routes with the eval capacity.

``save_checkpoint`` / ``load_checkpoint`` / ``wait_for_checkpoint`` write
and restore the state, each leaf whole (``runtime/checkpoint/engine.py``),
so any world size reads any tag; ``resilience.resume: "auto"`` restores the
newest verified tag at construction, and ``resilience.
max_consecutive_bad_steps`` halts a run whose steps keep failing
(``NonFiniteLossError``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..comm import comm
from ..config import Config
from ..models.convert import cut_leaf, gather_leaf
from ..models.transformer import (LAYER_PREFIX, REMAT_POLICIES, Params,
                                  TPLayout, param_shapes, param_specs)
from ..platform.device import resolve_device
from ..platform.mesh import (AXIS_ORDER, BATCH_AXES, MeshSpec, build_mesh,
                             dp_world_size)
from ..resilience import chaos
from ..resilience.guards import NonFiniteLossError
from ..utils.logging import log_dist
from ..utils.roadmap import later
from .checkpoint import engine as ckpt
from .loss_scaler import grads_finite, init_loss_scale, update_loss_scale
from .lr_schedules import build_schedule
from .optimizers import ONEBIT_TYPES, build_optimizer
from .zero.partitioning import ZeroPartitioner, param_size, stacked_fn
from .zero.shards import (Cut, GatherSet, LeafPlan, compute_shard,
                          gather_compute, reduce_scatter_buckets, spec_cut)


# the projections whose heads a rank may share with others of its model line
_KV_LEAVES = ("wk", "wv", "bk", "bv")


def mesh_spec(cfg: Config) -> MeshSpec:
    """The mesh degrees with the ``zero`` sub-axis resolved from hpZ / MiCS
    (JAX ``_mesh_spec``, ``engine.py:541-577``): ``mesh.data`` is the whole
    data-parallel degree and the subgroup is carved out of it."""
    zc, m = cfg.zero_optimization, cfg.mesh
    hpz = int(zc.zero_hpz_partition_size)
    mics = int(zc.mics_shard_size or 0)
    if hpz > 1 and mics > 0 and hpz != mics:
        raise ValueError(
            f"zero_hpz_partition_size ({hpz}) and mics_shard_size ({mics}) "
            "both set but disagree; they share the mesh 'zero' sub-axis")
    mzero = int(m.zero or 1)
    if mzero < 1:
        raise ValueError(
            "mesh.zero cannot be auto (-1): the hpZ/MiCS subgroup size must "
            "be explicit (zero_hpz_partition_size / mics_shard_size)")
    want = hpz if hpz > 1 else (mics if mics > 0 else 1)
    if mzero > 1 and want > 1 and mzero != want:
        raise ValueError(f"mesh.zero ({mzero}) conflicts with the configured "
                         f"hpZ/MiCS subgroup size ({want})")
    zsize = max(mzero, want)
    if zc.zero_quantized_weights and hpz <= 1:
        raise ValueError(
            "zero_quantized_weights needs a cross-subgroup weight gather to "
            "quantize: set zero_optimization.zero_hpz_partition_size > 1 "
            "(under MiCS or a bare mesh.zero the master shard never spans "
            "'data', so there is no gather to compress)")
    data = m.data
    if data != -1 and zsize > 1:
        if data % zsize != 0:
            raise ValueError(f"data-parallel degree {data} not divisible by "
                             f"hpZ/MiCS subgroup size {zsize}")
        data //= zsize
    return MeshSpec(data=data, model=m.model, pipe=m.pipe, seq=m.seq,
                    expert=m.expert, zero=zsize)


class Engine:
    """Owns this rank's fp32 master state, the optimizer state and the
    step."""

    def __init__(self, config, model, seed: Optional[int] = None,
                 params: Optional[Params] = None, device=None):
        cfg = Config.from_any(config)
        if cfg.checkpoint.use_node_local_storage:
            raise ValueError(
                "checkpoint.use_node_local_storage is not supported: a tag "
                "holds whole tensors, written once for every rank; point "
                "save_dir at local storage instead")
        mcfg = cfg.moe
        if mcfg.enabled:
            # the moe section overrides the model's MoE knobs
            if model.cfg.num_experts != mcfg.num_experts:
                raise ValueError(
                    f"config.moe.num_experts={mcfg.num_experts} but the "
                    f"model was built with {model.cfg.num_experts}")
            model.cfg = dataclasses.replace(
                model.cfg, moe_top_k=mcfg.top_k,
                moe_capacity_factor=mcfg.capacity_factor,
                moe_eval_capacity_factor=mcfg.eval_capacity_factor,
                moe_min_capacity=mcfg.min_capacity,
                moe_drop_tokens=mcfg.drop_tokens,
                moe_aux_loss_weight=mcfg.aux_loss_weight)
        self.model = model
        self.device = resolve_device(device)
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "Engine: torch.backends.cuda.matmul.allow_tf32 is True; fp32 "
                "products would be TF32. Set it to False (PyTorch's default).")
        self.mesh = build_mesh(mesh_spec(cfg))
        if self.mesh.active:
            import torch.distributed as dist

            want = "nccl" if self.device.type == "cuda" else "gloo"
            if dist.get_backend() != want:
                raise ValueError(
                    f"Engine: the process group runs {dist.get_backend()}, "
                    f"and a {self.device.type} engine needs {want} "
                    "(init_distributed(device=...) picks it)")
        # the rank's cut of every leaf (None: no process group, all whole)
        self.layout = TPLayout.of(model.cfg, self.mesh, rows_split=True) \
            if self.mesh.active else None
        model.tp_layout = self.layout
        self.dp_world = dp_world_size(self.mesh)
        self.config = cfg = cfg.resolve_batch_sizes(self.dp_world)
        self.seed = cfg.seed if seed is None else seed
        opt_type = cfg.optimizer.type.lower().replace("-", "_")
        if opt_type in ONEBIT_TYPES:
            raise NotImplementedError(
                f"optimizer {cfg.optimizer.type!r} (1-bit, runtime/onebit.py)"
                f" is not ported yet: {later(8)}")
        self.optimizer = build_optimizer(opt_type, cfg.optimizer.params,
                                         norm=self._leaf_norm)
        base_lr = float(cfg.optimizer.params.get("lr", 1e-3))
        sched = cfg.scheduler
        self.lr_schedule = build_schedule(sched.type if sched else None,
                                          sched.params if sched else {},
                                          base_lr)
        self.remat_policy = cfg.remat.resolved
        if self.remat_policy is not None \
                and self.remat_policy not in REMAT_POLICIES:
            raise NotImplementedError(
                f"remat policy {self.remat_policy!r} (activations offloaded "
                f"to the host) is not ported yet: {later(6, 'b')}")
        self.compute_dtype = cfg.compute_dtype
        self.accum_dtype = cfg.accum_dtype
        self._fp32_names = frozenset(model.fp32_param_names())
        zc = cfg.zero_optimization
        # ZeRO cuts the rank's cut of a leaf: its divisibility is the local
        # shape's, the model's own spec still marks the dims TP took
        self.partitioner = ZeroPartitioner(
            zc.stage, {**self.mesh.shape, "model": 1, "expert": 1},
            param_persistence_threshold=zc.param_persistence_threshold,
            zero_hpz_partition_size=zc.zero_hpz_partition_size,
            mics_shard_size=zc.mics_shard_size)
        self.shapes = shapes = param_shapes(model.cfg)
        self.tp_axes = {k: self.layout.cut_axes(model.cfg, k)
                        if self.layout is not None else {} for k in shapes}
        local = {k: self.layout.local_shape(model.cfg, k, s)
                 if self.layout is not None else tuple(s)
                 for k, s in shapes.items()}
        specs, stacked = param_specs(model.cfg), stacked_fn(model.cfg.n_layer)
        self.master_specs = {k: self.partitioner.master_spec(
            specs.get(k), local[k], stacked=stacked(tuple(shapes[k])))
            for k in shapes}
        self.compute_specs = {k: self.partitioner.compute_spec(
            specs.get(k), local[k], stacked=stacked(tuple(shapes[k])))
            for k in shapes}
        self.plans = {k: self._plan(k, local[k]) for k in shapes}
        self.param_count = sum(param_size(s) for s in shapes.values())
        self.master = self._init_master(params)
        self.opt_state = self.optimizer.init(self.master)
        self.loss_scale = init_loss_scale(cfg.fp16)
        self.step = 0                 # the optimizer step (TrainState.step)
        self.skipped_steps = 0
        self.global_steps = 0
        # stage 3: the most layers gathered at once in the last step
        self.gather_peak_layers = 0
        # checkpoints (runtime/checkpoint/engine.py): the host buffers, an
        # async save in flight, the event the next update waits for
        self._host_state = None
        self._pending_save = None
        self._snapshot_event = None
        self._ckpt_stream = None
        self.last_checkpoint_timing: dict = {}
        # the non-finite sentinel and the chaos preemption step
        self._max_bad_steps = int(cfg.resilience.max_consecutive_bad_steps
                                  or 0)
        self._bad_step_streak = 0
        self._skipped_total_prev = 0.0
        self._chaos_preempt = chaos.preempt_step()
        self._preempt_guard = None    # resilience/preempt.py, when installed
        log_dist(f"engine: {self.param_count / 1e6:.1f}M params | zero stage "
                 f"{cfg.zero_stage} | mesh {self.mesh.shape} | {self.device} "
                 f"{self.compute_dtype} | "
                 f"micro={cfg.train_micro_batch_size_per_gpu} "
                 f"gas={cfg.gradient_accumulation_steps} "
                 f"global={cfg.train_batch_size} | remat "
                 f"{self.remat_policy}", ranks=[0])
        # last: the engine is whole, so this is a user's load_checkpoint
        # (verified-tag fallback included)
        if cfg.resilience.resume == "auto":
            ckpt.auto_resume(self, cfg.resilience.resume_dir)

    # ------------------------------------------------------------- state
    def _plan(self, name: str, shape: tuple) -> LeafPlan:
        """Where the leaf lives on this rank (``runtime/zero/shards.py``).
        With a process group, a leaf the stage cuts is cut even where its
        line is one rank (a world of one): a chunk of one, and every
        collective runs."""
        mesh, part = self.mesh, self.partitioner
        layered = name.startswith(LAYER_PREFIX)
        if not mesh.active:
            return LeafPlan(name, shape, layered)

        def cut(spec, axes, wanted):
            c = spec_cut(spec, mesh, only=("data", "zero"))
            if c is None and wanted and mesh.size(axes) == 1:
                return Cut(1 if layered else 0, axes, 1, 0)
            return c

        master = cut(self.master_specs[name], part.dp_axes, part.stage >= 1)
        compute = cut(self.compute_specs[name], part.compute_axes,
                      part.stage >= 3 and param_size(shape) >= part.threshold)
        hier = False
        if compute is not None and compute != master:
            hier = (part.hpz and master is not None
                    and compute.dim == master.dim
                    and master.axes == ("data", "zero")
                    and compute.axes == ("zero",))
            if not hier:
                # hpZ's secondary layout that does not nest in the master's
                # (another dim): the compute copy is held whole
                compute = None
        qwz = bool(self.config.zero_optimization.zero_quantized_weights
                   and part.hpz and master is not None
                   and "data" in master.axes
                   and not self._keeps_fp32(name))
        return LeafPlan(name, shape, layered, master, compute, hier,
                        mesh.shape["data"], qwz)

    def _keeps_fp32(self, name: str) -> bool:
        return name.rsplit(".", 1)[-1] in self._fp32_names

    def _compute_dtype_of(self, name: str) -> torch.dtype:
        """The compute copy's dtype: fp32 for the model's
        ``fp32_param_names()`` leaves (which qwZ leaves alone too)."""
        return torch.float32 if self._keeps_fp32(name) \
            else self.compute_dtype

    def local_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's tensor- / expert-parallel cut of a whole
        ``name``-shaped tensor; anything else as it is."""
        if self.layout is None or not self.tp_axes[name] \
                or tuple(full.shape) != tuple(self.shapes[name]):
            return full
        return cut_leaf(full, self.layout.cut(self.model.cfg, name))

    def shard_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole ``name``-shaped tensor (the master
        or a moment): its tensor-parallel cut, then its ZeRO shard of
        that; anything else (a (0,) placeholder) as it is."""
        plan = self.plans[name]
        full = self.local_of(name, full)
        if plan.master is None or tuple(full.shape) != plan.shape:
            return full
        return plan.master.shard(full)

    def whole_of(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's tensor-parallel cut ``local``
        (each whole over ZeRO): all-gathered over the leaf's ``model`` and
        ``expert`` lines and placed by each rank's layout; a collective of
        those lines."""
        axes = self.tp_axes[name]
        if not axes:
            return local
        lay, cfg = self.layout, self.model.cfg
        cut = set(axes.values())
        tp = lay.tp if "model" in cut else 1
        ep = lay.ep if "expert" in cut else 1
        stack = local[None, None]
        if tp > 1:
            stack = comm.all_gather(stack, "model", 1, mesh=self.mesh)
        if ep > 1:
            stack = comm.all_gather(stack, "expert", 0, mesh=self.mesh)
        return gather_leaf({(m, e): stack[e, m] for e in range(ep)
                            for m in range(tp)}, cfg, name, lay.tp, lay.ep)

    def _init_master(self, params: Optional[Params]) -> Params:
        """fp32 master shards on the device: ``model.init`` from a generator
        seeded by ``seed`` (``_init_state``), or a copy of ``params``
        (``_init_state_from``); each rank keeps its own part."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            full = self.model.init(gen, device=self.device,
                                   dtype=torch.float32)
            return {k: v if self.plans[k].master is None
                    and not self.tp_axes[k] else
                    self.shard_of(k, v).clone(
                        memory_format=torch.contiguous_format)
                    for k, v in full.items()}
        want = param_shapes(self.model.cfg)
        if set(params) != set(want):
            raise ValueError(f"params: missing {sorted(set(want) - set(params))}"
                             f", unexpected {sorted(set(params) - set(want))}")
        return {k: self.shard_of(k, torch.as_tensor(v)).to(
                    self.device, torch.float32, copy=True).contiguous()
                for k, v in params.items()}

    def fp32_params(self) -> Params:
        """The whole fp32 master on the host (the JAX engine's
        ``fp32_params``); a collective: every rank calls it."""
        out = {}
        for k, v in self.master.items():
            cut = self.plans[k].master
            if cut is not None:
                v = comm.all_gather(v, cut.axes, cut.dim, mesh=self.mesh)
            v = self.whole_of(k, v.detach())
            out[k] = v.to("cpu", torch.float32, copy=True)
        return out

    def _cut_lines(self, name: str) -> tuple:
        """The axes whose ranks hold different parts of leaf ``name``: its
        ZeRO cut's and its tensor- / expert-parallel cut's."""
        cut = self.plans[name].master
        zero = cut.axes if cut is not None and cut.n > 1 else ()
        return tuple(zero) + tuple(sorted(set(self.tp_axes[name].values())))

    def _kv_copy(self, name: str) -> bool:
        """Is this rank's part of ``name`` a second copy of a KV head
        another rank of its ``model`` line holds first (``kv_shared``)?"""
        lay = self.layout
        if lay is None or not lay.kv_shared or name.rsplit(".", 1)[-1] \
                not in _KV_LEAVES:
            return False
        cfg = self.model.cfg
        return (lay.m * lay.heads) % (cfg.n_head // cfg.kv_heads) != 0

    def _leaf_norm(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The norm of the whole leaf ``name`` from this rank's part ``t``
        (LAMB's trust ratio): a sum of squares all-reduced over the leaf's
        lines before the square root (a KV head's copies counted once)."""
        lines = self._cut_lines(name)
        if not lines:
            return t.norm()
        sq = torch.sum(torch.square(t.float()))
        if self._kv_copy(name):
            sq = torch.zeros_like(sq)
        return torch.sqrt(comm.all_reduce(sq, lines, mesh=self.mesh))

    def _cast_compute(self):
        """(params for ``model.loss``, their leaf tensors by name, the
        stage-3 compute shards): the master in the compute dtype, gathered
        whole where the leaf's compute copy is whole; a stacked ``layers.*``
        leaf becomes a list of per-layer leaf tensors (views of one copy).
        A stage-3 cut leaf is its compute shard, gathered on use."""
        params, leaves, shards = {}, {}, {}
        for k, p in self.master.items():
            plan = self.plans[k]
            dtype = self._compute_dtype_of(k)
            if plan.compute is not None:
                shards[k] = compute_shard(plan, p.detach(), self.mesh, dtype)
                continue
            c = gather_compute(plan, p.detach(), self.mesh, dtype)
            if k.startswith(LAYER_PREFIX):
                leaves[k] = [c[i].detach().requires_grad_()
                             for i in range(len(c))]
                params[k] = leaves[k]
            else:
                leaves[k] = [c.requires_grad_()]
                params[k] = c
        return params, leaves, shards

    # -------------------------------------------------------------- step
    def _gas(self, batch: dict, scale: float):
        """Accumulated grads (accumulation dtype; whole local sums, or for a
        stage-3 cut leaf the shard reduce-scattered inside its compute
        group) and this rank's part of the loss summed over micro-batches
        (``_gas_scan``)."""
        gas = int(self.config.gradient_accumulation_steps)
        div = gas * self.dp_world
        params, leaves, shards = self._cast_compute()
        acc, loss = {}, None
        gs = None
        if shards:
            gs = GatherSet(self.mesh, self.device)
            for k, sh in shards.items():
                acc[k] = torch.empty(sh.shape, dtype=self.accum_dtype,
                                     device=self.device)
        for i in range(gas):
            mb = {k: v[i] for k, v in batch.items()}
            p = dict(params)
            for k, sh in shards.items():
                p[k] = gs.leaf(k, self.plans[k], sh, acc[k])
            scaled = self.model.loss(p, mb, remat_policy=self.remat_policy) \
                * scale / div
            scaled.backward()
            if gs is not None:
                gs.release_all()
            part = scaled.detach() / scale
            loss = part if loss is None else loss + part
            for k, ls in leaves.items():
                if k not in acc:
                    acc[k] = torch.empty(self.plans[k].shape,
                                         dtype=self.accum_dtype,
                                         device=self.device)
                    ref = acc[k] if k.startswith(LAYER_PREFIX) else acc[k][None]
                    for j, leaf in enumerate(ls):
                        ref[j].copy_(leaf.grad if leaf.grad is not None
                                     else torch.zeros_like(leaf))
                else:
                    ref = acc[k] if k.startswith(LAYER_PREFIX) else acc[k][None]
                    for j, leaf in enumerate(ls):
                        if leaf.grad is not None:
                            ref[j].add_(leaf.grad.to(self.accum_dtype))
                for leaf in ls:
                    leaf.grad = None
        if gs is not None:
            for k in shards:
                layers = range(self.plans[k].shape[0]) \
                    if self.plans[k].layered else (None,)
                for j in layers:
                    if not gs.seeded(k, j):   # no grad reached it
                        (acc[k] if j is None else acc[k][j]).zero_()
            self.gather_peak_layers = gs.peak_layers
        return acc, loss

    def _grad_lines(self, name: str) -> tuple:
        """The batch axes whose ranks hold copies of leaf ``name`` and sum
        its grads: all of ``BATCH_AXES``, but ``expert`` for an expert
        bank (each rank of the line holds other experts)."""
        if "expert" in self.tp_axes[name].values():
            return ("data", "zero")
        return BATCH_AXES

    def _reduce_grads(self, acc: dict) -> dict:
        """This rank's grads in the master layout, summed over the ranks:
        all-reduced over the leaf's batch lines (whole masters, stages 0-1
        and stage 3's whole compute leaves, then cut), reduce-scattered in
        buckets (stage 2), or, for a stage-3 cut leaf, finished across
        ``data`` (hpZ reduce-scatter, MiCS all-reduce); a dense leaf cut
        over ZeRO is then summed over ``expert``, and a KV head several
        ranks hold over the ``model`` line."""
        mesh, part = self.mesh, self.partitioner
        if not mesh.active:
            return acc
        out, bucket, rest = {}, [], []
        for k in sorted(acc):
            plan, g = self.plans[k], acc[k]
            lines = self._grad_lines(k)
            if plan.compute is not None:
                done = set(plan.compute.axes)
                if plan.hier:
                    g = comm.reduce_scatter(g, ("data",), plan.master.dim,
                                            mesh=mesh)
                    done.add("data")
                elif part.mics:
                    comm.all_reduce(g, ("data",), mesh=mesh)
                    done.add("data")
                out[k] = g
                rest.append((k, tuple(a for a in lines if a not in done)))
            elif plan.master is None or part.stage != 2:
                comm.all_reduce(g, lines, mesh=mesh)
                out[k] = g if plan.master is None \
                    else plan.master.shard(g).contiguous()
            else:
                bucket.append((k, g, plan.master))
                done = set(part.dp_axes) | ({"data"} if part.mics else set())
                rest.append((k, tuple(a for a in lines if a not in done)))
        if bucket:
            red = reduce_scatter_buckets(
                bucket, part.dp_axes, mesh,
                self.config.zero_optimization.reduce_bucket_size)
            for k, g in red.items():
                if part.mics:
                    comm.all_reduce(g, ("data",), mesh=mesh)
                out[k] = g
        by_axes = {}
        for k, axes in rest:
            if mesh.size(axes) > 1:
                by_axes.setdefault(axes, []).append((k, out[k]))
        for axes, items in by_axes.items():
            self._sum_flat(items, axes)
        if self.layout is not None and self.layout.kv_shared:
            self._sum_kv_heads(out)
        return out

    def _sum_flat(self, items: list, axes) -> None:
        """All-reduce ``items`` ((name, tensor)) over ``axes`` in place, as
        one flat buffer."""
        if not items:
            return
        flat = torch.cat([t.reshape(-1) for _, t in items])
        comm.all_reduce(flat, axes, mesh=self.mesh)
        off = 0
        for _, t in items:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()

    def _sum_kv_heads(self, grads: dict) -> None:
        """Sum the grads of each KV head over the ranks of the ``model``
        line that hold it (``kv_shared``): each rank's grads placed at its
        head's slot of a buffer as wide as all heads, one all-reduce, each
        rank's slot read back."""
        lay, kv = self.layout, self.model.cfg.kv_heads
        names = [k for k in sorted(grads) if k.rsplit(".", 1)[-1]
                 in _KV_LEAVES]
        pads = []
        for k in names:
            g = grads[k]
            n = g.shape[-1]
            pad = torch.zeros(g.shape[:-1] + (kv * n,), dtype=g.dtype,
                              device=g.device)
            pad[..., lay.kv0 * n:(lay.kv0 + 1) * n].copy_(g)
            pads.append((k, pad))
        self._sum_flat(pads, "model")
        for k, pad in pads:
            n = grads[k].shape[-1]
            grads[k].copy_(pad[..., lay.kv0 * n:(lay.kv0 + 1) * n])

    def _global_norm(self, grads: dict, names: list) -> torch.Tensor:
        """sqrt of the sum of squares over the elements each rank owns,
        all-reduced over the partition group and the ``model`` and
        ``expert`` lines: a leaf whole over the partition group is counted
        by the group's first rank only, a leaf whole over ``model`` or
        ``expert`` by the line's first rank, a KV head several ranks hold
        by the first of them."""
        dp = self.partitioner.dp_axes
        first = self.mesh.index(dp) == 0
        total = None
        for k in names:
            if self.plans[k].master is None and not first:
                continue
            cut = self.tp_axes[k].values()
            if any(a not in cut and self.mesh.index(a) != 0
                   for a in ("model", "expert")) or self._kv_copy(k):
                continue
            s = torch.sum(torch.square(grads[k]))
            total = s if total is None else total + s
        if total is None:
            total = torch.zeros((), dtype=torch.float32, device=self.device)
        comm.all_reduce(total, dp + ("expert", "model"), mesh=self.mesh)
        return torch.sqrt(total)

    def _train_step(self, batch: dict) -> dict:
        cfg = self.config
        scale = self.loss_scale.scale
        grads, loss = self._gas(batch, scale)
        comm.all_reduce(loss, BATCH_AXES, mesh=self.mesh)
        grads = self._reduce_grads(grads)
        names = sorted(grads)          # the JAX tree's leaf order
        for k in names:
            g = grads[k].float() if grads[k].dtype != torch.float32 \
                else grads[k]
            grads[k] = g.div_(scale)
        finite = True
        if cfg.fp16.enabled:
            flag = grads_finite(grads[k] for k in names).float()
            finite = bool(comm.all_reduce(flag, AXIS_ORDER, "min",
                                          mesh=self.mesh))
        gnorm = self._global_norm(grads, names)
        if cfg.gradient_clipping and cfg.gradient_clipping > 0:
            coef = torch.clamp(cfg.gradient_clipping / (gnorm + 1e-6), max=1.0)
            for k in names:
                grads[k].mul_(coef)
        lr = self.lr_schedule(self.step)
        if self._snapshot_event is not None:
            # an async save's copy of the state must end before the update
            # writes the state in place
            torch.cuda.current_stream(self.device).wait_event(
                self._snapshot_event)
            self._snapshot_event = None
        if finite:
            self.optimizer.update(self.master, self.opt_state, grads, lr)
        self.loss_scale = update_loss_scale(self.loss_scale, finite, cfg.fp16)
        self.skipped_steps += 0 if finite else 1
        self.step += 1
        return {"loss": loss, "grad_norm": gnorm, "lr": lr,
                "loss_scale": scale, "skipped": 0 if finite else 1}

    def _make_global(self, batch: dict, gas_dim: bool = True) -> dict:
        """This rank's host batch of ``gas × micro`` rows → device tensors
        shaped ``(gas, micro, ...)`` (``(rows, ...)`` without ``gas_dim``)."""
        gas = int(self.config.gradient_accumulation_steps)
        rows = gas * int(self.config.train_micro_batch_size_per_gpu)
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v)).to(self.device)
            if gas_dim:
                if t.shape[0] != rows:
                    raise ValueError(
                        f"train_batch: {k} has {t.shape[0]} rows; this rank "
                        f"takes gas x micro = {rows} (train_batch_size / "
                        f"{self.dp_world} ranks)")
                t = t.reshape((gas, t.shape[0] // gas) + tuple(t.shape[1:]))
            out[k] = t
        return out

    # ----------------------------------------------------------- public
    def train_batch(self, batch: dict) -> dict:
        """One optimizer step. ``batch`` holds this rank's
        ``train_batch_size / dp_world`` rows (numpy or anything
        ``np.asarray`` reads), or device tensors already shaped ``(gas,
        micro, ...)``. Returns ``loss`` (the mean over the ranks) and
        ``grad_norm`` as 0-d device tensors (no synchronisation), ``lr``,
        ``loss_scale`` and ``skipped`` as host numbers."""
        if self._chaos_preempt is not None \
                and self.global_steps == self._chaos_preempt:
            chaos.deliver_preemption()
        guard = self._preempt_guard
        if guard is not None and self.mesh.world > 1 and not guard.committed:
            # the ranks agree on a signal any of them took (the handler
            # cannot run a collective); then all commit together, once
            flag = torch.tensor([float(guard.preempted)], device=self.device)
            if comm.all_reduce(flag, AXIS_ORDER, "max", mesh=self.mesh):
                guard.preempted = guard.committed = True
                guard.commit()
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = self._make_global(batch)
        metrics = self._train_step(batch)
        self.global_steps += 1
        if self.global_steps % self.config.steps_per_print == 0:
            loss = float(metrics["loss"])
            self._sentinel_at_boundary(loss)
            log_dist(f"step={self.global_steps} loss={loss:.4f} "
                     f"lr={metrics['lr']:.3e} "
                     f"gnorm={float(metrics['grad_norm']):.3f}", ranks=[0])
        return metrics

    def eval_batch(self, batch: dict) -> float:
        """The loss of this rank's rows on the current master, averaged
        over the ranks (a collective); an MoE model routes with its eval
        capacity factor here."""
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = self._make_global(batch, gas_dim=False)
        with torch.no_grad():
            cp, gs = {}, None
            for k, p in self.master.items():
                plan = self.plans[k]
                dtype = self._compute_dtype_of(k)
                if plan.compute is None:
                    cp[k] = gather_compute(plan, p, self.mesh, dtype)
                    continue
                gs = gs or GatherSet(self.mesh, self.device)
                cp[k] = gs.leaf(k, plan, compute_shard(
                    plan, p, self.mesh, dtype), None)
            loss = self._eval_loss(cp, batch)
            if gs is not None:
                gs.release_all()
            return float(comm.all_reduce(loss.float(), BATCH_AXES, "mean",
                                         mesh=self.mesh))

    def _eval_loss(self, params, batch):
        """``model.loss`` with an MoE model's eval capacity; the flag is
        restored however the loss ends."""
        if self.model.cfg.num_experts <= 1:
            return self.model.loss(params, batch)
        self.model.moe_eval_mode = True
        try:
            return self.model.loss(params, batch)
        finally:
            self.model.moe_eval_mode = False

    # ----------------------------------------------------------- resilience
    def _note_bad_steps(self, bad: bool, window: int, last_loss: float) -> None:
        """Non-finite sentinel: ``bad`` covers ``window`` consecutive
        optimizer steps. K consecutive bad steps halt with a typed error:
        a collapsed run (a loss-scale death spiral, NaN weights) must stop
        burning budget, and its supervisor must see a typed cause."""
        if not self._max_bad_steps:
            return
        self._bad_step_streak = self._bad_step_streak + window if bad else 0
        if self._bad_step_streak >= self._max_bad_steps:
            raise NonFiniteLossError(
                f"halting: {self._bad_step_streak} consecutive bad optimizer "
                f"steps (threshold {self._max_bad_steps}) — non-finite loss "
                "or every step skipped on overflow; last loss "
                f"{last_loss!r} at global step {self.global_steps}. Resume "
                "from the last good checkpoint with a lower lr / higher "
                "initial loss scale.",
                streak=self._bad_step_streak, last_loss=last_loss)

    def _sentinel_at_boundary(self, loss: float) -> None:
        """At each ``steps_per_print`` boundary (where the loss is read
        anyway): the window is bad if every step in it was skipped or the
        loss is not finite."""
        if not self._max_bad_steps:
            return
        window = int(self.config.steps_per_print)
        skipped_total = float(self.skipped_steps)
        all_skipped = (skipped_total - self._skipped_total_prev) >= window
        self._skipped_total_prev = skipped_total
        self._note_bad_steps(all_skipped or not math.isfinite(loss),
                             window, loss)

    # ----------------------------------------------------------- checkpoint
    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None) -> str:
        """Save the whole state under ``<save_dir>/<tag>`` (default
        ``global_step<N>``), crash-safe; async under
        ``checkpoint.async_save``."""
        return ckpt.save_checkpoint(self, save_dir, tag)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None) -> str:
        """Restore the state from ``latest`` (verified, else the newest
        verified tag) or from the pinned ``tag``."""
        return ckpt.load_checkpoint(self, load_dir, tag)

    def wait_for_checkpoint(self) -> None:
        """Block until an async save is written, then commit it."""
        ckpt.wait_for_checkpoint(self)

    @property
    def lr(self) -> float:
        return self.lr_schedule(self.step)

    @property
    def train_batch_size(self) -> int:
        return int(self.config.train_batch_size)


def initialize(config=None, model=None, seed: Optional[int] = None,
               params: Optional[Params] = None, device=None) -> Engine:
    """Public entry point (``deepspeed_tpu.initialize``): the engine on
    ``cuda`` unless ``device`` says otherwise; raises without a card."""
    if model is None:
        raise ValueError("initialize() requires a model")
    return Engine(config, model, seed=seed, params=params, device=device)
