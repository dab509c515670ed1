"""Training engine for one card (counterpart of
``deepspeed_tpu/runtime/engine.py``).

``initialize(config, model)`` returns an :class:`Engine` whose
``train_batch(batch)`` runs one optimizer step over ``train_batch_size``
samples, in the JAX step's order (``_train_step_impl``):

1. the compute params: the fp32 master cast to the compute dtype, as leaf
   tensors (one per layer for the stacked weights, so each layer's grad is
   its own tensor and nothing sums a whole stack per layer);
2. gradient accumulation (``_gas_scan``): per micro-batch, backward of
   ``loss * scale / gas``; the accumulator (``grad_accum_dtype``, default
   fp32) is seeded from the first micro-batch's grads; the loss is summed;
3. grads unscaled to fp32, the finite check (fp16 only), the global norm
   and ``min(1, clip / (gnorm + 1e-6))``, the lr at the old step, the
   update (or a skip) and the loss-scale update.

``save_checkpoint`` / ``load_checkpoint`` / ``wait_for_checkpoint`` write
and restore the whole state (``runtime/checkpoint/engine.py``);
``resilience.resume: "auto"`` restores the newest verified tag at
construction, and ``resilience.max_consecutive_bad_steps`` halts a run
whose steps keep failing (``NonFiniteLossError``).

The JAX engine compiles all of that into one program over a device mesh;
here it runs eagerly on one device. ZeRO stages 0-3 are accepted at world
size 1, where the JAX partitioner keeps the whole state on the one rank; a
``torch.distributed`` world above 1 raises.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..models.transformer import (LAYER_PREFIX, REMAT_POLICIES, Params,
                                  param_shapes)
from ..platform.device import resolve_device
from ..resilience import chaos
from ..resilience.guards import NonFiniteLossError
from ..utils.logging import log_dist
from ..utils.roadmap import later
from .checkpoint import engine as ckpt
from .loss_scaler import grads_finite, init_loss_scale, update_loss_scale
from .lr_schedules import build_schedule
from .optimizers import ONEBIT_TYPES, build_optimizer


class Engine:
    """Owns the fp32 master state, the optimizer state and the step."""

    def __init__(self, config, model, seed: Optional[int] = None,
                 params: Optional[Params] = None, device=None):
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise NotImplementedError(
                "multi-rank training (runtime/zero/partitioning.py) is not "
                f"ported yet: {later(1)}")
        self.config = Config.from_any(config).resolve_batch_sizes(1)
        cfg = self.config
        if cfg.checkpoint.use_node_local_storage:
            raise ValueError(
                "checkpoint.use_node_local_storage is not supported: a tag "
                "holds whole tensors, written once for every rank; point "
                "save_dir at local storage instead")
        self.model = model
        self.device = resolve_device(device)
        if self.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "Engine: torch.backends.cuda.matmul.allow_tf32 is True; fp32 "
                "products would be TF32. Set it to False (PyTorch's default).")
        self.seed = cfg.seed if seed is None else seed
        opt_type = cfg.optimizer.type.lower().replace("-", "_")
        if opt_type in ONEBIT_TYPES:
            raise NotImplementedError(
                f"optimizer {cfg.optimizer.type!r} (1-bit, runtime/onebit.py)"
                f" is not ported yet: {later(8)}")
        self.optimizer = build_optimizer(opt_type, cfg.optimizer.params)
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
                f"to the host) is not ported yet: {later(6)}")
        self.compute_dtype = cfg.compute_dtype
        self.accum_dtype = cfg.accum_dtype
        self.master = self._init_master(params)
        self.param_count = sum(p.numel() for p in self.master.values())
        self.opt_state = self.optimizer.init(self.master)
        self.loss_scale = init_loss_scale(cfg.fp16)
        self.step = 0                 # the optimizer step (TrainState.step)
        self.skipped_steps = 0
        self.global_steps = 0
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
        log_dist(f"engine: {self.param_count / 1e6:.1f}M params | zero stage "
                 f"{cfg.zero_stage} | {self.device} {self.compute_dtype} | "
                 f"micro={cfg.train_micro_batch_size_per_gpu} "
                 f"gas={cfg.gradient_accumulation_steps} "
                 f"global={cfg.train_batch_size} | remat "
                 f"{self.remat_policy}", ranks=[0])
        # last: the engine is whole, so this is a user's load_checkpoint
        # (verified-tag fallback included)
        if cfg.resilience.resume == "auto":
            ckpt.auto_resume(self, cfg.resilience.resume_dir)

    # ------------------------------------------------------------- state
    def _init_master(self, params: Optional[Params]) -> Params:
        """fp32 master on the device: ``model.init`` from a generator seeded
        by ``seed`` (``_init_state``), or a copy of ``params``
        (``_init_state_from``)."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            return self.model.init(gen, device=self.device,
                                   dtype=torch.float32)
        want = param_shapes(self.model.cfg)
        if set(params) != set(want):
            raise ValueError(f"params: missing {sorted(set(want) - set(params))}"
                             f", unexpected {sorted(set(params) - set(want))}")
        return {k: torch.as_tensor(v).to(self.device, torch.float32,
                                         copy=True)
                for k, v in params.items()}

    def fp32_params(self) -> Params:
        """The fp32 master on the host (the JAX engine's ``fp32_params``)."""
        return {k: v.detach().to("cpu", torch.float32, copy=True)
                for k, v in self.master.items()}

    def _cast_compute(self):
        """(params for ``model.loss``, their leaf tensors by name): the
        master in the compute dtype; a stacked ``layers.*`` leaf becomes a
        list of per-layer leaf tensors (views of one cast copy)."""
        params, leaves = {}, {}
        for k, p in self.master.items():
            c = p.detach().to(self.compute_dtype, copy=True)
            if k.startswith(LAYER_PREFIX):
                leaves[k] = [c[i].detach().requires_grad_()
                             for i in range(len(c))]
                params[k] = leaves[k]
            else:
                leaves[k] = [c.requires_grad_()]
                params[k] = c
        return params, leaves

    # -------------------------------------------------------------- step
    def _gas(self, batch: dict, scale: float):
        """Accumulated grads (accumulation dtype, the master's shapes) and
        the loss summed over micro-batches (``_gas_scan``)."""
        gas = int(self.config.gradient_accumulation_steps)
        params, leaves = self._cast_compute()
        acc, loss = {}, None
        for i in range(gas):
            mb = {k: v[i] for k, v in batch.items()}
            scaled = self.model.loss(params, mb,
                                     remat_policy=self.remat_policy) \
                * scale / gas
            scaled.backward()
            part = scaled.detach() / scale
            loss = part if loss is None else loss + part
            for k, ls in leaves.items():
                if k not in acc:
                    acc[k] = torch.empty(self.master[k].shape,
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
        return acc, loss

    def _train_step(self, batch: dict) -> dict:
        cfg = self.config
        scale = self.loss_scale.scale
        grads, loss = self._gas(batch, scale)
        names = sorted(grads)          # the JAX tree's leaf order
        for k in names:
            g = grads[k].float() if grads[k].dtype != torch.float32 \
                else grads[k]
            grads[k] = g.div_(scale)
        finite = bool(grads_finite(grads[k] for k in names)) \
            if cfg.fp16.enabled else True
        gnorm = None
        for k in names:
            s = torch.sum(torch.square(grads[k]))
            gnorm = s if gnorm is None else gnorm + s
        gnorm = torch.sqrt(gnorm)
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
        """A host batch of ``gas × micro`` rows → device tensors shaped
        ``(gas, micro, ...)`` (``(rows, ...)`` without ``gas_dim``)."""
        gas = int(self.config.gradient_accumulation_steps)
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v)).to(self.device)
            if gas_dim:
                t = t.reshape((gas, t.shape[0] // gas) + tuple(t.shape[1:]))
            out[k] = t
        return out

    # ----------------------------------------------------------- public
    def train_batch(self, batch: dict) -> dict:
        """One optimizer step. ``batch`` holds ``train_batch_size`` rows
        (numpy or anything ``np.asarray`` reads), or device tensors already
        shaped ``(gas, micro, ...)``. Returns ``loss`` and ``grad_norm`` as
        0-d device tensors (no synchronisation), ``lr``, ``loss_scale`` and
        ``skipped`` as host numbers."""
        if self._chaos_preempt is not None \
                and self.global_steps == self._chaos_preempt:
            chaos.deliver_preemption()
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
        """The loss of one batch of rows on the current master."""
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = self._make_global(batch, gas_dim=False)
        with torch.no_grad():
            cp = {k: v.to(self.compute_dtype) for k, v in self.master.items()}
            return float(self.model.loss(cp, batch))

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
