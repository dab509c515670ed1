"""The port's multi-rank runs behind ``tests/test_torch_zero_dist.py``.

``spawn(world, port, out_dir, ckpt_root, jax_state)`` starts one ``gloo``
process per rank (``device="cpu"``, one thread each); every rank runs
every case of its world and writes what it saw to
``<out_dir>/w<world>_rank<r>.pt``.
This module imports neither JAX nor the JAX package: the test process
holds the results against JAX.

Each case starts from the same fp32 weights (``initial_params``: the
port's ``init`` from a seeded generator, which the test hands to the JAX
engine too) and takes its steps on ``global_batches``; rank r trains on
its column block of each ``(gas, micro * world)`` slice, the rows JAX's
batch sharding gives device r.
"""

from __future__ import annotations

import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch

S = 32
VOCAB = 256
STEPS = 4
GAS, MICRO = 2, 2


def model_cfg(kind: str, **over):
    from deepspeed_tpu_torch.models import presets

    if kind == "tiny":
        return presets.tiny_test(max_seq=64, dtype=torch.float32, **over)
    if kind == "mixtral":
        return presets.mixtral("tiny", vocab_size=VOCAB, n_layer=2,
                               max_seq=64, dtype=torch.float32, **over)
    return presets.llama2("tiny", vocab_size=VOCAB, n_layer=2, max_seq=64,
                          dtype=torch.float32, **over)


def initial_params(cfg, seed: int = 7) -> dict:
    """The fp32 weights every side of a case starts from."""
    from deepspeed_tpu_torch.models import build_model

    gen = torch.Generator().manual_seed(seed)
    return build_model(cfg).init(gen, device="cpu", dtype=torch.float32)


def config(world: int, stage: int, **over) -> dict:
    cfg = {"train_batch_size": GAS * MICRO * world,
           "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 3e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"warmup_num_steps": 2,
                                    "total_num_steps": 10}},
           "gradient_clipping": 1.0, "zero_optimization": {"stage": stage},
           "remat": {"enabled": True, "policy": "dots_saveable"},
           "bf16": {"enabled": False}, "steps_per_print": 1000}
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k] = {**cfg[k], **v}
        else:
            cfg[k] = v
    return cfg


def global_batches(world: int, steps: int = STEPS, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, VOCAB, (GAS * MICRO * world, S))
             .astype(np.int32)} for _ in range(steps)]


def eval_batch(world: int) -> dict:
    return global_batches(world, 1, seed=9)[0]


def rank_eval_rows(batch: dict, world: int, rank: int) -> dict:
    """An eval batch (no gas dim): rank ``rank``'s contiguous block."""
    return {k: v.reshape((world, -1) + v.shape[1:])[rank]
            for k, v in batch.items()}


def rank_rows(batch: dict, world: int, rank: int) -> dict:
    """Rank ``rank``'s rows: column block ``rank`` of each gas slice."""
    return {k: v.reshape((GAS, world, MICRO) + v.shape[1:])[:, rank]
            .reshape((GAS * MICRO,) + v.shape[1:]) for k, v in batch.items()}


# world -> case -> (model kind, model overrides, config overrides)
CASES = {
    2: {**{f"tiny_s{s}": ("tiny", {}, {"zero_optimization": {"stage": s}})
           for s in range(4)},
        **{f"llama_s{s}": ("llama", {}, {"zero_optimization": {"stage": s}})
           for s in range(4)},
        "lamb_s2": ("tiny", {}, {"zero_optimization": {"stage": 2},
                                 "optimizer": {"type": "lamb",
                                               "params": {"lr": 3e-3}}}),
        # 2^21 overflows fp16 in the first backward (2^20 does not);
        # hysteresis 1 halves it at once
        "fp16_s2": ("tiny", {}, {"zero_optimization": {"stage": 2},
                                 "fp16": {"enabled": True,
                                          "initial_scale_power": 21,
                                          "hysteresis": 1}}),
        # stage 2 with buckets of 5000 elements: several a step
        "bucket_s2": ("tiny", {}, {"zero_optimization": {
            "stage": 2, "reduce_bucket_size": 5000}}),
        # MoE: the router and the 4-D expert banks in stage 2's buckets and
        # gathered on use at stage 3; the moe section drops tokens in
        # training, not at eval. Adam's eps at
        # 1e-6: at 1e-8 its first step turns an element's rounding-level
        # grad into a +-lr step (m / sqrt(v) is its sign), and one such
        # element of a token row stood at 6e-5 of the table's norm after 4
        # steps, on the port alone as on one JAX device, while every
        # step's grads agreed to 3e-6
        **{f"moe_s{s}": ("mixtral", {}, {
            "zero_optimization": {"stage": s, "reduce_bucket_size": 50_000},
            "optimizer": {"type": "adamw", "params": {
                "lr": 3e-3, "weight_decay": 0.01, "eps": 1e-6}},
            "moe": {"enabled": True, "num_experts": 4, "capacity_factor": 1.0,
                    "min_capacity": 1}}) for s in (2, 3)}},
    4: {"tiny_s3": ("tiny", {}, {"zero_optimization": {"stage": 3}}),
        "hpz_s3": ("tiny", {}, {"zero_optimization": {
            "stage": 3, "zero_hpz_partition_size": 2,
            "param_persistence_threshold": 0}}),
        "mics_s3": ("tiny", {}, {"zero_optimization": {
            "stage": 3, "mics_shard_size": 2,
            "param_persistence_threshold": 0}}),
        "qwz_s3": ("tiny", {}, {"zero_optimization": {
            "stage": 3, "zero_hpz_partition_size": 2,
            "zero_quantized_weights": True}})},
}
# stage 3's gather budget: 6 layers, every leaf cut, with and without remat
BUDGET = {"remat": {"enabled": True, "policy": "dots_saveable"},
          "no_remat": {"enabled": False}}


def _engine(cfg, conf, params=None):
    import deepspeed_tpu_torch as dt

    return dt.initialize(conf, dt.build_model(
        cfg, attention_fn=dt.make_flash_attention()),
        params=initial_params(cfg) if params is None else params,
        device="cpu")


def full_state(engine) -> dict:
    """Every master / mu / nu leaf whole (a collective), as numpy."""
    from deepspeed_tpu_torch.comm import comm

    out = {}
    for g, d in (("master", engine.master), ("mu", engine.opt_state.mu),
                 ("nu", engine.opt_state.nu)):
        out[g] = {}
        for k, t in d.items():
            cut = engine.plans[k].master
            if cut is not None and t.numel():
                t = comm.all_gather(t, cut.axes, cut.dim, mesh=engine.mesh)
            out[g][k] = t.detach().numpy().copy()
    return out


def _steps(engine, world, rank, steps=STEPS):
    out = []
    for b in global_batches(world, steps):
        m = engine.train_batch(rank_rows(b, world, rank))
        out.append({"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]), "lr": m["lr"],
                    "loss_scale": m["loss_scale"], "skipped": m["skipped"]})
    return out


def _qwz_payload(engine) -> dict:
    """Each qwZ leaf's int8 payload and scales as the engine quantizes its
    master shard for the gather, gathered whole."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.zero.shards import quantize_rows

    out = {}
    for k, plan in engine.plans.items():
        if not plan.qwz:
            continue
        cut, t = plan.master, engine.master[k]
        q, s = quantize_rows(t, cut.dim, cut.axes, engine.mesh)
        q = comm.all_gather(q, cut.axes, cut.dim, mesh=engine.mesh)
        if cut.dim != t.dim() - 1:
            s = comm.all_gather(s, cut.axes, cut.dim, mesh=engine.mesh)
        out[k] = (q.numpy().copy(), s.numpy().copy())
    return out


def run_case(world, rank, kind, model_over, conf_over) -> dict:
    cfg = model_cfg(kind, **model_over)
    eng = _engine(cfg, config(world, 0, **conf_over))
    res = {"steps": _steps(eng, world, rank),
           "eval": eng.eval_batch(rank_eval_rows(eval_batch(world), world,
                                                 rank)),
           "shards": {k: v.detach().numpy().copy()
                      for k, v in eng.master.items()},
           "full": full_state(eng),
           "peak_layers": eng.gather_peak_layers}
    if any(p.qwz for p in eng.plans.values()):
        res["qwz"] = _qwz_payload(eng)
    return res


def budget_cases(world, rank) -> dict:
    cfg = model_cfg("tiny", n_layer=6)
    out = {}
    for name, remat in BUDGET.items():
        for stage in (0, 3):
            eng = _engine(cfg, config(world, stage, remat=remat,
                                      zero_optimization={
                                          "param_persistence_threshold": 0}))
            out[f"{name}_s{stage}"] = {"steps": _steps(eng, world, rank, 2),
                                       "peak_layers": eng.gather_peak_layers}
    return out


def checkpoint_cases(world, rank, root: Path) -> dict:
    """World 2: save under stage 3 (sync), an async save raced by a step,
    ``resume: "auto"``, a tag that differs across ranks. World 4: load
    world 2's stage-3 tag under stage 1."""
    from deepspeed_tpu_torch.resilience import verify_tag

    cfg = model_cfg("tiny")
    out = {}
    if world == 4:
        eng = _engine(cfg, config(world, 1))
        eng.load_checkpoint(str(root / "s3"))
        out["loaded_s1"] = full_state(eng)
        out["loaded_steps"] = eng.global_steps
        return out
    eng = _engine(cfg, config(world, 3))
    _steps(eng, world, rank, 2)
    eng.save_checkpoint(str(root / "s3"))
    out["saved_s3"] = full_state(eng)
    # async: the state at the save, a step while the writer runs, commit
    conf = config(world, 2, checkpoint={"async_save": True})
    a = _engine(cfg, conf)
    _steps(a, world, rank, 1)
    held = full_state(a)
    a.save_checkpoint(str(root / "async"))
    _steps(a, world, rank, 1)
    a.wait_for_checkpoint()
    b = _engine(cfg, config(world, 2))
    b.load_checkpoint(str(root / "async"))
    out["async"] = {"held": held, "loaded": full_state(b),
                    "verified": verify_tag(root / "async" / "global_step1",
                                           "size")[0]}
    # resume: "auto" from the async run's directory
    r = _engine(cfg, config(world, 2, resilience={
        "resume": "auto", "resume_dir": str(root / "async")}))
    out["auto"] = {"global_steps": r.global_steps, "state": full_state(r)}
    # the PreemptionGuard: rank 0 alone takes SIGTERM while an async save
    # is in flight; at the next step both ranks agree and commit it
    import signal

    import deepspeed_tpu_torch as dt

    p = _engine(cfg, config(world, 1, checkpoint={"async_save": True}))
    guard = dt.PreemptionGuard(p, exit_on_signal=False).install()
    _steps(p, world, rank, 1)
    p.save_checkpoint(str(root / "preempt"))
    if rank == 0:
        os.kill(os.getpid(), signal.SIGTERM)
    _steps(p, world, rank, 1)
    guard.uninstall()
    out["preempt"] = {"preempted": guard.preempted,
                      "committed": guard.committed}
    # a tag that differs across ranks: every rank raises, none hangs
    f = _engine(cfg, config(world, 1, checkpoint={"tag_validation": "fail"}))
    try:
        f.save_checkpoint(str(root / "bad"), tag=f"tag{rank}")
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


def _run(rank, world, port, out_dir, ckpt_root, jax_state):
    torch.set_num_threads(1)
    os.environ.setdefault("DSTPU_LOG_LEVEL", "WARNING")
    import torch.distributed as dist

    from deepspeed_tpu_torch.platform.distributed import init_distributed

    res = {}
    t0 = time.perf_counter()
    try:
        init_distributed(f"localhost:{port}", world, rank, device="cpu")
        for name, (kind, mo, co) in CASES[world].items():
            res[name] = run_case(world, rank, kind, mo, co)
        if world == 2:
            res["budget"] = budget_cases(world, rank)
        if jax_state is not None:
            # a JAX TrainState (numpy leaves) carried into stage 3
            from deepspeed_tpu_torch.models import train_state_from_jax

            eng = _engine(model_cfg("tiny"), config(world, 3))
            train_state_from_jax(jax_state, eng)
            res["from_jax"] = full_state(eng)
        res["ckpt"] = checkpoint_cases(world, rank, Path(ckpt_root))
        res["seconds"] = time.perf_counter() - t0
    except BaseException:
        res = {"error": traceback.format_exc()}
    torch.save(res, Path(out_dir) / f"w{world}_rank{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(world: int, port: int, out_dir, ckpt_root, jax_state=None):
    """Start the ranks; returns the processes (see :func:`join`)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_run, args=(r, world, port, str(out_dir),
                                            str(ckpt_root), jax_state),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join(procs, timeout: float) -> None:
    """Wait for every rank; if one dies or the time runs out, stop them
    all (a dead rank leaves the others waiting in a collective)."""
    end = time.monotonic() + timeout
    while any(p.is_alive() for p in procs):
        if time.monotonic() > end or any(
                p.exitcode not in (None, 0) for p in procs):
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    for p in procs:
        p.join(5)
