"""The port's tensor- and expert-parallel training ranks behind
``tests/test_torch_tp_train_dist.py``.

``spawn(world, port, out_dir)`` starts one ``gloo`` process per rank
(``device="cpu"``, one thread each); every rank runs every case of its
world through ``initialize(config, model)`` with ``mesh.model`` /
``mesh.expert`` and writes what it saw (each step's loss and grad norm,
the gathered fp32 master, its expert-bank shards at init, the collectives
of one step) to ``<out_dir>/w<world>_rank<r>.pt``. This module imports
neither JAX nor the JAX package: the test process holds the results
against JAX.

Every case starts from the fp32 weights the port draws from a seeded
generator (``initial_params``), which the test hands to the JAX engine
too, and trains on ``global_batches``: the rank at batch index i (over
``data``, ``zero`` and ``expert``) takes column block i of each ``(gas,
micro * dp)`` slice, the rows JAX's batch sharding gives its devices; the
ranks of one ``model`` line take the same rows.
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
STEPS = 3
GAS, MICRO = 2, 2
MOE = {"enabled": True, "num_experts": 4, "capacity_factor": 1.0,
       "min_capacity": 1}
# Adam's eps at 1e-6, as the MoE ZeRO cases: at 1e-8 its first step turns
# an element's rounding-level grad into a +-lr step
ADAM = {"type": "adamw", "params": {"lr": 3e-3, "weight_decay": 0.01,
                                    "eps": 1e-6}}

# name -> (preset, overrides)
MODELS = {
    "tiny": ("tiny_test", {}),
    "tiny_fused": ("tiny_test", {"fused_xent": True}),
    "tiny_fused_bias": ("tiny_test", {"fused_xent": True,
                                      "lm_head_bias": True}),
    # 257 rows split over no tp: the table and the head stay whole and the
    # fused head declines, as JAX's does
    "odd_vocab": ("tiny_test", {"vocab_size": 257, "fused_xent": True}),
    # tp 4 above n_kv_head 2: each KV head on the two ranks that read it
    "llama_gqa": ("llama2", {"n_kv_head": 2}),
    "mixtral": ("mixtral", {"num_experts": 4}),
}

# world -> case -> (model, mesh, zero stage, config overrides)
CASES = {
    2: {"dense_m2_s0": ("tiny", {"model": 2}, 0, {}),
        "remat_m2_s0": ("tiny", {"model": 2}, 0,
                        {"remat": {"enabled": True,
                                   "policy": "save_names"}}),
        "fused_m2_s1": ("tiny_fused_bias", {"model": 2}, 1, {}),
        "odd_m2_s2": ("odd_vocab", {"model": 2}, 2, {}),
        "moe_e2_s1": ("mixtral", {"expert": 2}, 1, {"moe": MOE})},
    4: {"dense_m4_s3": ("tiny", {"model": 4}, 3,
                        {"zero_optimization": {
                            "param_persistence_threshold": 0}}),
        "dp_d2m2_s2": ("tiny", {"data": 2, "model": 2}, 2, {}),
        "fused_m4_s1": ("tiny_fused", {"model": 4}, 1, {}),
        "gqa_m4_s1": ("llama_gqa", {"model": 4}, 1, {}),
        "moe_e2m2_s1": ("mixtral", {"expert": 2, "model": 2}, 1,
                        {"moe": MOE})},
}
# the case whose one step's collectives are counted, a world
COUNTED = {2: "fused_m2_s1", 4: "moe_e2m2_s1"}
# world -> (inference model, tensor_parallel) of the sharded forward()
FORWARD = {2: ("tiny_fused_bias", 2)}
# fused_token_nll_tp alone: T tokens, width d, vocabulary V (V % 4 == 0);
# 40 rows a rank of 4 is no multiple of the JAX kernel's 32-row block, so a
# foreign target can land in a shard's padded rows
# (``tests/unit/test_xent.py:247``)
XENT = dict(T=24, d=32, V=160)


def model_cfg(name: str):
    from deepspeed_tpu_torch.models import presets

    fn, over = MODELS[name]
    if fn == "tiny_test":
        return presets.tiny_test(max_seq=64, dtype=torch.float32, **over)
    return getattr(presets, fn)("tiny", vocab_size=VOCAB, n_layer=2,
                                max_seq=64, dtype=torch.float32, **over)


def initial_params(name: str, seed: int = 7) -> dict:
    """The fp32 weights every side of a case starts from."""
    from deepspeed_tpu_torch.models import build_model

    gen = torch.Generator().manual_seed(seed)
    return build_model(model_cfg(name)).init(gen, device="cpu",
                                              dtype=torch.float32)


def dp_size(mesh: dict) -> int:
    return mesh.get("data", 1) * mesh.get("expert", 1)


def config(mesh: dict, stage: int, **over) -> dict:
    dp = dp_size(mesh)
    cfg = {"train_batch_size": GAS * MICRO * dp,
           "train_micro_batch_size_per_gpu": MICRO,
           "gradient_accumulation_steps": GAS, "optimizer": ADAM,
           "scheduler": {"type": "WarmupDecayLR",
                         "params": {"warmup_num_steps": 2,
                                    "total_num_steps": 10}},
           "gradient_clipping": 1.0, "zero_optimization": {"stage": stage},
           "bf16": {"enabled": False}, "steps_per_print": 1000,
           "mesh": dict(mesh)}
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            cfg[k] = {**cfg[k], **v}
        else:
            cfg[k] = v
    return cfg


def global_batches(dp: int, steps: int = STEPS, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, VOCAB, (GAS * MICRO * dp, S))
             .astype(np.int32)} for _ in range(steps)]


def rank_rows(batch: dict, dp: int, i: int) -> dict:
    """Batch index ``i``'s rows: column block ``i`` of each gas slice."""
    return {k: v.reshape((GAS, dp, MICRO) + v.shape[1:])[:, i]
            .reshape((GAS * MICRO,) + v.shape[1:]) for k, v in batch.items()}


def eval_ids(vocab: int = VOCAB) -> np.ndarray:
    return np.random.default_rng(9).integers(0, vocab, (4, S)) \
        .astype(np.int32)


def xent_inputs(bias: bool) -> tuple:
    """(x, w, bias, targets) of the ``fused_token_nll_tp`` case, fp32;
    some targets outside the vocabulary (they match no row)."""
    rng = np.random.default_rng(3)
    T, d, V = XENT["T"], XENT["d"], XENT["V"]
    x = rng.normal(0, 2, (T, d)).astype(np.float32)
    w = rng.normal(0, 0.5, (V, d)).astype(np.float32)
    b = rng.normal(0, 1, (V,)).astype(np.float32) if bias else None
    t = rng.integers(0, V, (T,)).astype(np.int32)
    t[:2] = (V, V + 7)
    return x, w, b, t


def _engine(name, mesh, stage, over):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import build_model

    return dt.initialize(config(mesh, stage, **over),
                         build_model(model_cfg(name)),
                         params=initial_params(name), device="cpu")


def _steps(eng, batches) -> list:
    i = eng.mesh.index(("data", "zero", "expert"))
    out = []
    for b in batches:
        m = eng.train_batch(rank_rows(b, eng.dp_world, i))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _aux(eng) -> float:
    """The MoE aux loss of the trained weights on this rank's eval rows,
    averaged over the batch axes."""
    from deepspeed_tpu_torch.comm import comm

    whole = eng.fp32_params()
    params = {k: eng.local_of(k, v) for k, v in whole.items()}
    ids = eval_ids()
    i, n = eng.mesh.index(("data", "zero", "expert")), eng.dp_world
    rows = torch.as_tensor(ids.reshape((n, -1, S))[i]).long()
    with torch.no_grad():
        _, aux = eng.model.apply(params, rows, return_aux=True)
    return float(comm.all_reduce(aux.float().reshape(1), ("data", "zero",
                                                          "expert"),
                                 "mean", mesh=eng.mesh)[0])


def train_case(world, case, counted: bool) -> dict:
    import chip_smoke
    from deepspeed_tpu_torch.comm import comm

    name, mesh, stage, over = CASES[world][case]
    eng = _engine(name, mesh, stage, over)
    out = {"init_banks": {k: eng.master[k].numpy().copy()
                          for k in eng.master
                          if "expert" in eng.tp_axes[k].values()},
           "fused": eng.model._fused_xent_active(False, torch.float32)}
    batches = global_batches(dp_size(mesh))
    if counted:
        out["steps"] = _steps(eng, batches[:1])
        before = dict(comm.issued)
        out["steps"] += _steps(eng, batches[1:2])
        out["issued"] = {k: v - before[k] for k, v in comm.issued.items()
                         if v != before[k]}
        out["reckoned"] = chip_smoke.tp_train_collectives(eng)
        out["steps"] += _steps(eng, batches[2:])
    else:
        out["steps"] = _steps(eng, batches)
    out["master"] = {k: v.numpy() for k, v in eng.fp32_params().items()}
    if eng.model.cfg.num_experts > 1:
        out["aux"] = _aux(eng)
    return out


def resume_case(out_dir: Path) -> dict:
    """dense_m2_s0 at stage 1: two steps, a save, a fresh engine that
    loads and takes two more, against four steps with no break."""
    from deepspeed_tpu_torch.comm import comm

    mesh, over = {"model": 2}, {}
    batches = global_batches(1, 4, seed=4)
    whole = _engine("tiny", mesh, 1, over)
    straight = _steps(whole, batches)
    want = {k: v.numpy() for k, v in whole.fp32_params().items()}
    first = _engine("tiny", mesh, 1, over)
    _steps(first, batches[:2])
    root = out_dir / "resume_ckpt"
    first.save_checkpoint(str(root))
    comm.barrier(("model",), mesh=first.mesh)
    files = sorted(p.name for p in (root / "global_step2" / "state")
                   .iterdir())
    again = _engine("tiny", mesh, 1, over)
    again.load_checkpoint(str(root))
    resumed = _steps(again, batches[2:])
    got = {k: v.numpy() for k, v in again.fp32_params().items()}
    return {"straight": straight[2:], "resumed": resumed, "want": want,
            "got": got, "files": files, "step": again.global_steps}


def forward_case(world) -> dict:
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import build_model

    name, tp = FORWARD[world]
    eng = dt.init_inference(build_model(model_cfg(name)),
                            initial_params(name),
                            {"dtype": "float32", "tensor_parallel": tp},
                            device="cpu")
    return {"logits": eng.forward(eval_ids()).numpy()}


def xent_case(world, rank) -> dict:
    """``fused_token_nll_tp`` alone over a ``model`` line of ``world``, and
    its plain spelling (autograd through the rank's logits and Megatron's
    collectives): the NLL and the grads of the summed NLL in x and in the
    rank's rows of the table and the bias."""
    from deepspeed_tpu_torch.ops.xent import (fused_token_nll_tp,
                                              fused_token_nll_tp_plain)
    from deepspeed_tpu_torch.platform.mesh import MeshSpec, build_mesh

    mesh = build_mesh(MeshSpec(data=1, model=world))
    out = {}
    for bias in (False, True):
        x, w, b, t = xent_inputs(bias)
        rows = w.shape[0] // world
        v0 = rank * rows
        for key, fn in ((bias, fused_token_nll_tp),
                        (("plain", bias), fused_token_nll_tp_plain)):
            xt = torch.tensor(x, requires_grad=True)
            wt = torch.tensor(w[v0:v0 + rows], requires_grad=True)
            bt = None if b is None else torch.tensor(b[v0:v0 + rows],
                                                      requires_grad=True)
            nll = fn(xt, wt, bt, torch.as_tensor(t), v0=v0, mesh=mesh)
            nll.sum().backward()
            out[key] = {"nll": nll.detach().numpy(), "dx": xt.grad.numpy(),
                        "dw": wt.grad.numpy(),
                        "db": None if bt is None else bt.grad.numpy()}
    return out


def _run(rank, world, port, out_dir):
    torch.set_num_threads(1)
    os.environ.setdefault("DSTPU_LOG_LEVEL", "WARNING")
    import torch.distributed as dist

    from deepspeed_tpu_torch.platform.distributed import init_distributed

    out_dir = Path(out_dir)
    res = {}
    t0 = time.perf_counter()
    try:
        init_distributed(f"localhost:{port}", world, rank, device="cpu")
        res["train"] = {c: train_case(world, c, c == COUNTED[world])
                        for c in CASES[world]}
        if world == 2:
            res["resume"] = resume_case(out_dir)
            res["forward"] = forward_case(world)
        else:
            res["xent"] = xent_case(world, rank)
        res["seconds"] = time.perf_counter() - t0
        print(f"tp train worker w{world} r{rank}: {res['seconds']:.1f} s",
              flush=True)
    except BaseException:
        res = {"error": traceback.format_exc()}
    torch.save(res, out_dir / f"w{world}_rank{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(world: int, port: int, out_dir):
    """Start the ranks; returns the processes (see :func:`join`)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_run, args=(r, world, port, str(out_dir)),
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
