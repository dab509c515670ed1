"""One-off measurements of the training path on an H100, outside
``chip_smoke.py``'s phases (whose helpers they reuse):

- ``tp_host_probe()``: where the host time of phase 13's world of one
  goes. GPT-2 1.5B at full width under ``TRAIN_CONFIG`` (stage 1,
  ``dots_saveable``), the engine with no process group against the same
  engine in a world of one over NCCL, whose step takes the tensor-parallel
  branches at tp 1: each one's step time, a profiled step's operators by
  host (self CPU) time, the CUDA runtime's synchronizing calls and the
  caching allocator's counters over the step; then the host time of one
  call of each collective the branches issue (``dist.all_reduce``,
  ``comm.all_reduce``, Megatron's *g* forward and *f* backward, and *g*
  inside a selective checkpoint, forward and recompute) on a tensor of a
  micro-batch's activations.

Run on the card from the repository's root::

    python3 -c "import train_probes as p; p.tp_host_probe()"

It prints ``[tp-host ...]`` lines and one ``[tp-host]`` JSON line.
"""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path

from chip_smoke import TRAIN_CONFIG, _free_memory, _token_batch, log

# the CUDA runtime calls that block the host until the device catches up
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize", "cudaMemcpy", "cudaStreamWaitEvent",
               "cudaEventQuery")
_ALLOC_STATS = ("num_alloc_retries", "num_sync_all_streams",
                "num_device_alloc", "num_device_free")


def _profiled_step(eng, batch, cuda: bool, rows: int = 30) -> dict:
    """One profiled optimizer step: the operators by self CPU time (the
    table's first ``rows``), the synchronizing runtime calls by name
    (count, host µs) and the allocator's counters moved over the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    before = torch.cuda.memory_stats() if cuda else {}
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        sync()
        t0 = time.perf_counter()
        eng.train_batch(dict(batch))
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    after = torch.cuda.memory_stats() if cuda else {}
    avg = prof.key_averages()
    syncs = {e.key: (e.count, e.self_cpu_time_total) for e in avg
             if any(s in e.key for s in _SYNC_CALLS)}
    top = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:rows]
    return {"profiled_wall_ms": wall,
            "self_cpu_ms": sum(e.self_cpu_time_total for e in avg) / 1e3,
            "top": [(e.key, e.count, e.self_cpu_time_total / 1e3,
                     e.cpu_time_total / 1e3) for e in top],
            "syncs": syncs,
            "alloc": {k: after.get(k, 0) - before.get(k, 0)
                      for k in _ALLOC_STATS}}


def _python_profile(eng, batch, cuda: bool, rows: int = 25) -> list:
    """One optimizer step under ``cProfile``: the Python functions by their
    own time (the first ``rows``), as (function, calls, own ms, cumulative
    ms)."""
    import cProfile
    import pstats

    import torch

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pr = cProfile.Profile()
    sync()
    pr.enable()
    eng.train_batch(dict(batch))
    sync()
    pr.disable()
    st = pstats.Stats(pr).stats
    top = sorted(st.items(), key=lambda kv: -kv[1][2])[:rows]
    return [(f"{Path(f).name}:{line}({fn})", n, tt * 1e3, ct * 1e3)
            for (f, line, fn), (_, n, tt, ct, _) in top]


def _timed_steps(eng, batches, cuda: bool) -> list:
    import torch

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = []
    for b in batches:
        sync()
        t0 = time.perf_counter()
        m = eng.train_batch(dict(b))
        float(m["loss"])
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _call_costs(mesh, x, calls: int, cuda: bool) -> dict:
    """Host µs of one call (``calls`` in a row, no sync between) and wall
    µs a call with the device's work included, for each collective the
    tensor-parallel branches issue, on ``x``."""
    import torch
    import torch.distributed as dist
    from torch.utils.checkpoint import checkpoint

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.autograd import copy_to, reduce_from
    from deepspeed_tpu_torch.models.transformer import _checkpointed

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    w = torch.ones((), device=x.device, dtype=x.dtype, requires_grad=True)

    def region(t):
        for _ in range(calls):
            t = reduce_from(t * 1, "model", mesh=mesh)
        return t

    def sac(t):
        return _checkpointed(region, True)(t)

    variants = {
        "dist.all_reduce": lambda: [dist.all_reduce(x, group=mesh.group(
            "model")) for _ in range(calls)],
        "comm.all_reduce": lambda: [comm.all_reduce(x, "model", mesh=mesh)
                                    for _ in range(calls)],
        "clone": lambda: [x.contiguous().clone() for _ in range(calls)],
        "reduce_from fwd": lambda: [reduce_from(x * w, "model", mesh=mesh)
                                    for _ in range(calls)],
        "copy_to fwd+bwd": lambda: copy_to(
            x * w, "model", mesh=mesh).float().sum().backward()
        if calls == 1 else [copy_to(x * w, "model", mesh=mesh).float()
                            .sum().backward() for _ in range(calls)],
        "reduce_from x calls under dots_saveable, fwd+bwd":
            lambda: sac(x * w).float().sum().backward(),
        "reduce_from x calls, plain checkpoint, fwd+bwd":
            lambda: checkpoint(region, x * w, use_reentrant=False)
            .float().sum().backward(),
        "reduce_from x calls, no checkpoint, fwd+bwd":
            lambda: region(x * w).float().sum().backward(),
    }
    out = {}
    for name, fn in variants.items():
        fn()                                              # warm
        sync()
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        sync()
        wall = time.perf_counter() - t0
        out[name] = {"host_us": host / calls * 1e6,
                     "wall_us": wall / calls * 1e6}
        log(f"[tp-host calls] {name}: {out[name]['host_us']:.1f} us of host "
            f"a call, {out[name]['wall_us']:.1f} us with the device's work "
            f"({calls} calls)")
    return out


def tp_host_probe(layers: int = 12, seq: int = 1024, timed: int = 3,
                  calls: int = 100, device=None) -> dict:
    """See the module's docstring. ``device="cpu"`` runs it over ``gloo``
    (a rehearsal at a small shape: pass a smaller ``layers``)."""
    import os

    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.platform.device import nvidia_smi_line
    from deepspeed_tpu_torch.platform.distributed import (_free_port,
                                                          init_distributed)
    from deepspeed_tpu_torch.runtime import random_token_dataset

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    if cuda:
        from deepspeed_tpu_torch.ops import builder

        builder.build_all()
    kw = {} if device is None else {"device": device}
    cfg = gpt2("1.5b", n_layer=layers) if cuda else \
        gpt2("125m", n_layer=layers, n_head=2, d_model=64, vocab_size=512)
    config = TRAIN_CONFIG if cuda else {**TRAIN_CONFIG, "bf16":
                                        {"enabled": False}}
    rows = config["train_micro_batch_size_per_gpu"] * \
        config["gradient_accumulation_steps"]
    seq = seq if cuda else 32
    data = [_token_batch(random_token_dataset(rows, seq, cfg.vocab_size,
                                              seed=70 + i, learnable=True))
            for i in range(2 + timed + 1)]
    _free_memory(dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    init = dt.build_model(cfg).init(gen, device=dev, dtype=torch.float32)
    tag = f"[tp-host {cfg.n_layer}L d{cfg.d_model}]"
    out = {"card": nvidia_smi_line() if cuda else None, "layers": layers,
           "torch": torch.__version__, "cpus": os.cpu_count(),
           "env": {k: v for k, v in os.environ.items()
                   if k.startswith(("TORCH_NCCL", "NCCL", "OMP"))},
           "threads": torch.get_num_threads()}
    log(f"{tag} {out}")

    def engine():
        return dt.initialize(config, dt.build_model(
            cfg, attention_fn=dt.make_flash_attention()), params=init, **kw)

    for name in ("no group", "world of one"):
        if name == "world of one":
            os.environ.pop("WORLD_SIZE", None)
            init_distributed(f"localhost:{_free_port()}", 1, 0, **kw)
        eng = engine()
        for b in data[:2]:
            eng.train_batch(dict(b))
        n0 = dict(comm.issued)
        times = _timed_steps(eng, data[2:2 + timed], cuda)
        issued = {k: (comm.issued[k] - n0[k]) // timed for k in n0
                  if comm.issued[k] - n0[k]}
        prof = _profiled_step(eng, data[-1], cuda)
        prof["python"] = _python_profile(eng, data[-2], cuda)
        out[name] = {"step_ms": statistics.median(times), "step_ms_all": times,
                     "issued": issued, **prof}
        log(f"{tag} {name}: step {out[name]['step_ms']:.1f} ms (all "
            f"{[round(t, 1) for t in times]}), collectives a step {issued}; "
            f"profiled wall {prof['profiled_wall_ms']:.1f} ms, self CPU "
            f"{prof['self_cpu_ms']:.1f} ms; sync calls {prof['syncs']}; "
            f"allocator {prof['alloc']}")
        for key, count, self_ms, total_ms in prof["top"]:
            log(f"{tag} {name}:   {key[:60]:60s} {count:6d} calls, self "
                f"{self_ms:8.2f} ms, total {total_ms:8.2f} ms")
        for key, count, self_ms, total_ms in prof["python"]:
            log(f"{tag} {name}: py {key[:70]:70s} {count:6d} calls, own "
                f"{self_ms:8.2f} ms, cumulative {total_ms:8.2f} ms")
        if name == "world of one":
            x = torch.randn((rows // config["gradient_accumulation_steps"]
                             * seq, cfg.d_model), device=dev).to(
                torch.bfloat16 if cuda else torch.float32)
            out["calls"] = _call_costs(eng.mesh, x, calls, cuda)
        del eng
        _free_memory(dev)
    log("[tp-host] " + json.dumps(out, default=repr))
    return out
