#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit; build every CUDA kernel of
   ``deepspeed_tpu_torch/ops/csrc`` (nvcc, sm_90a) and print nvcc's
   register / shared-memory lines;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and the edge cases, within stated tolerances;
   then timed (CUDA events, L2-cold inputs) beside the plain version, the
   PyTorch library call that computes the same function, and the bound;
3. slice: ``init_inference(...).generate`` on Llama-2-7B at full width in
   bf16 with seeded random weights (4 prompts x 512 tokens, 128 new
   tokens, greedy), with the kernel's launch count read around that one
   call; the kernel path's logits teacher-forced against the dense
   attention path; a sampled call repeated with the same request seeds.

The line before the last is the kernels' JSON, the last line the device
JSON. Without a CUDA device, or outside the repository, it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import math
import sys
import time
from functools import partial
from pathlib import Path

PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float16": 989e12,
                  "torch.float32": 67e12}
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2, "torch.float16": 2e-2}
# kernel path vs dense path fp32 logits, teacher-forced, as a share of the
# dense logits' max |value|: the dense path rounds scores and probabilities
# to bf16, the kernel does not (CPU rehearsal, 4-8 layers at d 1024: 1.1-1.6%)
LOGIT_TOL_SHARE = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    import torch

    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 1
def phase_device() -> dict:
    import torch

    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.platform.device import device_report

    rep = device_report()
    smi = rep["nvidia_smi"]
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"card {rep['name']} count {rep['count']}")
    t0 = time.perf_counter()
    built = builder.build_all()
    log(f"[build] {len(built)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, info in built.items():
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill")):
                log(f"[build]   {line.strip()}")
    return {"nvidia_smi": smi}


# ------------------------------------------------------------------ phase 2
def _case(gen, *, B=4, H=32, KV=32, hd=128, S=640, dtype=None,
          lengths=(600, 589, 611, 597), alibi=False, device="cuda"):
    import torch

    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    dtype = dtype or torch.bfloat16
    mk = partial(torch.randn, generator=gen, device=device)
    q = mk((B, 1, H, hd)).to(dtype)
    ck = mk((B, KV, S, hd)).to(dtype)
    cv = mk((B, KV, S, hd)).to(dtype)
    length = (torch.tensor(lengths, dtype=torch.int32, device=device)
              if isinstance(lengths, (tuple, list)) else lengths)
    slopes = alibi_slopes(H, device) if alibi else None
    return q, ck, cv, length, slopes


def phase_kernels(device="cuda", main_shape=None, iters=200) -> dict:
    """Kernel vs plain on every case; timings at the main path's shape."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=device).manual_seed(0)
    main = dict(main_shape or {})
    S = main.get("S", 640)
    cases = {
        "main": {},
        "gqa": dict(KV=8),
        "mqa": dict(KV=1),
        "hd64": dict(hd=64),
        "rows_1_max_0": dict(lengths=(1, S, S // 2 + 1, 0)),
        "scalar_len": dict(lengths=S - 40),
        "alibi_gqa": dict(KV=8, alibi=True),
        "fp32": dict(dtype=torch.float32),
        "fp16": dict(dtype=torch.float16, KV=4),
    }
    errs = {}
    for name, over in cases.items():
        q, ck, cv, length, slopes = _case(gen, device=device,
                                          **{**main, **over})
        got = da.decode_attention(q, ck, cv, length, alibi_slopes=slopes)
        want = da.decode_attention_plain(q, ck, cv, length,
                                         alibi_slopes=slopes)
        if device == "cuda":
            torch.cuda.synchronize()
        err =(got.float() - want.float()).abs().max().item()
        tol = TOL[str(q.dtype)]
        ok = math.isfinite(err) and err <= tol
        log(f"[kernel] decode_attention {name:13s} {str(q.dtype):15s} "
            f"max_abs_err {err:.3e} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention {name}: max abs err "
                                 f"{err} > {tol}")
        errs[name] = err
    result = {"max_abs_err": errs["main"]}
    if device != "cuda":
        return result

    # timings at the main path's shape; 4 input sets in rotation (>150 MB)
    # so every launch finds its K/V outside the 50 MB L2, as a decode step
    # does after the other layers' weights went through
    sets = [_case(gen, **main) for _ in range(4)]
    q, ck, cv, length, _ = sets[0]
    B, _, H, hd = q.shape
    KV = ck.shape[1]
    L = length.to(torch.int64)
    masks = [(torch.arange(ck.shape[2], device=device)[None, :]
              < s[3][:, None])[:, None, None, :] for s in sets]
    kernel_ms = time_ms(lambda i: da.decode_attention(*sets[i % 4][:4]),
                        iters)
    plain_ms = time_ms(lambda i: da.decode_attention_plain(*sets[i % 4][:4]),
                       max(iters // 10, 5))
    sdpa_ms = time_ms(lambda i: F.scaled_dot_product_attention(
        sets[i % 4][0].transpose(1, 2), sets[i % 4][1], sets[i % 4][2],
        attn_mask=masks[i % 4], enable_gqa=KV != H), iters)
    esize = q.element_size()
    live = int(L.sum())
    nbytes = live * KV * hd * esize * 2 + 2 * q.numel() * esize + 4 * B
    ops = live * H * hd * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(q.dtype)] * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[kernel] decode_attention B{B} H{H} KV{KV} hd{hd} S{ck.shape[2]} "
        f"lengths {L.tolist()} {q.dtype}: kernel {kernel_ms * 1e3:.2f} us, "
        f"plain {plain_ms * 1e3:.2f} us, sdpa {sdpa_ms * 1e3:.2f} us, "
        f"bound {bound_ms * 1e3:.2f} us ({bound_by}: {nbytes} B, {ops} "
        f"flop), kernel at {bound_ms / kernel_ms:.1%} of the bound")
    result.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                  bound_ms=bound_ms, bound_by=bound_by)
    return result


# ------------------------------------------------------------------ phase 3
def phase_slice(cfg=None, *, batch=4, prompt=512, max_new=128, device=None,
                check_steps=8) -> dict:
    """The port's main path, ``init_inference(...).generate``, once, with
    the kernel counts zeroed just before and read just after."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.decode import (KVCache, decode_tokens,
                                                      forward_with_cache,
                                                      prefill_tokens)
    from deepspeed_tpu_torch.inference.sampling import sample_logits
    from deepspeed_tpu_torch.models import build_model, llama2
    from deepspeed_tpu_torch.ops import decode_attention as da

    cfg = cfg or llama2("7b")
    dev = torch.device(device or "cuda")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(1234)
    t0 = time.perf_counter()
    kw = {} if device is None else {"device": device}
    engine = dt.init_inference(
        model, model.init(gen, device=dev, dtype=cfg.dtype),
        {"dtype": str(cfg.dtype).removeprefix("torch.")}, **kw)
    sync()
    log(f"[slice] {cfg.n_layer} layers d_model {cfg.d_model} heads "
        f"{cfg.n_head}/{cfg.kv_heads} d_ff {cfg.ffn_dim} vocab "
        f"{cfg.vocab_size}: {cfg.param_count() / 1e9:.3f} B params "
        f"{cfg.dtype} on {engine.device}, init {time.perf_counter() - t0:.1f} s,"
        f" flash_decode {engine.flash_decode}")
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                        device=dev)
    engine.generate(ids[:, :32], 4, greedy=True)           # warm-up
    sync()

    # ---- the main path, counted ----
    da.decode_attention.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = engine.generate(ids, max_new, greedy=True)
    sync()
    wall = time.perf_counter() - t0
    launches = da.decode_attention.launches
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    want = cfg.n_layer * (max_new - 1) if engine.flash_decode else 0
    log(f"[slice] generate {batch}x{prompt} -> {tuple(out.shape)} in "
        f"{wall:.3f} s; decode_attention launches {launches} (want "
        f"{cfg.n_layer} x {max_new - 1} = {want}); peak memory "
        f"{peak / 2**30:.2f} GiB")
    if launches != want:
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"want {want}")
    if out.shape != (batch, max_new) or out.dtype != torch.long \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad generate output {out.shape} {out.dtype}")

    # ---- TTFT and decode rate, the two halves timed apart ----
    greedy = partial(sample_logits, greedy=True)
    step_kw = dict(sampler=greedy, flash_decode=engine.flash_decode)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        carry = prefill_tokens(engine.model, engine.params, ids, None,
                               max_new=max_new, cache_dtype=cfg.dtype,
                               **step_kw)
        sync()
        ttft = time.perf_counter() - t0
        base = KVCache(carry.cache.k.clone(), carry.cache.v.clone(),
                       carry.cache.length)
        t0 = time.perf_counter()
        again = decode_tokens(engine.model, engine.params, carry,
                              steps=max_new - 1, **step_kw)
        sync()
        dec = time.perf_counter() - t0
    same = bool((again == out).all())
    log(f"[slice] TTFT {ttft * 1e3:.1f} ms (prefill {batch}x{prompt}); decode "
        f"{max_new - 1} steps {dec:.3f} s = {dec / (max_new - 1) * 1e3:.2f} "
        f"ms/step, {batch * (max_new - 1) / dec:.1f} tok/s; rerun tokens "
        f"identical {same}")
    if dev.type == "cuda":
        profile_decode(engine, KVCache(base.k.clone(), base.v.clone(),
                                       base.length), out, step_kw)

    # ---- kernel path vs dense attention, teacher-forced ----
    worst = 0.0
    agree = []
    with torch.inference_mode():
        ca = base
        cb = KVCache(base.k.clone(), base.v.clone(), base.length)
        for i in range(check_steps):
            tok = out[:, i:i + 1]
            la, ca = forward_with_cache(engine.model, engine.params, tok, ca,
                                        flash_decode=engine.flash_decode)
            lb, cb = forward_with_cache(engine.model, engine.params, tok, cb,
                                        flash_decode=False)
            if not (torch.isfinite(la).all() and torch.isfinite(lb).all()):
                raise AssertionError(f"non-finite logits at decode step {i}")
            share = ((la - lb).abs().max() / lb.abs().max()).item()
            worst = max(worst, share)
            agree.append((la.argmax(-1) == lb.argmax(-1)).float().mean().item())
    log(f"[slice] kernel vs dense logits over {check_steps} teacher-forced "
        f"steps: max |diff| / max |logit| {worst:.4f} (tol "
        f"{LOGIT_TOL_SHARE}); greedy agreement {sum(agree) / len(agree):.3f}"
        f" (near-ties of random weights, not gated)")
    if worst > LOGIT_TOL_SHARE:
        raise AssertionError(f"kernel vs dense logits differ by {worst:.4f} "
                             f"of max |logit| > {LOGIT_TOL_SHARE}")

    # ---- sampled: the same request seeds give the same tokens ----
    seeds = list(range(11, 11 + batch))
    s1, s2 = (engine.generate(ids, 32, temperature=0.8, top_p=0.9,
                              request_seeds=seeds) for _ in range(2))
    if not bool((s1 == s2).all()):
        raise AssertionError("sampled tokens differ between two calls with "
                             "the same request seeds")
    log(f"[slice] sampled (temperature 0.8, top_p 0.9, seeds {seeds}) twice: "
        f"identical")
    return {"launches": launches, "ttft_ms": ttft * 1e3,
            "decode_tok_s": batch * (max_new - 1) / dec,
            "step_ms": dec / (max_new - 1) * 1e3, "peak_bytes": peak,
            "generate_s": wall}


def profile_decode(engine, cache, out, step_kw, steps: int = 4) -> None:
    """Where a decode step's time goes: torch.profiler over ``steps``
    steps; the device's busy share of the window (the sum of the device
    events' durations, one stream, over the host wall time) and the top
    kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.inference.decode import GenCarry, decode_tokens

    carry = GenCarry(out[:, 0], cache, None,
                     torch.zeros_like(out[:, 0], dtype=torch.bool))
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_tokens(engine.model, engine.params, carry, steps=steps,
                      **step_kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        log("[profile] the profiler saw no device time: busy share not "
            "measured")
        return
    log(f"[profile] {steps} decode steps: wall {wall_us / steps / 1e3:.2f} "
        f"ms/step, device busy {busy / steps / 1e3:.2f} ms/step = "
        f"{busy / wall_us:.1%} of the wall (idle {1 - busy / wall_us:.1%})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / steps:9.1f} us/step {us / busy:6.1%}  "
            f"{name[:100]}")


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has nothing to do without one", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the deepspeed_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 1
    dev = phase_device()
    kern = phase_kernels()
    sl = phase_slice()
    kernels = [{
        "name": "decode_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/decode_attention.py:41",
        "launches": sl["launches"], "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
