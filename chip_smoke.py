#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit; build every CUDA kernel of
   ``deepspeed_tpu_torch/ops/csrc`` (nvcc, sm_90a, one process per source,
   all at once) and print nvcc's register / shared-memory lines;
2. kernels: each kernel (decode attention, the WOQ GEMMs ``woq_matmul``
   and ``woq_matmul_t``) against its plain PyTorch version on the card, at
   the main paths' shapes and the edge cases, within stated tolerances;
   then timed on L2-cold inputs (device time: calls captured in a CUDA
   graph, replays timed with CUDA events) beside the plain version (eager
   calls), the PyTorch library call that computes the same function
   (device time) and the bound;
3. slice: ``init_inference(...).generate`` on Llama-2-7B at full width in
   bf16 with seeded random weights (4 prompts x 512 tokens, 128 new
   tokens, greedy), with the kernel's launch count read around that one
   call; the kernel path's logits teacher-forced against the dense
   attention path; a sampled call repeated with the same request seeds;
4. WOQ slice: the same traffic through ``init_inference(..., {"quantize":
   True})`` on Llama-2-7B in int8 (untied head: ``woq_matmul``) and on
   OPT-6.7B in int4 (tied head: ``woq_matmul_t``), both at full width and
   depth, group 128, with every kernel's launch count read around one
   ``generate``; the kernel path's logits teacher-forced against the
   per-use dequantization path on the same quantized weights (gated) and
   against the bf16 engine (logged).

The last three lines of standard output are the kernels' JSON, then
``nvidia-smi``'s name and power limit of the card, then the device JSON.
Without a CUDA device, or outside the repository, it exits 1 and prints
no result.
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
# WOQ kernels vs their plain versions, max |diff| as a share of the plain
# output's max |value|, by output dtype: fp32 outputs differ only in the
# order of the fp32 sums; bf16/fp16 outputs add one rounding of the output
# on each side (at most an ulp apart: 2^-8 / 2^-11 of an element)
WOQ_TOL_SHARE = {"torch.float32": 1e-5, "torch.bfloat16": 2.0 ** -7,
                 "torch.float16": 2.0 ** -9}
# WOQ kernel path vs per-use dequant path, fp32 logits over 8 teacher-forced
# steps, as a share of max |logit|: the per-use path rounds every dequantized
# weight to bf16 before its product, the kernels of x @ W scale the fp32
# partial sums instead. CPU rehearsal (plain versions, bf16, d 1024, 4 / 8 /
# 16 layers): Llama int8 1.64% / 1.74% / 1.91%, OPT int4 0.87% / 1.04% /
# 1.10%, growing slowly with depth
WOQ_LOGIT_TOL_SHARE = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` eager calls, CUDA events, after
    warm-up: the host's cost of a call is in it where it exceeds the
    device's (the plain versions' timings)."""
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


_SIDE_STREAM: list = []


def host_us(fn, calls: int = 2000) -> float:
    """Host µs per call: ``calls`` calls issued back to back, timed on the
    host clock before the closing synchronize (the host's cost, where it
    exceeds the device's)."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def device_ms(fn, sets: int, iters: int) -> float:
    """Mean device ms per call: ``fn(0) .. fn(calls - 1)`` (``calls`` a
    multiple of ``sets`` of at least 20, so each input set rotates through)
    captured once in a CUDA graph, the graph replayed until ``iters`` calls
    ran, timed with CUDA events. A replay launches without the host, so
    the time is the device's alone (kernels and library calls alike)."""
    import torch

    calls = sets * -(-20 // sets)
    # one side stream for every capture: cuBLAS keeps a workspace for each
    # stream it ran on, for the life of the process
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up before capture
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    reps = max(1, iters // calls)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _free_memory(dev) -> int:
    """Collect what earlier phases left, return the card's allocated bytes
    and restart the peak count from them (0 on the CPU)."""
    import gc

    import torch

    gc.collect()
    if dev.type != "cuda":
        return 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


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
    kernel_ms = device_ms(lambda i: da.decode_attention(*sets[i % 4][:4]),
                          4, iters)
    plain_ms = time_ms(lambda i: da.decode_attention_plain(*sets[i % 4][:4]),
                       max(iters // 10, 5))
    sdpa_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        sets[i % 4][0].transpose(1, 2), sets[i % 4][1], sets[i % 4][2],
        attn_mask=masks[i % 4], enable_gqa=KV != H), 4, iters)
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


# ------------------------------------------------------- phase 2, WOQ GEMMs
# (name, K, N, times it runs per Llama-2-7B layer, out dtype) of x @ W at
# the decode step, M = 4; the head runs once per step, fp32 out
WOQ_MM_MAIN = (("wqkv", 4096, 12288, 1, None), ("wo", 4096, 4096, 1, None),
               ("w_in/w_gate", 4096, 11008, 2, None),
               ("w_out", 11008, 4096, 1, None),
               ("lm_head", 4096, 32000, 0, "float32"))
# OPT-6.7B's own x @ W shapes (d_ff 16384; wqkv and wo are Llama's):
# checked, not timed
WOQ_MM_OPT = (("w_in", 4096, 16384, 1, None), ("w_out", 16384, 4096, 1, None))
# (name, V, K, group) of x @ W.T, fp32 out: the OPT-6.7B tied head (50272
# rows: one group) and a multi-group table
WOQ_T_MAIN = (("opt_head", 50272, 4096, 128), ("table_32000", 32000, 4096, 128))
# edge cases: (kernel, M, rows, cols, group, bits, x dtype, out dtype)
WOQ_EDGES = (
    ("mm", 1, 4096, 4096, 128, 8, "bfloat16", None),
    ("mm", 17, 4096, 4096, 128, 4, "bfloat16", None),
    ("mm", 4, 1024, 1024, 128, 8, "float32", None),
    ("mm", 4, 1000, 512, 128, 8, "bfloat16", None),     # K degrades: G = 1
    ("mm", 4, 1000, 512, 128, 4, "bfloat16", None),     # int4, G = 1
    ("mm", 3, 256, 1001, 128, 8, "float16", "float32"),  # ragged N
    ("mmt", 1, 32000, 4096, 128, 8, "bfloat16", "float32"),
    ("mmt", 17, 4096, 1024, 128, 4, "bfloat16", "float32"),
    ("mmt", 4, 2048, 512, 128, 4, "float32", None),
    ("mmt", 4, 1001, 256, 128, 8, "bfloat16", None),     # odd V: G = 1
)


def _woq_case(gen, kernel, M, rows, cols, group, bits, xdtype, device):
    """x and a quantized weight from a seeded normal draw, through the
    port's ``quantize`` (the layout the engine makes)."""
    import torch

    from deepspeed_tpu_torch.inference.quantization import quantize

    w = torch.randn((rows, cols), generator=gen, device=device)
    w = w * (rows ** -0.5 if kernel == "mm" else 0.02)
    qt = quantize(w, group, bits)
    x = torch.randn((M, cols if kernel == "mmt" else rows), generator=gen,
                    device=device).to(getattr(torch, xdtype))
    return x, qt


def _woq_fns(kernel):
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    return ((wm.woq_matmul, wm.woq_matmul_plain) if kernel == "mm"
            else (wm.woq_matmul_t, wm.woq_matmul_t_plain))


def _woq_check(gen, kernel, M, rows, cols, group, bits, xdtype, out, device):
    """Kernel vs plain on one case; returns (max abs err, share)."""
    import torch

    x, qt = _woq_case(gen, kernel, M, rows, cols, group, bits, xdtype, device)
    fn, plain = _woq_fns(kernel)
    kw = dict(group_size=qt.group_size, bits=qt.bits,
              out_dtype=out and getattr(torch, out))
    got = fn(x, qt.q, qt.scale, **kw)
    want = plain(x, qt.q, qt.scale, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    share = err / max(want.float().abs().max().item(), 1e-30)
    tol = WOQ_TOL_SHARE[str(got.dtype)]
    ok = math.isfinite(err) and share <= tol
    log(f"[kernel] {fn.__name__:12s} M{M} {rows}x{cols} g{qt.group_size} "
        f"int{qt.bits} x {xdtype} out {got.dtype}: max_abs_err {err:.3e}, "
        f"{share:.2e} of max |out| (tol {tol:.2e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{fn.__name__} M{M} {rows}x{cols} int{bits}: "
                             f"share {share} > {tol}")
    return err, share


def _woq_timing(gen, kernel, M, rows, cols, group, bits, out, iters):
    """Kernel, plain and library ms at one main shape, with its bound.
    The kernel's inputs rotate through enough sets to pass 200 MB, so each
    launch finds its weight outside the 50 MB L2, as in a decode step."""
    import torch

    dev = "cuda"
    fn, plain = _woq_fns(kernel)
    out_dtype = getattr(torch, out) if out else None
    x, qt = _woq_case(gen, kernel, M, rows, cols, group, bits, "bfloat16", dev)
    gs, bits = qt.group_size, qt.bits
    set_bytes = qt.q.numel() + qt.scale.numel() * 4
    n = max(2, -(-200 * 2**20 // set_bytes))
    # timing sets: random bytes and scales in the same layout
    sets = [(x, torch.randint(-128, 128, qt.q.shape, generator=gen,
                              device=dev, dtype=torch.int8),
             torch.rand(qt.scale.shape, generator=gen, device=dev) * 0.01)
            for _ in range(n)]
    kw = dict(group_size=gs, bits=bits, out_dtype=out_dtype)
    kernel_ms = device_ms(lambda i: fn(*sets[i % n], **kw), n, iters)
    plain_ms = time_ms(lambda i: plain(*sets[i % 2], **kw),
                       max(iters // 20, 5))
    # library: torch.matmul of x with the dense bf16 weight of this shape
    dense = rows * cols * 2
    nd = max(2, -(-200 * 2**20 // dense))
    ws = [torch.randn((rows, cols), generator=gen, device=dev,
                      dtype=torch.bfloat16) for _ in range(nd)]
    if kernel == "mm":
        lib = lambda i: torch.matmul(x, ws[i % nd])              # noqa: E731
    else:
        lib = lambda i: torch.matmul(x, ws[i % nd].T)            # noqa: E731
    library_ms = device_ms(lib, nd, iters)
    del ws, sets
    esize = x.element_size()
    out_cols = cols if kernel == "mm" else rows
    nbytes = (set_bytes + x.numel() * esize
              + M * out_cols * (4 if out else esize))
    ops = 2 * M * rows * cols
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(x.dtype)] * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"[kernel] {fn.__name__:12s} M{M} {rows}x{cols} g{gs} int{bits} "
        f"out {out or 'bf16'}: kernel {kernel_ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, torch.matmul bf16 dense "
        f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes} B, "
        f"{ops} flop), kernel at {bound_ms / kernel_ms:.1%} of the bound")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "t_bytes": t_bytes, "t_ops": t_ops}


def phase_woq_kernels(device="cuda", iters=200, main=WOQ_MM_MAIN,
                      main_t=WOQ_T_MAIN, edges=WOQ_EDGES, M=4,
                      main_opt=WOQ_MM_OPT) -> dict:
    """Both WOQ kernels against their plain versions at the main shapes of
    both models (int8 and int4) and the edge cases; on the card, timed at
    the Llama-2-7B and head shapes. Returns the JSON numbers of each
    kernel: ``woq_matmul`` summed over one Llama-2-7B int8 layer's
    projections, ``woq_matmul_t`` at the OPT-6.7B int4 tied head."""
    import torch

    gen = torch.Generator(device=device).manual_seed(2)
    errs = {"mm": 0.0, "mmt": 0.0}
    for bits in (8, 4):
        for _, K, N, _, out in main + main_opt:
            e, _ = _woq_check(gen, "mm", M, K, N, 128, bits, "bfloat16", out,
                              device)
            errs["mm"] = max(errs["mm"], e)
        for _, V, K, group in main_t:
            e, _ = _woq_check(gen, "mmt", M, V, K, group, bits, "bfloat16",
                              "float32", device)
            errs["mmt"] = max(errs["mmt"], e)
    for case in edges:
        _woq_check(gen, *case, device)
    result = {"woq_matmul": {"max_abs_err": errs["mm"]},
              "woq_matmul_t": {"max_abs_err": errs["mmt"]}}
    if device != "cuda":
        return result

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")
    layer = dict.fromkeys(keys, 0.0)
    for bits in (8, 4):
        for name, K, N, per_layer, out in main:
            t = _woq_timing(gen, "mm", M, K, N, 128, bits, out, iters)
            if bits == 8:
                for k in keys:
                    layer[k] += per_layer * t[k]
        for name, V, K, group in main_t:
            t = _woq_timing(gen, "mmt", M, V, K, group, bits, "float32",
                            iters)
            if bits == 4 and name == "opt_head":
                head = t
    for r, t in (("woq_matmul", layer), ("woq_matmul_t", head)):
        result[r].update({k: t[k] for k in keys[:4]})
        result[r]["bound_by"] = ("bytes" if t["t_bytes"] >= t["t_ops"]
                                 else "operations")
    log(f"[kernel] woq_matmul, one Llama-2-7B int8 layer (wqkv + wo + w_in "
        f"+ w_gate + w_out, M {M}): kernel {layer['ms'] * 1e3:.2f} us, "
        f"bound {layer['bound_ms'] * 1e3:.2f} us, torch.matmul bf16 dense "
        f"{layer['library_ms'] * 1e3:.2f} us")

    # the host's cost of one call at the wo shape: the decode loop is eager
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    x, qt = _woq_case(gen, "mm", M, 4096, 4096, 128, 8, "bfloat16", device)
    w = torch.randn((4096, 4096), generator=gen, device=device,
                    dtype=torch.bfloat16)
    woq_host = host_us(lambda: wm.woq_matmul(x, qt.q, qt.scale,
                                             group_size=qt.group_size))
    mm_host = host_us(lambda: torch.matmul(x, w))
    log(f"[kernel] host cost per call, M {M} 4096x4096 int8: woq_matmul "
        f"{woq_host:.2f} us (two launches: product + split-K sum), "
        f"torch.matmul on the dense bf16 weight {mm_host:.2f} us")
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
    resident = _free_memory(dev)
    da.decode_attention.launches = 0
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
        f"{peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident "
        "before the call)")
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


# ------------------------------------------------------------------ phase 4
def _clone_cache(cache):
    from deepspeed_tpu_torch.inference.decode import KVCache

    return KVCache(cache.k.clone(), cache.v.clone(), cache.length)


def _teacher_forced(model, params, tokens, cache, flash_decode, steps):
    """fp32 logits of ``steps`` decode steps fed ``tokens[:, i]``, from a
    copy of ``cache``."""
    import torch

    from deepspeed_tpu_torch.inference.decode import forward_with_cache

    c = _clone_cache(cache)
    out = []
    with torch.inference_mode():
        for i in range(steps):
            lg, c = forward_with_cache(model, params, tokens[:, i:i + 1], c,
                                       flash_decode=flash_decode)
            if not torch.isfinite(lg).all():
                raise AssertionError(f"non-finite logits at step {i}")
            out.append(lg)
    return out


def _worst_share(a, b) -> float:
    """max over steps of max |a - b| / max |b|."""
    return max(((x - y).abs().max() / y.abs().max()).item()
               for x, y in zip(a, b))


def phase_woq(cfg, *, bits: int, group: int = 128, batch=4, prompt=512,
              max_new=128, device=None, check_steps=8, woq_kernel=None,
              profile_steps=4) -> dict:
    """The WOQ main path, ``init_inference(model, params, {"quantize":
    True, ...}).generate``, once, with every kernel count zeroed just
    before and read just after; then TTFT and decode rate timed apart, a
    profile of the decode step, the kernel-vs-per-use-dequant logit gate
    and the logged distance to the bf16 engine."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.decode import (decode_tokens,
                                                      prefill_tokens)
    from deepspeed_tpu_torch.inference.quantization import (
        decode_weight_bytes, quantized_bytes)
    from deepspeed_tpu_torch.inference.sampling import sample_logits
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kw = {} if device is None else {"device": device}
    dtype = str(cfg.dtype).removeprefix("torch.")
    tag = f"[woq {cfg.n_layer}L d{cfg.d_model} int{bits}]"
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(4321)
    params = model.init(gen, device=dev, dtype=cfg.dtype)
    ids = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                        device=dev)
    forced = torch.randint(0, cfg.vocab_size, (batch, check_steps),
                           generator=gen, device=dev)
    greedy = partial(sample_logits, greedy=True)

    # the bf16 engine's teacher-forced logits, for the log only
    dense = dt.init_inference(model, params, {"dtype": dtype}, **kw)
    with torch.inference_mode():
        carry = prefill_tokens(dense.model, dense.params, ids, None,
                               max_new=max_new, sampler=greedy,
                               flash_decode=dense.flash_decode)
    ref = _teacher_forced(dense.model, dense.params, forced, carry.cache,
                          dense.flash_decode, check_steps)
    dense_bytes = decode_weight_bytes(dense.params)
    del dense, carry

    conf = {"dtype": dtype, "quantize": True, "quant_bits": bits,
            "quant_group_size": group}
    if woq_kernel is not None:
        conf["woq_kernel"] = woq_kernel
    t0 = time.perf_counter()
    engine = dt.init_inference(model, params, conf, **kw)
    sync()
    init_s = time.perf_counter() - t0
    del params                       # the engine holds the quantized copy
    qbytes, dbytes = quantized_bytes(engine.params), \
        decode_weight_bytes(engine.params)
    log(f"{tag} {cfg.param_count() / 1e9:.3f} B params, group {group}, "
        f"tied head {cfg.tie_embeddings}, woq_kernel {engine.model.woq_kernel}"
        f", flash_decode {engine.flash_decode}: quantized in {init_s:.1f} s; "
        f"quantized_bytes {qbytes} ({qbytes / 2**30:.2f} GiB), "
        f"decode_weight_bytes {dbytes} (bf16: {dense_bytes})")
    engine.generate(ids[:, :32], 4, greedy=True)           # warm-up
    sync()

    # ---- the main path, counted ----
    counters = (da.decode_attention, wm.woq_matmul, wm.woq_matmul_t)
    resident = _free_memory(dev)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(ids, max_new, greedy=True)
    sync()
    wall = time.perf_counter() - t0
    got = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    steps = max_new - 1
    per_layer = 5 if cfg.is_glu else 4
    on_card = cuda and engine.model.woq_kernel
    want = {"decode_attention": cfg.n_layer * steps if engine.flash_decode
            and cuda else 0,
            "woq_matmul": (per_layer * cfg.n_layer
                           + (not cfg.tie_embeddings)) * steps if on_card
            else 0,
            "woq_matmul_t": steps if on_card and cfg.tie_embeddings else 0}
    log(f"{tag} generate {batch}x{prompt} -> {tuple(out.shape)} in "
        f"{wall:.3f} s; launches {got} (want {want}); peak memory "
        f"{peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB resident before "
        "the call)")
    if got != want:
        raise AssertionError(f"{tag} launches {got}, want {want}")
    if out.shape != (batch, max_new) or out.dtype != torch.long \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad generate output {out.shape} {out.dtype}")

    # ---- TTFT and decode rate, the two halves timed apart ----
    step_kw = dict(sampler=greedy, flash_decode=engine.flash_decode)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        carry = prefill_tokens(engine.model, engine.params, ids, None,
                               max_new=max_new, materialize=engine.materialize,
                               **step_kw)
        sync()
        ttft = time.perf_counter() - t0
        base = carry.cache
        cache = _clone_cache(base)      # decode below writes base in place
        t0 = time.perf_counter()
        again = decode_tokens(engine.model, engine.params, carry,
                              steps=steps, **step_kw)
        sync()
        dec = time.perf_counter() - t0
    log(f"{tag} TTFT {ttft * 1e3:.1f} ms (dense prefill {batch}x{prompt}); "
        f"decode {steps} steps {dec:.3f} s = {dec / steps * 1e3:.2f} ms/step,"
        f" {batch * steps / dec:.1f} tok/s; rerun tokens identical "
        f"{bool((again == out).all())}")
    shares = {}
    if cuda:
        prof = profile_decode(engine, _clone_cache(cache), out, step_kw,
                              steps=profile_steps)
        if prof:
            for name in ("woq_matmul_kernel", "woq_reduce_kernel",
                         "woq_matmul_t_kernel"):
                us = sum(v for k, v in prof["by_name"].items()
                         if f"{name}<" in k)
                shares[name] = us / prof["busy"]
            log(f"{tag} WOQ kernels' share of device time: "
                + ", ".join(f"{k} {v:.1%}" for k, v in shares.items()))

    # ---- kernel path vs per-use dequant, teacher-forced (gated) ----
    kern = _teacher_forced(engine.model, engine.params, forced, cache,
                           engine.flash_decode, check_steps)
    engine.model.woq_kernel = False
    per_use = _teacher_forced(engine.model, engine.params, forced, cache,
                              engine.flash_decode, check_steps)
    engine.model.woq_kernel = conf.get("woq_kernel", cuda)
    worst = _worst_share(kern, per_use)
    vs_bf16 = _worst_share(kern, ref)
    agree = sum((a.argmax(-1) == b.argmax(-1)).float().mean().item()
                for a, b in zip(kern, ref)) / check_steps
    log(f"{tag} kernel vs per-use dequant logits over {check_steps} "
        f"teacher-forced steps: max |diff| / max |logit| {worst:.4f} (tol "
        f"{WOQ_LOGIT_TOL_SHARE}); vs the bf16 engine {vs_bf16:.4f}, greedy "
        f"agreement {agree:.3f} (logged, not gated)")
    if worst > WOQ_LOGIT_TOL_SHARE:
        raise AssertionError(f"{tag} kernel vs per-use dequant logits differ "
                             f"by {worst:.4f} of max |logit|")
    del engine, base, cache, carry
    _free_memory(dev)
    return {"launches": got, "ttft_ms": ttft * 1e3,
            "step_ms": dec / steps * 1e3, "decode_tok_s": batch * steps / dec,
            "peak_bytes": peak, "generate_s": wall, "quantized_bytes": qbytes,
            "decode_weight_bytes": dbytes, "gate_share": worst,
            "vs_bf16_share": vs_bf16, "kernel_shares": shares}


def profile_decode(engine, cache, out, step_kw, steps: int = 4):
    """Where a decode step's time goes: torch.profiler over ``steps``
    steps; the device's busy share of the window (the sum of the device
    events' durations, one stream, over the host wall time) and the top
    kernels by device time. Returns ``{"by_name": {kernel: us}, "busy":
    us, "wall": us}``, or None when the profiler saw no device time."""
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
        return None
    log(f"[profile] {steps} decode steps: wall {wall_us / steps / 1e3:.2f} "
        f"ms/step, device busy {busy / steps / 1e3:.2f} ms/step = "
        f"{busy / wall_us:.1%} of the wall (idle {1 - busy / wall_us:.1%})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / steps:9.1f} us/step {us / busy:6.1%}  "
            f"{name[:100]}")
    return {"by_name": by_name, "busy": busy, "wall": wall_us}


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
    from deepspeed_tpu_torch.models import llama2, opt

    t0 = time.perf_counter()
    dev = phase_device()
    kern = phase_kernels()
    woq = phase_woq_kernels()
    sl = phase_slice()
    woq8 = phase_woq(llama2("7b"), bits=8)
    woq4 = phase_woq(opt("6.7b"), bits=4)
    log(f"[done] all phases in {time.perf_counter() - t0:.1f} s")
    src = "deepspeed_tpu_torch/ops/csrc/"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": "deepspeed_tpu/ops/decode_attention.py:41",
         "launches": sl["launches"], **{k: kern[k] for k in keys}},
        # launches: the Llama-2-7B int8 path (untied head)
        {"name": "woq_matmul", "route": "cuda", "source": src + "woq_matmul.cu",
         "replaces": "deepspeed_tpu/ops/woq_matmul.py:62",
         "launches": woq8["launches"]["woq_matmul"],
         **{k: woq["woq_matmul"][k] for k in keys}},
        # launches: the OPT-6.7B int4 path (tied head)
        {"name": "woq_matmul_t", "route": "cuda",
         "source": src + "woq_matmul.cu",
         "replaces": "deepspeed_tpu/ops/woq_matmul.py:130",
         "launches": woq4["launches"]["woq_matmul_t"],
         **{k: woq["woq_matmul_t"][k] for k in keys}}]
    print(json.dumps({"kernels": kernels}))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
