#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: the card's name and power limit; build every CUDA kernel of
   ``deepspeed_tpu_torch/ops/csrc`` (nvcc, sm_90a, one process per source,
   all at once) and print nvcc's register / shared-memory lines; count the
   wgmma and TMA instructions in the SASS (cuobjdump) of the wgmma
   forward's and backward pair's libraries (each > 0) and the kernels of
   theirs that spill or have a warpgroup wait injected by ptxas (none),
   and print their shared memory;
2. kernels: each kernel (decode attention, the WOQ GEMMs ``woq_matmul``
   and ``woq_matmul_t``) against its plain PyTorch version on the card, at
   the main paths' shapes and the edge cases, within stated tolerances
   (decode attention also at its split plan's edges, with all rows empty,
   one 32768-position row, hd 40 / 256 and fp32 GQA, rows with L = 0
   exactly 0 and two calls bit-identical; ``woq_matmul_t`` in fp16 and at
   M 1 / 8 / 17 on both routes, each line naming its route); then timed on
   L2-cold inputs (device time: calls captured in a CUDA graph, replays
   timed with CUDA events) beside the plain version (eager calls), the
   PyTorch library call that computes the same function (device time),
   the bound and the host cost of a call: decode attention at Llama-2-7B's
   shape, Llama-2-70B's GQA heads and a B 16 / cache 4096 serving shape
   with ragged lengths (a ``[decode-attn]`` JSON line each);
3. slice: ``init_inference(...).generate`` on Llama-2-7B at full width in
   bf16 with seeded random weights (4 prompts x 512 tokens, 128 new
   tokens, greedy), with the kernel's launch count read around that one
   call; the kernel path's logits teacher-forced against the dense
   attention path; a sampled call repeated with the same request seeds;
4. WOQ slice: the same traffic through ``init_inference(..., {"quantize":
   True})`` on Llama-2-7B in int8 (untied head: ``woq_matmul``) and on
   OPT-6.7B in int4 (tied head: ``woq_matmul_t``), both at full width and
   depth, group 128, with every kernel's launch count read around one
   ``generate`` (the tied head's ``woq_matmul_t`` route printed, and gated
   to the tensor-core route on the card); the kernel path's logits
   teacher-forced against the
   per-use dequantization path on the same quantized weights (gated) and
   against the bf16 engine (logged);
5. flash kernels: the forward, dq and dk/dv kernels against their plain
   versions in bf16 and fp16 at GPT-2 1.5B's attention shape, Llama-2-7B's
   (hd 128, S 4096), Llama-2-70B's GQA heads, S 8192 (where the TPU
   switches to its streamed kernels) and edge cases (padding masks with
   fully masked rows, ALiBi, non-causal, odd S, hd 16/32), dq exactly 0 on
   rows with no live key and dk/dv exactly 0 on masked keys; then at the
   GPT-2 shape, at S 8192 and at Llama-2-7B's, Llama-2-70B's GQA heads,
   BERT-large's (under phase 8's key padding) and GPT-2's in fp16, each
   kernel checked the same way once more and timed beside the bound, the
   plain versions and the library calls (SDPA's forward; the aten flash
   backward for dq + dk/dv, masked SDPA's autograd backward under the key
   padding); the host cost of a call of each wrapper and of the forward's
   tensor maps;
5b. xent kernels: the forward (its ``partials`` mode on each shard of a
   4-way hand split of a 50304-row vocab, combined by hand), dx and dW/db
   kernels against their plain versions in bf16 at GPT-2 1.5B's head shape
   (T 4092, V 50257, d 1600), BERT-large's (T 8192, V 30522, d 1024, with
   the bias) and the edges (nothing divides, one token, d 2304 and 6144; a
   target in the last valid column, targets outside the vocab, rows with
   g = 0);
   timed at the GPT-2 shape beside the bound, the plain versions and the
   library (``F.cross_entropy`` of ``F.linear`` and its autograd backward);
5c. sparse kernels: the block-sparse forward, dq and dk/dv kernels against
   their plain versions in bf16 and fp16 at the slice's shape (B 1, H 25,
   S 8192, hd 64, the default Fixed layout, causal), each of the five
   layouts causal and not, blocks 16, 32 and 128, hd 128 and 16, GQA and
   MQA, one block, and a layout whose widest list is far wider than its
   narrowest; the dense layout through them against the flash kernels;
   timed at the slice's shape beside the bound, the plain versions, SDPA
   under the expanded (S, S) boolean mask (forward and its autograd
   backward), the flash kernels on the dense causal problem and the sparse
   kernels in natural block order;
5d. flash kernels with the bias operand and in fp32: the forward, dq
   (with and without dbias) and dk/dv kernels against their plain versions
   in bf16, fp16 and fp32 on every bias layout ((S, S), (H, S, S), (B, H,
   S, S), (B, 1, S, S), (1, H, S, S) and a (1, H, S, S) bias expanded at
   stride 0), bias dtypes other than q's, masks, GQA / MQA, hd 16-128,
   ragged S, dbias exactly 0 above a causal diagonal; the fp32 kernels
   without a bias on phase 5's cases; timed at phase 10's two shapes
   (AlphaFold 2's MSA rows in bf16, the DS4Science example in fp32) beside
   the bound, the plain versions and SDPA with the bias as a float
   attn_mask (forward and its autograd backward), and in fp32 at GPT-2
   1.5B's shape beside SDPA in fp32;
6. training, the unfused reference: GPT-2 1.5B at full width and depth with
   ``fused_xent=False`` through ``initialize(TRAIN_CONFIG, build_model(cfg,
   attention_fn=make_flash_attention())).train_batch``; first the kernel
   attention path's loss and grads against the plain attention path at 4
   layers; then 2 warm-up and 4 timed steps on learnable data with every
   kernel's count read around the timed steps (exact), each loss finite,
   the loss falling; step time, tokens/s, MFU, peak memory and a profile
   of two steps;
7. training, the main path: GPT-2 1.5B under its default config (a tied
   head with ``fused_xent=None``: the fused xent kernels on the card), the
   same entry points, 3 + 10 steps; first, at 4 layers, the fused head's
   loss and grads against the unfused head's on the same weights and
   batch, and each head timed alone; launches exact (xent 2 / 2 / 2 per
   optimizer step at gas 2, flash as in phase 6);
8. training, BERT-large's MLM objective in the Hugging Face layout
   (``post_ln``, ``embed_norm``, ``mlm_transform``, ``lm_head_bias``), 24
   layers, micro-batch 16 x 512, bidirectional flash attention under a
   key-padding mask, 15% of the positions counted, through the same xent
   kernels with the bias operand live: the same checks, 3 + 6 steps;
9. training at 8192 tokens a row under the Fixed sparsity layout:
   ``gpt2("1.5b", max_seq=8192)`` with ``make_sparse_attention_fn(
   FixedSparsityConfig())`` through ``initialize(LONG_TRAIN_CONFIG, ...)``
   (micro-batch 1 x gas 2): at 4 layers the kernel path against the plain
   sparse path, then 2 + 5 steps at full depth; launches exact (sparse 192
   / 96 / 96 per optimizer step, flash 0, xent 2 / 2 / 2);
10. the evoformer block: ``ops.evoformer.evoformer_attention`` (the flash
   kernels with a learned pair bias, its dbias from the dq kernel, gated
   by sigmoid) trained by SGD. (a) ``examples/evoformer_science.py`` at
   its full size (B 4, S 256, H 8, hd 32, a full (B, H, S, S) bias
   projected from the pair representation) from its seeded weights, 50
   steps at lr 0.05 in fp32 (losses within 1e-4 of the plain path's at
   every step) and in bf16 (phase 6's gate); (b) AlphaFold 2's MSA
   row-wise gated self-attention with pair bias at 128 clusters x 256
   residues in bf16, one (1, 8, 256, 256) bias shared by the rows, a key
   mask on padded residues: first step against the plain path, then 2 + 5
   steps with ms a step, peak memory against the plain path's and the
   kernels' share of device time. Launches exactly 1 / 1 / 1 a step.

``remat_sweep()`` is a one-off measurement outside the phases: the default
GPT-2 1.5B training step under each remat policy.

Before them, a ``[flash-bias]`` line holds the JSON of phases 5d and 10's
kernel rows (each flash kernel with the bias at phase 10's two shapes,
and in fp32 at GPT-2 1.5B's), a ``[flash-fwd]`` line phase 5's forward
timings at its other shapes, the host costs and the forward's SASS counts,
and a ``[flash-bwd]`` line the backward pair's timings at the same shapes
and the SASS counts of its two libraries. The kernels line lists each flash kernel twice: at GPT-2 1.5B's shape (rows 2-4
of PERF.md) and at S 8192, where it stands for the TPU's streamed kernel
(rows 5-7).
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
    import ctypes

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
                                       "spill", "Performance Loss")):
                log(f"[build]   {line.strip()}")
    sass = {}
    for lib in ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90"):
        sass[lib] = sass_counts(built[lib]["path"])
        fit = ptxas_fit(built[lib]["log"])
        log(f"[build] {lib}: SASS instructions {sass[lib]} (HGMMA: wgmma, "
            f"UTMALDG: TMA loads); ptxas: {fit['kernels']} kernels, "
            f"{fit['spilling']} spilling, {fit['injected_waits']} injected "
            "warpgroup waits (C7517 / C7519)")
        if not sass[lib]["HGMMA"] or not sass[lib]["UTMALDG"]:
            raise AssertionError(f"{lib} has no wgmma or TMA: {sass[lib]}")
        if not fit["kernels"] or fit["spilling"] or fit["injected_waits"]:
            raise AssertionError(f"{lib}: ptxas reports {fit}")
    smem = builder.load("flash_fwd_sm90").dstpu_flash_fwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    log("[build] flash_fwd_sm90: dynamic shared memory " + ", ".join(
        f"hd {hd}{' bias' if bias else ''} {smem(hd, bias)} B"
        for hd in (32, 64, 128) for bias in (0, 1)))
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        smem = getattr(builder.load(f"{kernel}_sm90"),
                       f"dstpu_{kernel}_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        log(f"[build] {kernel}_sm90: dynamic shared memory " + ", ".join(
            f"hd {hd} {smem(hd)} B" for hd in (32, 64, 128)))
    return {"nvidia_smi": smi, "flash_sass": sass}


def ptxas_fit(build_log: str) -> dict:
    """From nvcc's ``-Xptxas -v`` output: the kernels it reports, those
    that spill, and the warpgroup waits it injected into wgmma sequences
    (C7517 / C7519), each of which serializes the products."""
    import re

    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        build_log)
    return {"kernels": len(spills),
            "spilling": sum(1 for st, ld in spills if int(st) or int(ld)),
            "injected_waits": len(re.findall(r"\(C751[79]\)", build_log))}


def sass_counts(path: str) -> dict:
    """Counts of the wgmma (HGMMA), TMA load (UTMALDG) and register
    reconfiguration (USETMAXREG) instructions in a library's SASS, read
    with the toolkit's cuobjdump."""
    import subprocess

    from deepspeed_tpu_torch.ops import builder

    tool = Path(builder.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    return {k: out.count(k) for k in ("HGMMA", "UTMALDG", "USETMAXREG")}


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


# decode attention's timed shapes: (name, B, H, KV, hd, S, lengths); a
# tuple of lengths is taken as given, an int n draws n lengths from a seed
# in 512 .. S (the serving engine's ragged rows)
DECODE_TIMED = (("main", 4, 32, 32, 128, 640, (600, 589, 611, 597)),
                ("gqa_70b", 4, 64, 8, 128, 640, (600, 589, 611, 597)),
                ("serving", 16, 32, 32, 128, 4096, 16))


def _decode_bound(B, H, KV, hd, lengths, esize, dtype) -> tuple:
    """(bound ms, "bytes" | "operations", bytes, flops) of one call: each
    live K / V row, q and out once; 4 hd flops a live position and head."""
    live = sum(lengths)
    nbytes = live * KV * hd * esize * 2 + 2 * B * H * hd * esize + 4 * B
    ops = live * H * hd * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def _decode_timing(gen, name, B, H, KV, hd, S, lengths, iters) -> dict:
    """Kernel (device time, input sets rotated past 200 MB so every launch
    finds its cache outside the 50 MB L2), plain, masked SDPA and the
    bound at one shape; the kernel first checked against its plain version
    on each set; the host cost of a call."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import decode_attention as da

    if isinstance(lengths, int):
        rng = torch.Generator().manual_seed(9)
        lengths = tuple(torch.randint(512, S + 1, (lengths,),
                                      generator=rng).tolist())
    set_bytes = B * KV * S * hd * 2 * 2
    n = max(2, -(-200 * 2**20 // set_bytes))
    sets = [_case(gen, B=B, H=H, KV=KV, hd=hd, S=S, lengths=lengths)
            for _ in range(n)]
    for q, ck, cv, length, _ in sets:
        err = (da.decode_attention(q, ck, cv, length).float()
               - da.decode_attention_plain(q, ck, cv, length).float()
               ).abs().max().item()
        if not (math.isfinite(err) and err <= TOL["torch.bfloat16"]):
            raise AssertionError(f"decode_attention {name}: max abs err {err}")
    masks = [(torch.arange(S, device="cuda")[None, :]
              < st[3][:, None])[:, None, None, :] for st in sets]
    kernel_ms = device_ms(lambda i: da.decode_attention(*sets[i % n][:4]), n,
                          iters)
    plain_ms = time_ms(lambda i: da.decode_attention_plain(*sets[i % n][:4]),
                       max(iters // 20, 5))
    sdpa_ms = device_ms(lambda i: F.scaled_dot_product_attention(
        sets[i % n][0].transpose(1, 2), sets[i % n][1], sets[i % n][2],
        attn_mask=masks[i % n], enable_gqa=KV != H), n, iters)
    q, ck, cv, length, _ = sets[0]
    # the host's cost of a call where it exceeds the device's (at the
    # serving shape the device's time would show instead)
    host = (host_us(lambda: da.decode_attention(q, ck, cv, length))
            if name == "main" else None)
    bound_ms, bound_by, nbytes, ops = _decode_bound(
        B, H, KV, hd, lengths, q.element_size(), str(q.dtype))
    plan = da.split_plan(B, H, KV, S, hd, torch.cuda.get_device_properties(
        0).multi_processor_count)
    r = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": sdpa_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "host_us": host,
         "shape": dict(B=B, H=H, KV=KV, hd=hd, S=S, lengths=list(lengths)),
         "plan": plan}
    log(f"[decode-attn] {name}: " + json.dumps(r))
    log(f"[kernel] decode_attention {name} B{B} H{H} KV{KV} hd{hd} S{S}: "
        f"kernel {kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
        f"sdpa {sdpa_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
        f"({bound_by}: {nbytes} B, {ops} flop), kernel at "
        f"{bound_ms / kernel_ms:.1%} of the bound, {kernel_ms / sdpa_ms:.2f}x"
        f" SDPA; host {host} us a call; {plan['nsplit']} splits of "
        f"{plan['chunk']}")
    del sets, masks
    return r


def phase_kernels(device="cuda", main_shape=None, iters=200,
                  timed=DECODE_TIMED, long_S=32768) -> dict:
    """Decode attention's kernel vs plain on every case (rows with L = 0
    exactly 0; two calls bit-identical); timings at ``timed``'s shapes."""
    import torch

    from deepspeed_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=device).manual_seed(0)
    main = dict(main_shape or {})
    B = main.get("B", 4)
    S = main.get("S", 640)
    hd = main.get("hd", 128)
    sms = (torch.cuda.get_device_properties(0).multi_processor_count
           if device == "cuda" else 132)
    c = da.split_plan(B, main.get("H", 32), main.get("KV", 32), S, hd,
                      sms)["chunk"]
    edge = tuple(min(x, S) for x in (c, c + 1, 2 * c, 2 * c + 1))
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
        "split_edges": dict(lengths=edge),
        "all_empty": dict(lengths=(0,) * B),
        "long_b1": dict(B=1, S=long_S, lengths=(long_S - 7,)),
        "hd40": dict(hd=40),
        "hd256": dict(hd=256, H=8, KV=8),
        "fp32_gqa": dict(dtype=torch.float32, KV=8),
    }
    errs = {}
    for name, over in cases.items():
        q, ck, cv, length, slopes = _case(gen, device=device,
                                          **{**main, **over})
        got = da.decode_attention(q, ck, cv, length, alibi_slopes=slopes)
        again = da.decode_attention(q, ck, cv, length, alibi_slopes=slopes)
        want = da.decode_attention_plain(q, ck, cv, length,
                                         alibi_slopes=slopes)
        if device == "cuda":
            torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL[str(q.dtype)]
        lens = torch.as_tensor(length).reshape(-1).expand(q.shape[0])
        zero_rows = got[lens.to(got.device) == 0]
        exact = bool((zero_rows == 0).all())
        same = torch.equal(got, again)
        ok = math.isfinite(err) and err <= tol and exact and same
        log(f"[kernel] decode_attention {name:13s} {str(q.dtype):15s} "
            f"B{q.shape[0]} H{q.shape[2]} KV{ck.shape[1]} hd{q.shape[3]} "
            f"S{ck.shape[2]} max_abs_err {err:.3e} (tol {tol:g}), L = 0 rows "
            f"exactly 0 {exact}, two calls bit-identical {same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention {name}: max abs err "
                                 f"{err} (tol {tol}), zero rows exact "
                                 f"{exact}, repeatable {same}")
        errs[name] = err
        del q, ck, cv, got, again, want
    result = {"max_abs_err": errs["main"]}
    if device != "cuda":
        return result

    shapes = {t[0]: _decode_timing(gen, *t, iters) for t in timed}
    result.update({k: shapes["main"][k] for k in
                   ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "host_us")})
    result["shapes"] = shapes
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
    # the tensor-core route: M 1 / 8 / 17 and fp16 x at the OPT head;
    # ragged K keeps the CUDA-core route
    ("mmt", 1, 50272, 4096, 128, 4, "bfloat16", "float32"),
    ("mmt", 8, 50272, 4096, 128, 4, "bfloat16", "float32"),
    ("mmt", 17, 50272, 4096, 128, 8, "bfloat16", "float32"),
    ("mmt", 4, 50272, 4096, 128, 4, "float16", "float32"),
    ("mmt", 4, 32000, 4096, 128, 8, "float16", None),
    ("mmt", 8, 32000, 4096, 128, 4, "float16", None),
    ("mmt", 4, 2048, 130, 128, 8, "bfloat16", "float32"),
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


def _woq_route(kernel, x, rows, cols, group) -> str:
    """`` (route mma)`` / `` (route simt)`` for x @ W.T, else ``""``."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    if kernel != "mmt":
        return ""
    return f" (route {wm.woq_t_route(x.dtype, cols, rows, group)})"


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
    route = _woq_route(kernel, x, rows, cols, qt.group_size)
    log(f"[kernel] {fn.__name__:12s}{route} M{M} {rows}x{cols} g{qt.group_size} "
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
    log(f"[kernel] {fn.__name__:12s}{_woq_route(kernel, x, rows, cols, gs)} "
        f"M{M} {rows}x{cols} g{gs} int{bits} "
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
    # and of x @ W.T at the OPT-6.7B int4 head (fp32 out, as decode asks)
    x, qt = _woq_case(gen, "mmt", M, 50272, 4096, 128, 4, "bfloat16", device)
    t_host = host_us(lambda: wm.woq_matmul_t(
        x, qt.q, qt.scale, group_size=qt.group_size, bits=4,
        out_dtype=torch.float32), calls=500)
    log(f"[kernel] host cost per call, M {M} OPT int4 head: woq_matmul_t "
        f"{t_host:.2f} us (route "
        f"{wm.woq_t_route(x.dtype, 4096, 50272, qt.group_size)})")
    result["woq_matmul"]["host_us"] = woq_host
    result["woq_matmul_t"]["host_us"] = t_host
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
    route = None
    if cfg.tie_embeddings:
        table = engine.params["tok_embed"]
        route = wm.woq_t_route(cfg.dtype, cfg.d_model, cfg.vocab_size,
                               table.group_size)
        log(f"{tag} the tied head ({cfg.vocab_size} x {cfg.d_model}, group "
            f"{table.group_size}) runs woq_matmul_t on route {route}")
        if on_card and route != "mma":
            raise AssertionError(f"{tag} woq_matmul_t route {route}, want "
                                 "the tensor-core route mma")

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
                         "woq_matmul_t_kernel", "woq_matmul_t_mma_kernel"):
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
            "vs_bf16_share": vs_bf16, "kernel_shares": shares,
            "head_route": route}


def profile_decode(engine, cache, out, step_kw, steps: int = 4):
    """Where a decode step's time goes (:func:`profile_calls` over
    ``steps`` decode steps)."""
    import torch

    from deepspeed_tpu_torch.inference.decode import GenCarry, decode_tokens

    carry = GenCarry(out[:, 0], cache, None,
                     torch.zeros_like(out[:, 0], dtype=torch.bool))
    with torch.inference_mode():
        return profile_calls(
            lambda: decode_tokens(engine.model, engine.params, carry,
                                  steps=steps, **step_kw),
            steps, "decode steps")


def profile_calls(fn, steps: int, what: str):
    """torch.profiler around one call of ``fn``, which runs ``steps``
    steps: the device's busy share of the window (the sum of the device
    events' durations, one stream, over the host wall time) and the top
    kernels by device time. Returns ``{"by_name": {kernel: us}, "busy":
    us, "wall": us}``, or None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
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
    log(f"[profile] {steps} {what}: wall {wall_us / steps / 1e3:.2f} "
        f"ms/step, device busy {busy / steps / 1e3:.2f} ms/step = "
        f"{busy / wall_us:.1%} of the wall (idle {1 - busy / wall_us:.1%})")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {us / steps:9.1f} us/step {us / busy:6.1%}  "
            f"{name[:100]}")
    return {"by_name": by_name, "busy": busy, "wall": wall_us}


# ------------------------------------------------------------------ phase 5
# (name, B, H, KV, S, hd, causal, mask kind, alibi): the slice's shape
# first; then hd 128 at Llama-2-7B's full length, Llama-2-70B's GQA heads,
# S 8192 where the TPU switches to its streamed kernels (rows 5-7), and
# the edge cases
FLASH_CASES = (
    ("gpt2_1.5b", 4, 25, 25, 1024, 64, True, None, False),
    ("llama2_7b", 1, 32, 32, 4096, 128, True, None, False),
    ("gqa_70b_heads", 1, 64, 8, 2048, 128, True, None, False),
    ("streamed_8192", 1, 8, 8, 8192, 128, True, None, False),
    ("mask_dead_rows", 2, 4, 4, 256, 64, True, "left_pad", False),
    ("mask_noncausal", 2, 4, 2, 256, 64, False, "dead_row", False),
    ("alibi", 2, 8, 8, 512, 64, True, None, True),
    ("noncausal", 2, 4, 4, 512, 128, False, None, False),
    ("odd_S_1000", 2, 4, 4, 1000, 64, True, None, False),
    ("hd32_gqa_alibi_mask", 1, 4, 1, 77, 32, True, "left_pad", True),
    ("hd16_noncausal", 2, 4, 4, 100, 16, False, None, False),
)
# kernel vs plain, max |Δ| / max |plain| of o, dq, dk, dv: the same
# function; the kernels' online softmax rounds p to the storage dtype
# against a running max, the plain version against the row max, and fp32
# sums run in another order, so a few ulps of the output dtype at the top
# of each tensor (bf16 2^-8, fp16 2^-11); lse (fp32) within 2e-3 absolute
# on rows with a live key
FLASH_TOL_SHARE = {"torch.bfloat16": 2e-2, "torch.float16": 1e-2}
FLASH_LSE_ATOL = 2e-3


def _flash_case(gen, B, H, KV, S, hd, causal, mask_kind, alibi, dtype,
                device):
    import torch

    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    mk = partial(torch.randn, generator=gen, device=device)
    q, do = (mk((B, S, H, hd)).to(dtype) for _ in range(2))
    k, v = (mk((B, S, KV, hd)).to(dtype) for _ in range(2))
    mask = None
    if mask_kind is not None:
        mask = torch.ones((B, S), dtype=torch.bool, device=device)
        if mask_kind == "left_pad":        # rows 0-2 of batch 1: no live key
            mask[-1, :3] = False
        elif mask_kind == "bert_pad":      # phase 8's: every fourth row
            mask[1::4, 3 * S // 4:] = False  # padded past 3/4 of its length
        else:                              # batch 1 has no live key at all
            mask[-1] = False
            mask[0, S - 5:] = False
    slopes = alibi_slopes(H, device) if alibi else None
    return dict(q=q, k=k, v=v, do=do, mask=mask, slopes=slopes, causal=causal)


def _share(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def flash_bound(B, H, KV, S, hd, causal, esize, *, side_bytes=0,
                dbias_bytes=0, dtype="torch.bfloat16") -> dict:
    """Least time of each kernel on an H100: FLOPs (fwd 2, dq 3, dk/dv 4
    products of 2·B·H·S²·hd, halved when causal) at the peak rate of the
    operands' type (989 TFLOP/s bf16 / fp16, 67 fp32) against each input
    read and each output written once at 3.35 TB/s: ``side_bytes`` (the
    bias as stored and the (B, S) key mask) in each kernel, ``dbias_bytes``
    as dq writes them."""
    prod = 2 * B * H * S * S * hd / (2 if causal else 1)
    qb, kvb, rowb = B * S * H * hd * esize, B * S * KV * hd * esize, B * H * S * 4
    work = {"flash_fwd": (2 * prod, 2 * qb + 2 * kvb + rowb + side_bytes),
            "flash_bwd_dq": (3 * prod, 3 * qb + 2 * kvb + 2 * rowb
                             + side_bytes + dbias_bytes),
            "flash_bwd_dkv": (4 * prod, 2 * qb + 4 * kvb + 2 * rowb
                              + side_bytes)}
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes), "ops": ops,
                     "bytes": nbytes, "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
    return out


def _flash_check(tag, x, dtype) -> dict:
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv against their plain
    versions on one input set ``x`` (``_flash_case``), each backward kernel
    fed the plain forward's lse and delta: o, dq, dk and dv within
    FLASH_TOL_SHARE of max |plain|, lse within FLASH_LSE_ATOL on rows with
    a live key, dq exactly 0 on rows without one and dk, dv exactly 0 on
    masked keys. Raises past them; returns each kernel's max |Δ|."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    kw = dict(mask=x["mask"], alibi_slopes=x["slopes"], causal=x["causal"])
    q, k, v, do, mask = x["q"], x["k"], x["v"], x["do"], x["mask"]
    o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.attention_delta(o_p, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw)
    if q.is_cuda:
        torch.cuda.synchronize()
    live = lse_p > fa.BIG_NEG / 2
    lse_err = (lse - lse_p).abs()[live].max().item()
    shares = {"o": _share(o, o_p), "dq": _share(dq, dq_p),
              "dk": _share(dk, dk_p), "dv": _share(dv, dv_p)}
    # dq's (B, S, H, hd) rows whose (B, H, S) lse has no live key; dk and
    # dv on masked keys
    zeros = [dq.transpose(1, 2)[~live]]
    if mask is not None:
        zeros += [dk[~mask], dv[~mask]]
    exact = not any(bool(t.any()) for t in zeros)
    tol = FLASH_TOL_SHARE.get(str(dtype), 1e-5)
    finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, dq, dk, dv))
    ok = finite and exact and lse_err <= FLASH_LSE_ATOL and all(
        s <= tol for s in shares.values())
    log(f"[flash] {tag} {str(dtype):15s}: " + ", ".join(
        f"{n} {s:.2e}" for n, s in shares.items())
        + f" of max |plain| (tol {tol:g}); lse {lse_err:.1e} (tol "
        f"{FLASH_LSE_ATOL:g}); dq 0 on dead rows, dk/dv 0 on masked keys: "
        f"{exact} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash {tag} {dtype}: {shares}, lse {lse_err}, "
                             f"finite {finite}, exact zeros {exact}")
    worst = dict.fromkeys(FLASH_NAMES, 0.0)
    for n, a, b in (("flash_fwd", o, o_p), ("flash_bwd_dq", dq, dq_p),
                    ("flash_bwd_dkv", dk, dk_p), ("flash_bwd_dkv", dv, dv_p)):
        worst[n] = max(worst[n], (a.float() - b.float()).abs().max().item())
    return worst


FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def phase_flash_kernels(device="cuda", cases=FLASH_CASES, dtypes=None,
                        iters=50) -> dict:
    """The three flash kernels against their plain versions on every case,
    in bf16 and fp16; on the card, checked again and timed at the first
    (the slice's) shape, at S 8192 and at FLASH_TIMED's shapes."""
    import torch

    gen = torch.Generator(device=device).manual_seed(5)
    dtypes = dtypes or (torch.bfloat16, torch.float16)
    worst = dict.fromkeys(FLASH_NAMES, 0.0)
    for case in cases:
        name, shape = case[0], case[1:]
        for dtype in dtypes:
            x = _flash_case(gen, *shape, dtype, device)
            tag = (f"{name:20s} B{shape[0]} H{shape[1]} KV{shape[2]} "
                   f"S{shape[3]} hd{shape[4]}")
            errs = _flash_check(tag, x, dtype)
            for n in FLASH_NAMES:
                worst[n] = max(worst[n], errs[n])
            del x
    if device != "cuda":
        return {n: {"max_abs_err": worst[n]} for n in FLASH_NAMES}
    main = _flash_timing(gen, cases[0], iters)
    # the TPU's streamed regime (rows 5-7): the same kernels at S 8192
    long = next(c for c in cases if c[0].startswith("streamed"))
    streamed = _flash_timing(gen, long, max(iters // 5, 5))
    # the presets' other shapes, BERT-large's on the main path (phase 8)
    shapes = {c[0]: _flash_timing(gen, c[:8], iters, dtype=c[8])
              for c in FLASH_TIMED}
    for times in (main, streamed, *shapes.values()):
        for n in FLASH_NAMES:
            worst[n] = max(worst[n], times[n]["max_abs_err"])
    result = {n: {**main[n], "max_abs_err": worst[n]} for n in FLASH_NAMES}
    result.update(streamed=streamed, shapes=shapes, host=_flash_host_cost())
    return result


# The flash kernels checked and timed besides phase 5's first case (GPT-2
# 1.5B, rows 2-4) and S 8192 (rows 5-7): (name, B, H, KV, S, hd, causal,
# mask kind, dtype). Llama-2-7B's attention, Llama-2-70B's GQA heads,
# BERT-large's under phase 8's key padding, GPT-2 1.5B's in fp16.
FLASH_TIMED = (
    ("llama2_7b", 1, 32, 32, 4096, 128, True, None, "torch.bfloat16"),
    ("gqa_70b_heads", 1, 64, 8, 2048, 128, True, None, "torch.bfloat16"),
    ("bert_large", 16, 16, 16, 512, 64, False, "bert_pad", "torch.bfloat16"),
    ("gpt2_1.5b_fp16", 4, 25, 25, 1024, 64, True, None, "torch.float16"),
)


def _flash_host_cost() -> dict:
    """Host µs of one call of each flash wrapper on its wgmma kernel (the
    forward encodes three TMA tensor maps a call, dq and dk/dv four each)
    at a shape too small for the device to set the pace, then of one call
    issued while the device is busy, and the encoder's own ns for the
    forward's three maps at GPT-2 1.5B's shape."""
    import ctypes

    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (torch.randn(1, 128, 1, 64, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    us = {"flash_fwd_us": host_us(lambda: fa.flash_fwd(q, k, v)),
          "flash_bwd_dq_us": host_us(
              lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta)),
          "flash_bwd_dkv_us": host_us(
              lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta))}
    enc = fa._lib("flash_fwd_sm90").dstpu_flash_fwd_encode_ns
    enc.argtypes, enc.restype = [ctypes.c_int] * 6, ctypes.c_double
    us["encode_ns"] = enc(4, 1024, 25, 25, 64, 20000)

    def queued(fn):
        # host µs of a call issued behind ~50 ms of queued device work
        # (a spin kernel): a call that waits on the device shows it here
        ts = []
        for _ in range(5):
            torch.cuda._sleep(100_000_000)
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
        return sorted(ts)[2] * 1e6

    us["queued_us"] = {
        "flash_fwd": queued(lambda: fa.flash_fwd(q, k, v)),
        "flash_bwd_dq": queued(lambda: fa.flash_bwd_dq(q, k, v, do, lse,
                                                       delta)),
        "flash_bwd_dkv": queued(lambda: fa.flash_bwd_dkv(q, k, v, do, lse,
                                                         delta))}
    log(f"[flash] host cost a call (B1 H1 S128 hd64): flash_fwd "
        f"{us['flash_fwd_us']:.2f} us, flash_bwd_dq "
        f"{us['flash_bwd_dq_us']:.2f} us, flash_bwd_dkv "
        f"{us['flash_bwd_dkv_us']:.2f} us; behind ~50 ms of queued device "
        "work " + ", ".join(f"{n} {t:.2f} us"
                            for n, t in us["queued_us"].items())
        + f"; encoding the forward's three tensor maps {us['encode_ns']:.1f} "
        "ns")
    return us


def _flash_timing(gen, case, iters, dtype="torch.bfloat16") -> dict:
    """Each flash kernel at one case's shape, key mask and dtype, first
    held against its plain version (``_flash_check``), then timed beside
    its plain version and bound (device time, 4 input sets in rotation
    past the 50 MB L2; the backward fed the plain forward's lse and delta),
    with the library calls the port never makes as yardsticks, device-timed
    too: SDPA's forward for ``flash_fwd`` (the KV heads repeated for GQA, a
    key mask as a boolean ``attn_mask``), and for the backward pair the
    aten flash backward, one call that computes dq, dk and dv from the same
    (dO, q, k, v, o, lse), or under a key mask, which it does not take,
    masked SDPA's autograd backward."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    name, B, H, KV, S, hd, causal, mask_kind = case[:8]
    dtype = getattr(torch, dtype.split(".")[1])
    tag = (f"{name} B{B} H{H} KV{KV} S{S} hd{hd} "
           f"{'causal' if causal else 'full'}"
           f"{', key mask' if mask_kind else ''}")
    sets = [_flash_case(gen, B, H, KV, S, hd, causal, mask_kind, False, dtype,
                        "cuda") for _ in range(4)]
    errs = _flash_check(tag, sets[0], dtype)
    for x in sets:
        o, lse = fa.flash_attention_fwd_plain(x["q"], x["k"], x["v"],
                                              mask=x["mask"], causal=causal)
        x.update(lse=lse, delta=fa.attention_delta(o, x["do"]))
    fwd = lambda i: tuple(sets[i % 4][n] for n in "qkv")        # noqa: E731
    bwd = lambda i: tuple(sets[i % 4][n] for n in (             # noqa: E731
        "q", "k", "v", "do", "lse", "delta"))
    kw = lambda i: dict(mask=sets[i % 4]["mask"], causal=causal)  # noqa
    calls = {"flash_fwd": (fa.flash_fwd, fa.flash_attention_fwd_plain, fwd),
             "flash_bwd_dq": (fa.flash_bwd_dq, fa.flash_bwd_dq_plain, bwd),
             "flash_bwd_dkv": (fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain, bwd)}
    bounds = flash_bound(B, H, KV, S, hd, causal, dtype.itemsize,
                         side_bytes=B * S if mask_kind else 0,
                         dtype=str(dtype))
    # the library's inputs: (B, H, S, hd), each KV head repeated for its
    # query heads (enable_gqa needs a newer torch); leaves for autograd
    # under a key mask
    tq = [tuple(t.repeat_interleave(H // t.shape[2], 2).transpose(1, 2)
                .contiguous().requires_grad_(mask_kind is not None)
                for t in fwd(i)) for i in range(4)]
    gdo = [s["do"].transpose(1, 2).contiguous() for s in sets]
    am = [None if s["mask"] is None else s["mask"][:, None, None, :]
          for s in sets]

    def lib_fwd(i):
        return F.scaled_dot_product_attention(
            *tq[i % 4], attn_mask=am[i % 4], is_causal=causal)

    if mask_kind is None:
        sdpa_fwd = device_ms(lib_fwd, 4, iters)
        aten = torch.ops.aten
        fw = [aten._scaled_dot_product_flash_attention(*tq[i], 0.0, causal,
                                                       False)
              for i in range(4)]

        def lib_bwd(i):
            f = fw[i % 4]
            return aten._scaled_dot_product_flash_attention_backward(
                gdo[i % 4], *tq[i % 4], f[0], f[1], f[2], f[3], f[4], f[5],
                0.0, causal, f[6], f[7])

        sdpa_bwd = device_ms(lib_bwd, 4, iters)
        what = "the aten flash backward (dq, dk and dv in one call)"
    else:
        sdpa_fwd, sdpa_bwd = _library_ms(
            lib_fwd, lambda i: torch.autograd.grad(lib_fwd(i), tq[i % 4],
                                                   gdo[i % 4]), iters)
        what = "masked SDPA's autograd backward"
    library = {"flash_fwd": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
               "flash_bwd_dkv": sdpa_bwd}
    out = {}
    for n, (kern, plain, args) in calls.items():
        ms = device_ms(lambda i: kern(*args(i), **kw(i)), 4, iters)
        plain_ms = time_ms(lambda i: plain(*args(i), **kw(i)),
                           max(iters // 10, 3))
        b = bounds[n]
        out[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                      bound_by=b["bound_by"], library_ms=library[n],
                      max_abs_err=errs[n])
        log(f"[flash] {n} {tag} {dtype}: kernel {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, bound {b['bound_ms'] * 1e3:.2f} us "
            f"({b['bound_by']}: {b['bytes']} B, {b['ops']:.4g} flop), kernel "
            f"at {b['bound_ms'] / ms:.1%} of the bound")
    pair = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    log(f"[flash] {tag} {dtype} library calls (device, not called by the "
        f"port): SDPA forward {sdpa_fwd * 1e3:.2f} us vs flash_fwd "
        f"{out['flash_fwd']['ms'] * 1e3:.2f} us; {what} "
        f"{sdpa_bwd * 1e3:.2f} us vs flash_bwd_dq + flash_bwd_dkv "
        f"{pair * 1e3:.2f} us ({pair / sdpa_bwd:.2f}x)")
    del sets, tq, gdo
    return out


# ------------------------------------------------------- phase 5b, xent
# (name, T, V, d, bias): GPT-2 1.5B's head (micro-batch 4 x 1023 shifted
# tokens), BERT-large's MLM head (16 x 512 tokens, decoder bias), then the
# edges: nothing divides a tile, one token, a d that two clusters of the
# backward share unevenly (blocks past d), the widest eligible d
XENT_CASES = (
    ("gpt2_1.5b", 4092, 50257, 1600, False),
    ("bert_large", 8192, 30522, 1024, True),
    ("ragged", 77, 1000, 64, True),
    ("one_token", 1, 1000, 64, False),
    ("d_2304", 300, 3000, 2304, True),
    ("d_6144", 256, 2000, 6144, True),
)
# kernel vs plain as shares of max |plain|. nll, lse and db are fp32 sums of
# the same bf16 products in another order, with __expf (ex2.approx, ~2 ulp)
# in the kernels; dx and dW are bf16: dl is rounded to bf16 before both
# products on both sides and the result once more, a few ulps (2^-8) at the
# top of each tensor. A wrong tile, mask or onehot gives O(1).
XENT_TOL_SHARE = {"nll": 1e-4, "lse": 1e-4, "dx": 2e-2, "dw": 2e-2,
                  "db": 1e-3}
# the 4-way hand split of a padded NeoX-size vocab: 12576 rows a shard
XENT_TP_VOCAB, XENT_TP_SHARDS = 50304, 4


def _xent_case(gen, T, V, d, bias, dtype, device):
    """Operands with the awkward rows set: a target in the last valid
    column, one past the vocab, a negative one, and every 7th g at 0."""
    import torch

    mk = partial(torch.randn, generator=gen, device=device)
    x = mk((T, d)).to(dtype)
    w = (mk((V, d)) * 0.05).to(dtype)
    b = (mk((V,)) * 0.5).to(dtype) if bias else None
    t = torch.randint(0, V, (T,), generator=gen, device=device,
                      dtype=torch.int32)
    t[0] = V - 1
    if T > 2:
        t[1], t[2] = V + 3, -5
    g = mk((T,)) / T
    g[::7] = 0.0
    return x, w, b, t, g


def xent_bound(T, V, d, bias: bool) -> dict:
    """Least time of each kernel on an H100: 2 T V d FLOPs for the
    forward, 4 T V d for dx and for dW (one recompute of the logits and
    one product) at 989 TFLOP/s, against each input read and each output
    written once at 3.35 TB/s."""
    base = 2 * (T * d + V * d) + (2 * V if bias else 0) + 4 * T
    work = {"xent_fwd": (2 * T * V * d, base + 8 * T),
            "xent_dx": (4 * T * V * d, base + 8 * T + 2 * T * d),
            "xent_dw": (4 * T * V * d, base + 8 * T + 2 * V * d + 4 * V)}
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_OPS_PER_S["torch.bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes), "ops": ops,
                     "bytes": nbytes, "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
    return out


def phase_xent_kernels(device="cuda", cases=XENT_CASES, dtype=None,
                       tp_vocab=XENT_TP_VOCAB, iters=20) -> dict:
    """The three xent kernels against their plain versions on every case
    (the backward kernels fed the plain forward's lse), the ``partials``
    mode on each shard of a hand split of the vocab, combined by hand and
    held against the full forward; on the card, timed at the first (GPT-2
    1.5B's) shape beside the bound, the plain versions and the library."""
    import torch

    from deepspeed_tpu_torch.ops import xent as xe

    gen = torch.Generator(device=device).manual_seed(9)
    dtype = dtype or torch.bfloat16
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    names = ("xent_fwd", "xent_dx", "xent_dw")
    worst = dict.fromkeys(names, 0.0)
    for name, T, V, d, bias in cases:
        x, w, b, t, g = _xent_case(gen, T, V, d, bias, dtype, device)
        nll_p, lse_p = xe.xent_fwd_plain(x, w, b, t)
        dx_p, dw_p, db_p = xe.xent_bwd_plain(x, w, b, t, lse_p, g)
        nll, lse = xe.xent_fwd(x, w, b, t)
        dx = xe.xent_dx(x, w, b, t, lse_p, g)
        dw, db = xe.xent_dw(x, w, b, t, lse_p, g)
        sync()
        pairs = {"nll": (nll, nll_p), "lse": (lse, lse_p), "dx": (dx, dx_p),
                 "dw": (dw, dw_p), "db": (db, db_p)}
        shares = {k: _share(a, r) for k, (a, r) in pairs.items()}
        finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs.values())
        # masked rows take exactly no gradient; a target past the vocab or
        # below 0 leaves nll = lse
        exact = not bool(dx[::7].any()) and (
            T <= 2 or bool((nll[1:3] == lse[1:3]).all()))
        ok = finite and exact and all(shares[k] <= XENT_TOL_SHARE[k]
                                      for k in shares)
        log(f"[xent] {name:11s} T{T} V{V} d{d} bias {bias} {dtype}: "
            + ", ".join(f"{k} {v:.2e}" for k, v in shares.items())
            + f" of max |plain| (tol {XENT_TOL_SHARE}); g=0 rows and "
            f"out-of-vocab targets exact {exact} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"xent {name}: {shares}, finite {finite}, "
                                 f"exact {exact}")
        for n, keys in (("xent_fwd", ("nll", "lse")), ("xent_dx", ("dx",)),
                        ("xent_dw", ("dw", "db"))):
            for k in keys:
                a, r = pairs[k]
                worst[n] = max(worst[n],
                               (a.float() - r.float()).abs().max().item())
        del x, w, b, dx, dw, dx_p, dw_p, pairs

    # partials: each shard of the hand split, then the combine of
    # ``_fwd_tp`` (max, sum-exp, sum) against the full forward
    T, d = cases[0][1], cases[0][3]
    x, w, b, t, _ = _xent_case(gen, T, tp_vocab, d, True, dtype, device)
    t[1], t[2] = tp_vocab - 2, 5                    # global ids: all valid
    vs = tp_vocab // XENT_TP_SHARDS
    tgts, lses = [], []
    for s in range(XENT_TP_SHARDS):
        sl = slice(s * vs, (s + 1) * vs)
        t_loc = (t - s * vs).to(torch.int32)
        got = xe.xent_fwd(x, w[sl].contiguous(), b[sl], t_loc, partials=True)
        want = xe.xent_fwd_plain(x, w[sl], b[sl], t_loc, partials=True)
        foreign = (t_loc < 0) | (t_loc >= vs)
        sh = [_share(a, r) for a, r in zip(got, want)]
        ok = max(sh) <= XENT_TOL_SHARE["nll"] \
            and not bool(got[0][foreign].any())
        log(f"[xent] partials shard {s} of {XENT_TP_SHARDS} (V {vs}, "
            f"{int(foreign.sum())} of {T} targets foreign): target logit "
            f"{sh[0]:.2e}, lse {sh[1]:.2e} of max |plain|; foreign targets "
            f"contribute 0 {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"xent partials shard {s}: {sh}")
        tgts.append(got[0])
        lses.append(got[1])
        worst["xent_fwd"] = max(worst["xent_fwd"], *(
            (a - r).abs().max().item() for a, r in zip(got, want)))
    lse_l = torch.stack(lses)
    m_g = lse_l.amax(0)
    lse_g = m_g + torch.log(torch.exp(lse_l - m_g).sum(0))
    nll_g = lse_g - torch.stack(tgts).sum(0)
    nll_f, lse_f = xe.xent_fwd(x, w, b, t)
    sh = (_share(nll_g, nll_f), _share(lse_g, lse_f))
    log(f"[xent] partials combined by hand vs the full forward (V "
        f"{tp_vocab}): nll {sh[0]:.2e}, lse {sh[1]:.2e} (tol "
        f"{XENT_TOL_SHARE['nll']})")
    if max(sh) > XENT_TOL_SHARE["nll"]:
        raise AssertionError(f"xent partials combine: {sh}")
    del x, w, b
    result = {n: {"max_abs_err": worst[n]} for n in names}
    if device != "cuda":
        return result
    timing = _xent_timing(gen, cases[0], iters)
    for n in names:
        result[n].update(timing[n])
    return result


def _xent_timing(gen, case, iters) -> dict:
    """Kernel, plain and bound of each xent kernel at one case's shape in
    bf16 (device time, 2 operand sets in rotation: one table alone passes
    the 50 MB L2), with the library calls the port never makes, device-timed
    too: ``F.cross_entropy(F.linear(x, w, b).float(), t)`` for the forward,
    and its autograd backward (forward + backward captured together, minus
    the forward) against ``xent_dx`` + ``xent_dw`` together."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import xent as xe

    name, T, V, d, bias = case
    sets = []
    for _ in range(2):
        x, w, b, t, g = _xent_case(gen, T, V, d, bias, torch.bfloat16, "cuda")
        lse = xe.xent_fwd_plain(x, w, b, t)[1]
        sets.append((x, w, b, t, lse, g))
    fw = lambda i: sets[i % 2][:4]                               # noqa: E731
    calls = {"xent_fwd": lambda i: xe.xent_fwd(*fw(i)),
             "xent_dx": lambda i: xe.xent_dx(*sets[i % 2]),
             "xent_dw": lambda i: xe.xent_dw(*sets[i % 2])}
    plain = {"xent_fwd": lambda i: xe.xent_fwd_plain(*fw(i)),
             "xent_dx": lambda i: xe.xent_bwd_plain(*sets[i % 2])}
    plain_ms = {k: time_ms(f, max(iters // 10, 3)) for k, f in plain.items()}
    plain_ms["xent_dw"] = plain_ms["xent_dx"]   # one call computes both

    leaves = [tuple(a.detach().clone().requires_grad_() if a is not None
                    else None for a in s[:3]) for s in sets]
    tl = [s[3].long().clamp(0, V - 1) for s in sets]

    def lib_fwd(i):
        a = leaves[i % 2]
        return F.cross_entropy(F.linear(*a).float(), tl[i % 2],
                               reduction="none")

    def lib_fwd_bwd(i):
        a = [v for v in leaves[i % 2] if v is not None]
        return torch.autograd.grad(lib_fwd(i), a, sets[i % 2][5])

    with torch.no_grad():
        lib_f = device_ms(lib_fwd, 2, iters)
    lib_b = device_ms(lib_fwd_bwd, 2, iters) - lib_f
    library = {"xent_fwd": lib_f, "xent_dx": lib_b, "xent_dw": lib_b}
    bounds = xent_bound(T, V, d, bias)
    out = {}
    for n, kern in calls.items():
        ms = device_ms(kern, 2, iters)
        b = bounds[n]
        out[n] = dict(ms=ms, plain_ms=plain_ms[n], bound_ms=b["bound_ms"],
                      bound_by=b["bound_by"], library_ms=library[n])
        log(f"[xent] {n} {name} T{T} V{V} d{d} bf16: kernel {ms * 1e3:.2f} us,"
            f" plain {plain_ms[n] * 1e3:.2f} us, bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}: {b['bytes']} B, "
            f"{b['ops']:.4g} flop), kernel at {b['bound_ms'] / ms:.1%} of the "
            "bound")
    log(f"[xent] {name} library calls (device, not called by the port): "
        f"F.cross_entropy(F.linear(x, w).float()) forward {lib_f * 1e3:.2f} "
        f"us vs xent_fwd {out['xent_fwd']['ms'] * 1e3:.2f} us; its autograd "
        f"backward (dx and dW in one pass) {lib_b * 1e3:.2f} us vs xent_dx + "
        f"xent_dw {(out['xent_dx']['ms'] + out['xent_dw']['ms']) * 1e3:.2f} "
        "us; plain backward = one xent_bwd_plain call for dx, dW and db")
    del sets, leaves
    return out


# ------------------------------------------------------- phase 5c, sparse
# (name, B, H, KV, S, hd, causal, config class, its fields): the slice's
# shape first (GPT-2 1.5B's heads at 8192 tokens under the default Fixed
# layout); then each layout at its defaults (block 64), causal and not;
# blocks 16, 32 and 128; hd 128 and 16; GQA and MQA; one block (S ==
# block); a layout whose global row keeps every block and whose other rows
# keep one or two without block 0, so a kernel that read its lists past
# k_n / q_n (whose padding is 0, a valid index) would add block 0
SPARSE_CASES = (
    ("gpt2_1.5b_8192", 1, 25, 25, 8192, 64, True, "FixedSparsityConfig", {}),
    ("dense", 2, 4, 4, 1024, 64, True, "SparsityConfig", {}),
    ("dense_full", 2, 4, 4, 1024, 64, False, "SparsityConfig", {}),
    ("fixed", 2, 4, 4, 1024, 64, True, "FixedSparsityConfig", {}),
    ("fixed_full", 2, 4, 4, 1024, 64, False, "FixedSparsityConfig", {}),
    ("variable", 2, 4, 4, 1024, 64, True, "VariableSparsityConfig", {}),
    ("variable_full", 2, 4, 4, 1024, 64, False, "VariableSparsityConfig", {}),
    ("bigbird", 2, 4, 4, 1024, 64, True, "BigBirdSparsityConfig", {}),
    ("bigbird_full", 2, 4, 4, 1024, 64, False, "BigBirdSparsityConfig", {}),
    ("longformer", 2, 4, 4, 1024, 64, True, "BSLongformerSparsityConfig",
     {}),
    ("longformer_full", 2, 4, 4, 1024, 64, False,
     "BSLongformerSparsityConfig", {}),
    ("fixed_block16", 2, 4, 4, 1024, 64, True, "FixedSparsityConfig",
     {"block": 16}),
    ("bigbird_block32_full", 2, 4, 4, 1024, 64, False,
     "BigBirdSparsityConfig", {"block": 32, "num_random_blocks": 2}),
    ("fixed_block128", 1, 4, 4, 2048, 64, True, "FixedSparsityConfig",
     {"block": 128}),
    ("longformer_block16_full", 1, 4, 4, 512, 32, False,
     "BSLongformerSparsityConfig", {"block": 16}),
    ("fixed_hd128", 1, 8, 8, 2048, 128, True, "FixedSparsityConfig", {}),
    ("fixed_hd128_block128", 1, 4, 4, 1024, 128, True, "FixedSparsityConfig",
     {"block": 128}),
    ("variable_hd16_block32", 2, 4, 4, 256, 16, True,
     "VariableSparsityConfig", {"block": 32}),
    ("fixed_gqa", 1, 8, 2, 2048, 64, True, "FixedSparsityConfig", {}),
    ("bigbird_mqa_full", 1, 8, 1, 1024, 128, False, "BigBirdSparsityConfig",
     {}),
    ("one_block", 2, 4, 4, 64, 64, True, "FixedSparsityConfig", {}),
    ("one_block16_full", 2, 4, 4, 16, 32, False, "SparsityConfig",
     {"block": 16}),
    ("wide_vs_narrow", 1, 4, 4, 1024, 64, True, "BSLongformerSparsityConfig",
     {"num_sliding_window_blocks": 1, "global_block_indices": (15,)}),
    ("wide_vs_narrow_full", 1, 4, 4, 1024, 64, False,
     "BSLongformerSparsityConfig",
     {"num_sliding_window_blocks": 1, "global_block_indices": (15,)}),
)
# the dense layout through the sparse kernels against the flash kernels on
# the same inputs, (name, B, H, KV, S, hd, causal): the same function, so
# phase 5's tolerances
SPARSE_VS_FLASH = (("dense_vs_flash", 1, 25, 25, 2048, 64, True),
                   ("dense_vs_flash_gqa_full", 2, 4, 2, 1024, 128, False))
SPARSE_NAMES = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")


def _sparse_config(cls: str, fields: dict):
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    return getattr(sa, cls)(**fields)


def sparse_bound(layout, B, H, KV, hd, esize) -> dict:
    """Least time of each sparse kernel on an H100: the kept (q, k)
    elements (``layout.kept_elements()``: b² per off-diagonal pair, b(b+1)/2
    per diagonal pair when causal) times 2·hd flop for each of 2 (forward),
    3 (dq) or 4 (dk/dv) products at 989 TFLOP/s, against each input (the
    lists included) read and each output written once at 3.35 TB/s."""
    S = layout.seq
    prod = 2 * B * H * hd * layout.kept_elements()
    qb, kvb, rowb = B * S * H * hd * esize, B * S * KV * hd * esize, B * H * S * 4
    kl = 4 * (layout.k_idx.numel() + 2 * layout.k_n.numel())
    ql = 4 * (layout.q_idx.numel() + 2 * layout.q_n.numel())
    work = {"sparse_fwd": (2 * prod, 2 * qb + 2 * kvb + rowb + kl),
            "sparse_bwd_dq": (3 * prod, 3 * qb + 2 * kvb + 2 * rowb + kl),
            "sparse_bwd_dkv": (4 * prod, 2 * qb + 4 * kvb + 2 * rowb + ql)}
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_OPS_PER_S["torch.bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes), "ops": ops,
                     "bytes": nbytes, "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
    return out


def _qkv_do(gen, B, H, KV, S, hd, dtype, device):
    x = _flash_case(gen, B, H, KV, S, hd, True, None, False, dtype, device)
    return x["q"], x["k"], x["v"], x["do"]


def _check_shares(tag, got: dict, want: dict, lse, lse_want, dtype) -> dict:
    """Max |Δ| / max |want| of each tensor within phase 5's tolerance and
    the lse within FLASH_LSE_ATOL; raises otherwise. Returns the max |Δ|
    of each tensor."""
    import torch

    shares = {n: _share(got[n], want[n]) for n in want}
    lse_err = (lse - lse_want).abs().max().item()
    tol = FLASH_TOL_SHARE.get(str(dtype), 1e-5)
    finite = all(bool(torch.isfinite(t).all()) for t in (*got.values(), lse))
    ok = finite and lse_err <= FLASH_LSE_ATOL and all(
        s <= tol for s in shares.values())
    log(f"{tag}: " + ", ".join(f"{n} {s:.2e}" for n, s in shares.items())
        + f" of max |reference| (tol {tol:g}); lse {lse_err:.1e} (tol "
        f"{FLASH_LSE_ATOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: {shares}, lse {lse_err}, finite "
                             f"{finite}")
    return {n: (got[n].float() - want[n].float()).abs().max().item()
            for n in want}


def phase_sparse_kernels(device="cuda", cases=SPARSE_CASES,
                         vs_flash=SPARSE_VS_FLASH, dtypes=None,
                         iters=20) -> dict:
    """The three sparse kernels against their plain versions on every case
    in bf16 and fp16, the backward kernels fed the plain forward's lse and
    delta; the dense layout through them against the flash kernels; on the
    card, timed at the first (the slice's) shape."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    gen = torch.Generator(device=device).manual_seed(6)
    dtypes = dtypes or (torch.bfloat16, torch.float16)
    worst = dict.fromkeys(SPARSE_NAMES, 0.0)

    def note(errs):
        for n, key in (("sparse_fwd", "o"), ("sparse_bwd_dq", "dq"),
                       ("sparse_bwd_dkv", "dk"), ("sparse_bwd_dkv", "dv")):
            worst[n] = max(worst[n], errs[key])

    for name, B, H, KV, S, hd, causal, cls, fields in cases:
        cfg = _sparse_config(cls, fields)
        layout = sa.sparse_layout(cfg, S, causal, device)
        widths = layout.k_n.tolist()
        for dtype in dtypes:
            q, k, v, do = _qkv_do(gen, B, H, KV, S, hd, dtype, device)
            o_p, lse_p = sa.sparse_attention_fwd_plain(q, k, v, layout)
            delta = fa.attention_delta(o_p, do)
            want = {"o": o_p,
                    "dq": sa.sparse_bwd_dq_plain(q, k, v, do, lse_p, delta,
                                                 layout)}
            want["dk"], want["dv"] = sa.sparse_bwd_dkv_plain(
                q, k, v, do, lse_p, delta, layout)
            o, lse = sa.sparse_fwd(q, k, v, layout)
            got = {"o": o,
                   "dq": sa.sparse_bwd_dq(q, k, v, do, lse_p, delta, layout)}
            got["dk"], got["dv"] = sa.sparse_bwd_dkv(q, k, v, do, lse_p,
                                                     delta, layout)
            if device == "cuda":
                torch.cuda.synchronize()
            note(_check_shares(
                f"[sparse] {name:24s} {str(dtype):15s} B{B} H{H} KV{KV} S{S} "
                f"hd{hd} block {cfg.block} {'causal' if causal else 'full'}, "
                f"lists {min(widths)}-{max(widths)} wide", got, want, lse,
                lse_p, dtype))
            del q, k, v, do, o_p, lse_p, delta, want, got, o, lse
    # the dense layout is the function the flash kernels compute
    for name, B, H, KV, S, hd, causal in vs_flash:
        layout = sa.sparse_layout(sa.SparsityConfig(), S, causal, device)
        for dtype in dtypes:
            q, k, v, do = _qkv_do(gen, B, H, KV, S, hd, dtype, device)
            o_f, lse_f = fa.flash_fwd(q, k, v, causal=causal)
            delta = fa.attention_delta(o_f, do)
            want = {"o": o_f, "dq": fa.flash_bwd_dq(q, k, v, do, lse_f, delta,
                                                    causal=causal)}
            want["dk"], want["dv"] = fa.flash_bwd_dkv(q, k, v, do, lse_f,
                                                      delta, causal=causal)
            o, lse = sa.sparse_fwd(q, k, v, layout)
            got = {"o": o,
                   "dq": sa.sparse_bwd_dq(q, k, v, do, lse_f, delta, layout)}
            got["dk"], got["dv"] = sa.sparse_bwd_dkv(q, k, v, do, lse_f,
                                                     delta, layout)
            if device == "cuda":
                torch.cuda.synchronize()
            same = all(torch.equal(got[n], want[n]) for n in want) \
                and torch.equal(lse, lse_f)
            _check_shares(f"[sparse] {name:24s} {str(dtype):15s} B{B} H{H} "
                          f"KV{KV} S{S} hd{hd} vs the flash kernels (bit for "
                          f"bit: {same})", got, want, lse, lse_f, dtype)
            del q, k, v, do, o_f, lse_f, delta, want, got, o, lse
    result = {n: {"max_abs_err": worst[n]} for n in SPARSE_NAMES}
    if device != "cuda":
        return result
    main = _sparse_timing(gen, cases[0], iters)
    for n in SPARSE_NAMES:
        result[n].update(main[n])
    return result


def _sparse_timing(gen, case, iters) -> dict:
    """Kernel, plain and bound of each sparse kernel at one case's shape in
    bf16 (device time, 4 input sets in rotation past the 50 MB L2), with
    yardsticks the port never calls, device-timed too: SDPA with the layout
    expanded to an (S, S) boolean mask (its forward, and its autograd
    backward against ``sparse_bwd_dq`` + ``sparse_bwd_dkv`` together), the
    port's flash kernels on the dense causal problem at the same shape, and
    the sparse kernels launched in natural block order instead of widest
    list first."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    name, B, H, KV, S, hd, causal, cls, fields = case
    cfg = _sparse_config(cls, fields)
    layout = sa.sparse_layout(cfg, S, causal, "cuda")
    sets = []
    for _ in range(4):
        q, k, v, do = _qkv_do(gen, B, H, KV, S, hd, torch.bfloat16, "cuda")
        o, lse = sa.sparse_fwd(q, k, v, layout)
        sets.append(dict(q=q, k=k, v=v, do=do, lse=lse,
                         delta=fa.attention_delta(o, do)))
    args = lambda i: tuple(sets[i % 4][n] for n in "qkv")       # noqa: E731
    bwd = lambda i: (*args(i), *(sets[i % 4][n]                 # noqa: E731
                                 for n in ("do", "lse", "delta")))

    def kernels(lay):
        return {"sparse_fwd": lambda i: sa.sparse_fwd(*args(i), lay),
                "sparse_bwd_dq": lambda i: sa.sparse_bwd_dq(*bwd(i), lay),
                "sparse_bwd_dkv": lambda i: sa.sparse_bwd_dkv(*bwd(i), lay)}

    plain = {"sparse_fwd": lambda i: sa.sparse_attention_fwd_plain(
                 *args(i), layout),
             "sparse_bwd_dq": lambda i: sa.sparse_bwd_dq_plain(*bwd(i), layout),
             "sparse_bwd_dkv": lambda i: sa.sparse_bwd_dkv_plain(*bwd(i),
                                                                 layout)}
    flash = {"sparse_fwd": lambda i: fa.flash_fwd(*args(i), causal=causal),
             "sparse_bwd_dq": lambda i: fa.flash_bwd_dq(*bwd(i),
                                                        causal=causal),
             "sparse_bwd_dkv": lambda i: fa.flash_bwd_dkv(*bwd(i),
                                                          causal=causal)}
    natural = dataclasses.replace(
        layout, q_order=torch.arange(S // cfg.block, dtype=torch.int32,
                                     device="cuda"),
        k_order=torch.arange(S // cfg.block, dtype=torch.int32,
                             device="cuda"))
    # the library: SDPA under the expanded mask (causal folded in), the
    # KV heads repeated for GQA
    mask = layout.keep("cuda")
    if causal:
        mask = mask & torch.ones((S, S), dtype=torch.bool, device="cuda").tril()
    rep = lambda t: t.repeat_interleave(H // KV, 2) if KV != H else t  # noqa
    leaves = [tuple(rep(t).transpose(1, 2).contiguous().requires_grad_()
                    for t in args(i)) for i in range(4)]
    gdo = [s["do"].transpose(1, 2).contiguous() for s in sets]

    def lib_fwd(i):
        return F.scaled_dot_product_attention(*leaves[i % 4], attn_mask=mask)

    def lib_fwd_bwd(i):
        return torch.autograd.grad(lib_fwd(i), leaves[i % 4], gdo[i % 4])

    with torch.no_grad():
        lib_f = device_ms(lib_fwd, 4, iters)
    lib_b = device_ms(lib_fwd_bwd, 4, iters) - lib_f
    library = {"sparse_fwd": lib_f, "sparse_bwd_dq": lib_b,
               "sparse_bwd_dkv": lib_b}
    bounds = sparse_bound(layout, B, H, KV, hd, 2)
    dense = flash_bound(B, H, KV, S, hd, causal, 2)
    kept = layout.kept_elements() / (S * (S + 1) // 2 if causal else S * S)
    out = {}
    lpt, nat = kernels(layout), kernels(natural)
    for n in SPARSE_NAMES:
        ms = device_ms(lpt[n], 4, iters)
        ms_nat = device_ms(nat[n], 4, iters)
        flash_ms = device_ms(flash[n], 4, iters)
        plain_ms = time_ms(plain[n], 3)
        b, fb = bounds[n], dense["flash_" + n.split("_", 1)[1]]
        out[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                      bound_by=b["bound_by"], library_ms=library[n],
                      natural_order_ms=ms_nat, flash_dense_ms=flash_ms,
                      flash_dense_bound_ms=fb["bound_ms"])
        log(f"[sparse] {n} {name} B{B} H{H} KV{KV} S{S} hd{hd} block "
            f"{cfg.block} {'causal' if causal else 'full'} bf16: kernel "
            f"{ms * 1e3:.2f} us (natural block order {ms_nat * 1e3:.2f} us), "
            f"plain {plain_ms * 1e3:.2f} us, bound {b['bound_ms'] * 1e3:.2f} us"
            f" ({b['bound_by']}: {b['bytes']} B, {b['ops']:.4g} flop), kernel "
            f"at {b['bound_ms'] / ms:.1%} of the bound; the flash kernel on the "
            f"dense problem {flash_ms * 1e3:.2f} us (bound "
            f"{fb['bound_ms'] * 1e3:.2f} us), sparse / dense "
            f"{ms / flash_ms:.3f} for {kept:.1%} of the elements")
    bwd_ms = out["sparse_bwd_dq"]["ms"] + out["sparse_bwd_dkv"]["ms"]
    log(f"[sparse] {name} library calls (device, not called by the port): "
        f"SDPA with the (S, S) boolean mask, forward {lib_f * 1e3:.2f} us vs "
        f"sparse_fwd {out['sparse_fwd']['ms'] * 1e3:.2f} us; its autograd "
        f"backward (dq, dk and dv in one pass) {lib_b * 1e3:.2f} us vs "
        f"sparse_bwd_dq + sparse_bwd_dkv {bwd_ms * 1e3:.2f} us")
    del sets, leaves, gdo, mask
    return out


# ------------------------------------------------ phase 5d, bias and fp32
# (name, B, H, KV, S, hd, causal, mask kind, bias layout, bias dtype): the
# shapes phase 10 trains first (AlphaFold 2's MSA rows with the pair bias
# shared by every row; the DS4Science example's full bias); then every
# layout of the bias ("expanded" is a (1, H, S, S) tensor expanded to (B,
# H, S, S), the stride-0 view a learned broadcast bias reaches the kernels
# as), S past a tile, GQA and MQA, hd 16 to 128, masks with dead rows and a
# bias dtype other than q's; each case runs in bf16, fp16 and fp32 q
FLASH_BIAS_CASES = (
    ("af2_msa_row", 128, 8, 8, 256, 32, False, "af2_pad", "1hss",
     "torch.bfloat16"),
    ("evoformer_example", 4, 8, 8, 256, 32, False, None, "bhss",
     "torch.float32"),
    ("ss_causal_gqa", 2, 4, 2, 333, 64, True, None, "ss", "torch.float32"),
    ("hss_full", 2, 4, 2, 333, 64, False, None, "hss", "torch.bfloat16"),
    ("bhss_causal_mask", 2, 4, 4, 200, 32, True, "left_pad", "bhss",
     "torch.float16"),
    ("b1ss_dead_rows", 2, 4, 4, 200, 32, False, "dead_row", "b1ss",
     "torch.float32"),
    ("expanded_causal", 3, 8, 8, 256, 32, True, None, "expanded",
     "torch.bfloat16"),
    ("hd16_mqa", 1, 4, 1, 130, 16, True, None, "bhss", "torch.float32"),
    ("hd128", 2, 2, 2, 96, 128, False, None, "bhss", "torch.bfloat16"),
    ("hd128_long_hss", 1, 4, 4, 1024, 128, True, "left_pad", "hss",
     "torch.float32"),
)
# the residues past 230 of AlphaFold's 256-residue crop are padding
AF2_LIVE = 230
# kernel vs plain, max |Δ| / max |plain| of o, dq, dk, dv and dbias: phase
# 5's for bf16 / fp16; fp32 operands go through 3xTF32 products (~2^-22 of
# each term, fp32 sums in another order) and __expf (~2 ulp)
FLASH_BIAS_TOL_SHARE = {**FLASH_TOL_SHARE, "torch.float32": 1e-4}
# dbias is rounded to the bias's dtype on both sides: where that dtype is
# coarser than q's tolerance, one ulp of it (relative: at most 2^-7 for
# bf16, 2^-10 for fp16) bounds dbias's difference
DBIAS_ROUNDING = {"torch.bfloat16": 2.0 ** -7, "torch.float16": 2.0 ** -10,
                  "torch.float32": 0.0}


def _bias_tensor(gen, layout, B, H, S, dtype, device):
    import torch

    shape = {"ss": (S, S), "hss": (H, S, S), "bhss": (B, H, S, S),
             "b1ss": (B, 1, S, S), "1hss": (1, H, S, S),
             "expanded": (1, H, S, S)}[layout]
    bias = (2 * torch.randn(shape, generator=gen, device=device)).to(dtype)
    return bias.expand(B, H, S, S) if layout == "expanded" else bias


def _bias_case(gen, case, dtype, device):
    """Inputs of one phase 5d case: the flash inputs, the bias and the
    key mask (``af2_pad``: every row's residues past AF2_LIVE padded)."""
    import torch

    name, B, H, KV, S, hd, causal, mask_kind, layout, bias_dtype = case
    x = _flash_case(gen, B, H, KV, S, hd, causal,
                    None if mask_kind == "af2_pad" else mask_kind, False,
                    dtype, device)
    if mask_kind == "af2_pad":
        x["mask"] = torch.ones((B, S), dtype=torch.bool, device=device)
        x["mask"][:, AF2_LIVE:] = False
    x["bias"] = _bias_tensor(gen, layout, B, H, S,
                             getattr(torch, bias_dtype.split(".")[1]), device)
    return x


def phase_flash_bias_kernels(device="cuda", cases=FLASH_BIAS_CASES,
                             fp32_cases=FLASH_CASES, dtypes=None,
                             iters=50) -> dict:
    """The three flash kernels with the bias operand against their plain
    versions on every case, in bf16, fp16 and fp32, each fed the plain
    forward's lse and delta; dq twice, once as the kernels read the bias
    and once with dbias, the bias expanded to (B, H, S, S) where it is
    broadcast (as a learned one reaches the kernels); dbias exactly 0
    above a causal diagonal. Then the fp32 kernels without a bias on phase
    5's cases. On the card, timed at the first two cases' shapes and the
    fp32 kernels at GPT-2 1.5B's (phase 5's first case)."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(6)
    dtypes = dtypes or (torch.bfloat16, torch.float16, torch.float32)
    # max |kernel - plain| of each kernel's outputs, over the biased runs
    # (every dtype) and over the fp32 runs without a bias
    worst = {v: dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv"), 0.0)
             for v in ("bias", "fp32")}
    for case in cases:
        name, B, H, KV, S = case[:5]
        causal = case[6]
        for dtype in dtypes:
            x = _bias_case(gen, case, dtype, device)
            q, k, v, do, bias = x["q"], x["k"], x["v"], x["do"], x["bias"]
            kw = dict(mask=x["mask"], causal=causal, bias=bias)
            full = dict(kw, bias=fa.bias4(bias, B, H, S).expand(B, H, S, S))
            o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
            delta = fa.attention_delta(o_p, do)
            dq_p, dbias_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta,
                                                  grad_bias=True, **full)
            dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                                **kw)
            o, lse = fa.flash_fwd(q, k, v, **kw)
            dq = fa.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw)
            dq2, dbias = fa.flash_bwd_dq(q, k, v, do, lse_p, delta,
                                         grad_bias=True, **full)
            dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            live = lse_p > fa.BIG_NEG / 2
            lse_err = (lse - lse_p).abs()[live].max().item()
            got = {"o": (o, o_p), "dq": (dq, dq_p), "dk": (dk, dk_p),
                   "dv": (dv, dv_p), "dbias": (dbias, dbias_p)}
            shares = {n: _share(a, b) for n, (a, b) in got.items()}
            tol = FLASH_BIAS_TOL_SHARE[str(dtype)]
            dbias_tol = max(tol, DBIAS_ROUNDING[case[9]])
            finite = all(bool(torch.isfinite(a).all())
                         for a, _ in got.values())
            hidden_zero = not causal or bool((dbias.triu(1) == 0).all())
            ok = finite and hidden_zero and torch.equal(dq, dq2) \
                and dbias.dtype == bias.dtype and lse_err <= FLASH_LSE_ATOL \
                and shares["dbias"] <= dbias_tol \
                and all(v <= tol for n, v in shares.items() if n != "dbias")
            log(f"[flash-bias] {name:18s} {str(dtype):15s} B{B} H{H} KV{KV} "
                f"S{S} hd{case[5]} {case[8]} {case[9]} bias: " + ", ".join(
                    f"{n} {v:.2e}" for n, v in shares.items())
                + f" of max |plain| (tol {tol:g}, dbias {dbias_tol:g}); lse "
                f"{lse_err:.1e}; dbias "
                f"0 above the diagonal {hidden_zero} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash bias {name} {dtype}: {shares}, "
                                     f"lse {lse_err}, finite {finite}, "
                                     f"zeros {hidden_zero}")
            for n, (a, b) in got.items():
                k_name = _OUTPUT_OF[n]
                worst["bias"][k_name] = max(
                    worst["bias"][k_name],
                    (a.float() - b.float()).abs().max().item())
            del x, o, o_p, dq, dq2, dq_p, dk, dv, dk_p, dv_p, dbias, dbias_p
    for case in fp32_cases:
        name, shape = case[0], case[1:]
        x = _flash_case(gen, *shape, torch.float32, device)
        kw = dict(mask=x["mask"], alibi_slopes=x["slopes"], causal=x["causal"])
        q, k, v, do = x["q"], x["k"], x["v"], x["do"]
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
        delta = fa.attention_delta(o_p, do)
        got = {"o": (fa.flash_fwd(q, k, v, **kw)[0], o_p),
               "dq": (fa.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw),
                      fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw))}
        dk_dv = zip(fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw),
                    fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw))
        got.update(zip(("dk", "dv"), dk_dv))
        shares = {n: _share(a, b) for n, (a, b) in got.items()}
        ok = all(v <= FLASH_BIAS_TOL_SHARE["torch.float32"]
                 for v in shares.values()) \
            and all(bool(torch.isfinite(a).all()) for a, _ in got.values())
        log(f"[flash-fp32] {name:20s} B{shape[0]} H{shape[1]} KV{shape[2]} "
            f"S{shape[3]} hd{shape[4]}: " + ", ".join(
                f"{n} {v:.2e}" for n, v in shares.items())
            + f" of max |plain| (tol 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash fp32 {name}: {shares}")
        for n, (a, b) in got.items():
            k_name = _OUTPUT_OF[n]
            worst["fp32"][k_name] = max(
                worst["fp32"][k_name],
                (a.float() - b.float()).abs().max().item())
        del x, got, dk_dv
    result = {"max_abs_err": worst}
    if device != "cuda":
        return result
    result["biased"] = {c[0]: _flash_bias_timing(gen, c, iters)
                        for c in cases[:2]}
    result["fp32"] = _flash_fp32_timing(gen, fp32_cases[0], iters)
    return result


# the kernel that writes each output
_OUTPUT_OF = {"o": "flash_fwd", "dq": "flash_bwd_dq", "dbias": "flash_bwd_dq",
              "dk": "flash_bwd_dkv", "dv": "flash_bwd_dkv"}


def _library_ms(fwd, fwd_bwd, iters) -> tuple:
    """Device ms of a library forward and of its autograd backward (the
    pair's time less the forward's); 4 input sets in rotation."""
    import torch

    with torch.no_grad():
        lib_f = device_ms(fwd, 4, iters)
    return lib_f, device_ms(fwd_bwd, 4, iters) - lib_f


def _flash_bias_timing(gen, case, iters) -> dict:
    """Kernel, plain and bound of each flash kernel with the bias at one
    case's shape, in the case's first dtype of phase 10 (bf16 for the AF2
    rows, fp32 for the example), dq writing dbias as training does; the
    library: SDPA with the bias (and the key mask, -inf on padded keys)
    as one float attn_mask (B, H, S, S), its forward and its autograd
    backward (dq, dk, dv and the mask's gradient), device-timed."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    name, B, H, KV, S, hd, causal = case[:7]
    dtype = torch.bfloat16 if name.startswith("af2") else torch.float32
    sets = []
    for _ in range(4):
        x = _bias_case(gen, case, dtype, "cuda")
        full = fa.bias4(x["bias"], B, H, S).expand(B, H, S, S)
        o, lse = fa.flash_attention_fwd_plain(x["q"], x["k"], x["v"],
                                              mask=x["mask"], bias=x["bias"],
                                              causal=causal)
        x.update(full=full, o=o, lse=lse,
                 delta=fa.attention_delta(o, x["do"]))
        sets.append(x)
    kw = lambda i: dict(mask=sets[i % 4]["mask"], causal=causal,  # noqa: E731
                        bias=sets[i % 4]["bias"])
    fkw = lambda i: dict(kw(i), bias=sets[i % 4]["full"])         # noqa: E731
    args = lambda i: tuple(sets[i % 4][n] for n in "qkv")         # noqa: E731
    bwd = lambda i: (*args(i), *(sets[i % 4][n]                   # noqa: E731
                                 for n in ("do", "lse", "delta")))
    calls = {"flash_fwd": (lambda i: fa.flash_fwd(*args(i), **kw(i)),
                           lambda i: fa.flash_attention_fwd_plain(
                               *args(i), **kw(i))),
             "flash_bwd_dq": (lambda i: fa.flash_bwd_dq(
                 *bwd(i), grad_bias=True, **fkw(i)),
                 lambda i: fa.flash_bwd_dq_plain(*bwd(i), grad_bias=True,
                                                 **fkw(i))),
             "flash_bwd_dkv": (lambda i: fa.flash_bwd_dkv(*bwd(i), **kw(i)),
                               lambda i: fa.flash_bwd_dkv_plain(
                                   *bwd(i), **kw(i)))}
    bias = sets[0]["bias"]
    side = bias.numel() * bias.element_size() + (
        B * S if sets[0]["mask"] is not None else 0)
    bounds = flash_bound(B, H, KV, S, hd, causal, dtype.itemsize,
                         side_bytes=side,
                         dbias_bytes=B * H * S * S * bias.element_size(),
                         dtype=str(dtype))
    # the library's inputs: (B, H, S, hd) leaves and one float mask
    leaves, gdo = [], []
    for s in sets:
        am = fa.bias4(s["bias"], B, H, S).float().expand(B, H, S, S)
        if s["mask"] is not None:
            am = am.masked_fill(~s["mask"][:, None, None, :], float("-inf"))
        leaves.append((*(t.transpose(1, 2).contiguous().requires_grad_()
                         for t in (s["q"], s["k"], s["v"])),
                       am.to(dtype).contiguous().requires_grad_()))
        gdo.append(s["do"].transpose(1, 2).contiguous())

    def lib_fwd(i):
        q, k, v, am = leaves[i % 4]
        return F.scaled_dot_product_attention(q, k, v, attn_mask=am,
                                              is_causal=False)

    def lib_fwd_bwd(i):
        return torch.autograd.grad(lib_fwd(i), leaves[i % 4], gdo[i % 4])

    lib_f, lib_b = _library_ms(lib_fwd, lib_fwd_bwd, iters)
    library = {"flash_fwd": lib_f, "flash_bwd_dq": lib_b,
               "flash_bwd_dkv": lib_b}
    out = {}
    for n, (kern, plain) in calls.items():
        ms = device_ms(kern, 4, iters)
        plain_ms = time_ms(plain, 3)
        b = bounds[n]
        out[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                      bound_by=b["bound_by"], library_ms=library[n])
        log(f"[flash-bias] {n} {name} B{B} H{H} S{S} hd{hd} "
            f"{'causal' if causal else 'full'} {dtype}, bias "
            f"{tuple(bias.shape)} {bias.dtype}"
            f"{', dbias (B, H, S, S)' if n == 'flash_bwd_dq' else ''}: "
            f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}: {b['bytes']} B, "
            f"{b['ops']:.4g} flop), kernel at {b['bound_ms'] / ms:.1%} of the "
            "bound")
    bwd_ms = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    log(f"[flash-bias] {name} library calls (device, not called by the "
        f"port): SDPA with the float mask, forward {lib_f * 1e3:.2f} us vs "
        f"flash_fwd {out['flash_fwd']['ms'] * 1e3:.2f} us; its autograd "
        f"backward (dq, dk, dv, dmask) {lib_b * 1e3:.2f} us vs flash_bwd_dq"
        f" + flash_bwd_dkv {bwd_ms * 1e3:.2f} us")
    del sets, leaves, gdo
    return out


def _flash_fp32_timing(gen, case, iters) -> dict:
    """The fp32 kernels without a bias at one case's shape against their
    bound at 67 TFLOP/s, the plain versions and SDPA in fp32 (forward and
    its autograd backward), all device-timed but the plain versions."""
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    name, B, H, KV, S, hd, causal = case[:7]
    sets = []
    for _ in range(4):
        x = _flash_case(gen, B, H, KV, S, hd, causal, None, False,
                        torch.float32, "cuda")
        o, lse = fa.flash_attention_fwd_plain(x["q"], x["k"], x["v"],
                                              causal=causal)
        x.update(lse=lse, delta=fa.attention_delta(o, x["do"]))
        sets.append(x)
    args = lambda i: tuple(sets[i % 4][n] for n in "qkv")         # noqa: E731
    bwd = lambda i: (*args(i), *(sets[i % 4][n]                   # noqa: E731
                                 for n in ("do", "lse", "delta")))
    calls = {"flash_fwd": (lambda i: fa.flash_fwd(*args(i), causal=causal),
                           lambda i: fa.flash_attention_fwd_plain(
                               *args(i), causal=causal)),
             "flash_bwd_dq": (lambda i: fa.flash_bwd_dq(*bwd(i),
                                                        causal=causal),
                              lambda i: fa.flash_bwd_dq_plain(
                                  *bwd(i), causal=causal)),
             "flash_bwd_dkv": (lambda i: fa.flash_bwd_dkv(*bwd(i),
                                                          causal=causal),
                               lambda i: fa.flash_bwd_dkv_plain(
                                   *bwd(i), causal=causal))}
    bounds = flash_bound(B, H, KV, S, hd, causal, 4, dtype="torch.float32")
    rep = lambda t: t.repeat_interleave(H // KV, 2) if KV != H else t  # noqa
    leaves = [tuple(rep(t).transpose(1, 2).contiguous().requires_grad_()
                    for t in args(i)) for i in range(4)]
    gdo = [s["do"].transpose(1, 2).contiguous() for s in sets]

    def lib_fwd(i):
        return F.scaled_dot_product_attention(*leaves[i % 4],
                                              is_causal=causal)

    def lib_fwd_bwd(i):
        return torch.autograd.grad(lib_fwd(i), leaves[i % 4], gdo[i % 4])

    lib_f, lib_b = _library_ms(lib_fwd, lib_fwd_bwd, iters)
    library = {"flash_fwd": lib_f, "flash_bwd_dq": lib_b,
               "flash_bwd_dkv": lib_b}
    out = {}
    for n, (kern, plain) in calls.items():
        ms = device_ms(kern, 4, iters)
        plain_ms = time_ms(plain, 3)
        b = bounds[n]
        out[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b["bound_ms"],
                      bound_by=b["bound_by"], library_ms=library[n])
        log(f"[flash-fp32] {n} {name} B{B} H{H} KV{KV} S{S} hd{hd} "
            f"{'causal' if causal else 'full'} fp32: kernel {ms * 1e3:.2f} "
            f"us, plain {plain_ms * 1e3:.2f} us, bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']} at 67 TFLOP/s "
            f"fp32: {b['bytes']} B, {b['ops']:.4g} flop), kernel at "
            f"{b['bound_ms'] / ms:.1%} of the bound")
    bwd_ms = out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"]
    log(f"[flash-fp32] {name} library calls (device, not called by the "
        f"port): SDPA fp32 forward {lib_f * 1e3:.2f} us vs flash_fwd "
        f"{out['flash_fwd']['ms'] * 1e3:.2f} us; its autograd backward "
        f"{lib_b * 1e3:.2f} us vs flash_bwd_dq + flash_bwd_dkv "
        f"{bwd_ms * 1e3:.2f} us")
    del sets, leaves, gdo
    return out


# ------------------------------------------------------------------ phase 6
# the slice's training config: examples/pretrain_gpt2.py's at micro 4,
# gas 2 (its warm-up of 2000 steps keeps the first steps' lr at 2.7e-5 to
# 1.1e-4; a 5-step warm-up at 3e-4 threw the loss of the random 1.5 B init
# up from 10.4 to 12.2 within three steps on an H100)
TRAIN_CONFIG = {
    "train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 3e-4, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupDecayLR",
                  "params": {"warmup_num_steps": 2000,
                             "total_num_steps": 100000}},
    "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
    "remat": {"enabled": True, "policy": "dots_saveable"},
    "bf16": {"enabled": True}, "steps_per_print": 1000}
# kernel path vs plain path at full width and 4 layers, bf16, one
# micro-batch, the same params: the loss within 1e-2 relative and every
# grad leaf within 5e-2 relative in norm (||Δ|| / ||plain||). The two
# attention paths differ by a few bf16 ulps at their outputs (phase 5:
# <= 3.4e-3 of max |plain|); the bf16 residual stream, norms and every grad
# are rounded after them, over 4 layers and a 50257-way head. CPU rehearsal
# of the same check between two attention paths that round differently
# (plain flash vs the dense causal_attention, bf16, 4 layers, d 512, S 256):
# loss 1.0e-6 rel, grads <= 1.4e-2. A wrong kernel (a dropped tile, a wrong
# mask or scale) gives O(1). ``layers.bk`` is logged, not gated: a key bias
# shifts a whole softmax row, so its grad is 0 up to rounding noise (its
# norm is ~3e-3 of bq's) and its relative difference is noise over noise.
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RTOL = 5e-2
# phase 9, long rows under the Fixed sparsity layout: TRAIN_CONFIG at
# micro-batch 1 x gas 2 x 8192 tokens, otherwise the same
LONG_TRAIN_CONFIG = {**TRAIN_CONFIG, "train_batch_size": 2,
                     "train_micro_batch_size_per_gpu": 1}


def _plain_flash_attention(causal: bool = True,
                           bias_is_constant: bool = True):
    """The flash attention Function with the plain versions on every
    device: the reference the kernel path is held against. A bias reaches
    it as :func:`flash_attention` hands it to the kernels (a learned
    broadcast bias expanded at stride 0), and takes dbias when it needs
    a gradient."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, slopes, bias):
            o, lse = fa.flash_attention_fwd_plain(q, k, v, mask=mask,
                                                  alibi_slopes=slopes,
                                                  bias=bias, causal=causal)
            ctx.save_for_backward(q, k, v, o, lse, mask, slopes, bias)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse, mask, slopes, bias = ctx.saved_tensors
            delta = fa.attention_delta(o, do)
            kw = dict(mask=mask, alibi_slopes=slopes, bias=bias,
                      causal=causal)
            dbias = None
            if ctx.needs_input_grad[5]:
                dq, dbias = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                  grad_bias=True, **kw)
            else:
                dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
            dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
            return dq, dk, dv, None, None, dbias

    def attn(q, k, v, *, mask=None, bias=None, alibi_slopes=None):
        if bias is not None:
            bias = fa.bias_operand(bias, q, bias_is_constant)
        return Plain.apply(q, k, v, mask, alibi_slopes, bias)

    attn.accepts_alibi_slopes = True
    return attn


def _plain_sparse_attention(config):
    """The sparse attention Function with the plain versions on every
    device, under ``config``'s causal layout: the reference phase 9's
    kernel path is held against."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            ctx.layout = sa.sparse_layout(config, q.shape[1], True, q.device)
            o, lse = sa.sparse_attention_fwd_plain(q, k, v, ctx.layout)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            delta = fa.attention_delta(o, do)
            dq = sa.sparse_bwd_dq_plain(q, k, v, do, lse, delta, ctx.layout)
            dk, dv = sa.sparse_bwd_dkv_plain(q, k, v, do, lse, delta,
                                             ctx.layout)
            return dq, dk, dv

    def attn(q, k, v, *, mask=None):
        assert mask is None
        return Plain.apply(q, k, v)

    return attn


def _rel_norm(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _loss_and_grads(model, master, batch, dtype, remat):
    params = {k: v.detach().to(dtype).requires_grad_()
              for k, v in master.items()}
    loss = model.loss(params, batch, remat_policy=remat)
    loss.backward()
    return loss.detach().float(), {k: v.grad for k, v in params.items()}


def _token_batch(data) -> dict:
    import numpy as np

    return {"input_ids": np.stack([d["input_ids"] for d in data])}


# BERT-large's MLM step: micro-batch 16 x 512 tokens, ZeRO stage 1 and the
# remat policy of bench_bert.py's config, AdamW at the 1e-4 of BERT's
# pretraining recipe, constant: the phase takes a handful of steps
BERT_TRAIN_CONFIG = {
    "train_batch_size": 16, "train_micro_batch_size_per_gpu": 16,
    "gradient_accumulation_steps": 1,
    "optimizer": {"type": "adamw",
                  "params": {"lr": 1e-4, "weight_decay": 0.01}},
    "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
    "remat": {"enabled": True, "policy": "dots_saveable"},
    "bf16": {"enabled": True}, "steps_per_print": 1000}


def _mlm_batch(rows: int, seq: int, vocab: int, seed: int = 5,
               mask_frac: float = 0.15, mask_id: int = 103) -> dict:
    """A learnable MLM batch: each row one token repeated, 15% of its live
    positions replaced by [MASK] and counted in ``loss_mask``; every fourth
    row is padded out past three quarters of its length."""
    import numpy as np

    rng = np.random.default_rng(seed)
    labels = np.repeat(rng.integers(1000, vocab, (rows, 1)), seq, axis=1)
    att = np.ones((rows, seq), np.int32)
    att[1::4, 3 * seq // 4:] = 0
    picked = (rng.random((rows, seq)) < mask_frac) & (att == 1)
    picked[:, 0] = True
    ids = np.where(picked, mask_id, labels)
    return {"input_ids": ids.astype(np.int32),
            "labels": labels.astype(np.int32),
            "loss_mask": picked.astype(np.int32), "attention_mask": att}


def _head_alone(model, master, batch, dtype, iters: int = 3) -> dict:
    """Device ms (CUDA events) and peak bytes above the resident ones of the
    model's head alone, forward and backward, on random trunk outputs of
    the batch's shape: the final norm (and MLM transform), then the fused
    xent kernels or the unfused logits and ``token_nll``, as ``loss``
    routes them."""
    import torch

    from deepspeed_tpu_torch.models.transformer import token_nll

    cfg = model.cfg
    ids = batch["input_ids"]
    names = [k for k in master if not k.startswith("layers.")]
    params = {k: master[k].detach().to(dtype).requires_grad_() for k in names}
    feats = torch.randn((*ids.shape, cfg.d_model), device=ids.device,
                        generator=torch.Generator(device=ids.device)
                        .manual_seed(3)).to(dtype).requires_grad_()
    mlm = cfg.objective == "mlm"
    tgt = batch["labels"] if mlm else ids[:, 1:]
    fused = model._fused_xent_active(ids.device.type == "cuda", dtype)

    def run(_):
        if fused:
            x = model._pre_head(params, feats)
            nll = model._fused_nll(params, x if mlm else x[:, :-1], tgt)
        else:
            logits = model._head(params, feats)
            nll = token_nll(logits if mlm else logits[:, :-1], tgt)
        nll.mean().backward()

    run(0)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(run, iters)
    return {"ms": ms, "peak_bytes": torch.cuda.max_memory_allocated() - resident,
            "fused": fused}


XENT_KERNEL_NAMES = ("xent_fwd_kernel", "xent_fwd_merge_kernel",
                     "xent_bwd_kernel")


def kernel_names(fns) -> tuple:
    """The names under which the wrappers' kernels show in a profile:
    ``<wrapper>_kernel``, and for the three flash kernels their wgmma
    kernel ``<wrapper>_sm90_kernel`` besides the mma.sync one (fp32 and hd
    16)."""
    return tuple(n for fn in fns for n in (
        (f"{fn.__name__}_kernel", f"{fn.__name__}_sm90_kernel")
        if fn.__name__ in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        else (f"{fn.__name__}_kernel",)))


def phase_train(cfg=None, *, config=None, check="attention", check_layers=4,
                seq=1024, warmup=3, steps=10, fall=0.5, device=None,
                profile_steps=2, name="train", attention=None,
                reference=None, kernels=None) -> dict:
    """A training main path: ``initialize(config, build_model(cfg,
    attention_fn=attention())).train_batch`` at full width and depth
    (``attention`` defaults to ``make_flash_attention(causal=cfg.causal)``),
    with every flash, sparse and xent kernel's count zeroed just before the
    timed steps and read just after: ``kernels``, the attention function's
    forward, dq and dk/dv counters (default the flash kernels'), must count
    every layer and micro-batch, the other attention kernels 0. First, at
    ``check_layers`` layers on the same weights and batch: with ``check=
    "attention"`` the kernel attention path's loss and grads against the
    plain attention path's (``reference()``, default the plain flash
    Function); with ``check="head"`` the fused xent head's against the
    unfused head's (``fused_xent=False``), and each head timed alone."""
    import dataclasses

    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops import xent as xe
    from deepspeed_tpu_torch.runtime import random_token_dataset

    # fused_xent=False: the unfused head, which the JAX package takes on its
    # TPU too; the default sends a tied head through the fused xent kernels
    cfg = cfg or gpt2("1.5b", fused_xent=False)
    config = config or TRAIN_CONFIG
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kw = {} if device is None else {"device": device}
    flash = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    sparse = (sa.sparse_fwd, sa.sparse_bwd_dq, sa.sparse_bwd_dkv)
    xent = (xe.xent_fwd, xe.xent_dx, xe.xent_dw)
    kernels = kernels or flash
    micro = config["train_micro_batch_size_per_gpu"]
    gas = config["gradient_accumulation_steps"]
    rows = micro * gas
    mlm = cfg.objective == "mlm"
    tag = f"[{name} {cfg.n_layer}L d{cfg.d_model}]"
    attention = attention or partial(dt.make_flash_attention,
                                     causal=cfg.causal)

    def batch_of(n):
        if mlm:
            return _mlm_batch(n, seq, cfg.vocab_size)
        return _token_batch(random_token_dataset(n, seq, cfg.vocab_size,
                                                 seed=5, learnable=True))

    # ---- (a) the path under test vs its reference, check_layers deep ----
    small = dataclasses.replace(cfg, n_layer=check_layers)
    gen = torch.Generator(device=dev).manual_seed(77)
    master = dt.build_model(small).init(gen, device=dev, dtype=torch.float32)
    if mlm:
        mb = {k: torch.as_tensor(v).to(dev) for k, v in
              _mlm_batch(micro, seq, cfg.vocab_size, seed=6).items()}
    else:
        mb = {"input_ids": torch.randint(0, cfg.vocab_size, (micro, seq),
                                         generator=gen, device=dev)}
    remat = config["remat"]["policy"]
    under_test = dt.build_model(small, attention_fn=attention())
    if check == "attention":
        what = "kernel vs plain attention path"
        reference = dt.build_model(small, attention_fn=(
            reference or _plain_flash_attention)())
    else:
        what = "fused xent head vs unfused head (fused_xent=False)"
        reference = dt.build_model(
            dataclasses.replace(small, fused_xent=False),
            attention_fn=attention())
    lk, gk = _loss_and_grads(under_test, master, mb, cfg.dtype, remat)
    lp, gp = _loss_and_grads(reference, master, mb, cfg.dtype, remat)
    sync()
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    grad_rel = {k: _rel_norm(gk[k], gp[k]) for k in gk}
    bk = grad_rel.pop("layers.bk", None)
    worst = max(grad_rel, key=grad_rel.get)
    finite = all(bool(torch.isfinite(g).all()) for g in gk.values())
    log(f"{tag} {what}, {check_layers} layers, {micro}x{seq} tokens, bf16, "
        f"remat {remat}: loss {lk.item():.5f} vs {lp.item():.5f} "
        f"({loss_rel:.2e} rel, tol {TRAIN_LOSS_RTOL}); grads "
        f"||Δ||/||reference|| max {grad_rel[worst]:.2e} at {worst} (tol "
        f"{TRAIN_GRAD_RTOL}), median "
        f"{sorted(grad_rel.values())[len(grad_rel) // 2]:.2e}; layers.bk "
        f"(noise, not gated) {bk}")
    if check == "head":
        log(f"{tag} head leaves: " + ", ".join(
            f"{k} {grad_rel[k]:.2e}" for k in sorted(grad_rel)
            if not k.startswith("layers.")))
    if not (finite and loss_rel <= TRAIN_LOSS_RTOL
            and grad_rel[worst] <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"{tag} {what}: loss {loss_rel}, grads "
                             f"{grad_rel}, finite {finite}")
    heads = {}
    if check == "head" and cuda:
        del gk, gp
        _free_memory(dev)
        for label, model in (("fused", under_test), ("unfused", reference)):
            heads[label] = _head_alone(model, master, mb, cfg.dtype)
            _free_memory(dev)
        log(f"{tag} the head alone, forward + backward on {micro}x{seq} "
            "tokens (eager, CUDA events; peak above the resident bytes): "
            + "; ".join(f"{k} {v['ms']:.2f} ms, {v['peak_bytes'] / 2**30:.2f}"
                        f" GiB" for k, v in heads.items()))
    del master
    gk = gp = None
    _free_memory(dev)

    # ---- the engine at full depth ----
    t0 = time.perf_counter()
    engine = dt.initialize(config, dt.build_model(
        cfg, attention_fn=attention()), seed=1234, **kw)
    sync()
    state_bytes = _free_memory(dev)
    assert rows == engine.train_batch_size
    fused = engine.model._fused_xent_active(cuda, engine.compute_dtype)
    # one batch of learnable rows (each a single token repeated), taken by
    # every step: the loss on it must fall
    data = batch_of(rows)
    log(f"{tag} {cfg.param_count() / 1e9:.3f} B params ({engine.param_count} "
        f"tensors' elements), initialize {time.perf_counter() - t0:.1f} s, "
        f"state {state_bytes / 2**30:.2f} GiB on {engine.device}; fused xent "
        f"head {fused}")
    losses = []
    for i in range(warmup):
        losses.append(float(engine.train_batch(dict(data))["loss"]))

    # ---- the main path, counted and timed ----
    _free_memory(dev)
    for c in flash + sparse + xent:
        c.launches = 0
    step_s = []
    for i in range(warmup, warmup + steps):
        sync()
        t1 = time.perf_counter()
        m = engine.train_batch(dict(data))
        losses.append(float(m["loss"]))           # a host read: synchronizes
        step_s.append(time.perf_counter() - t1)
    got = {c.__name__: c.launches for c in flash + sparse + xent}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    per_step = cfg.n_layer * gas if cuda else 0
    head = gas * steps if cuda and fused else 0
    want = dict.fromkeys(got, 0)
    fwd, dq, dkv = (c.__name__ for c in kernels)
    want.update({fwd: 2 * per_step * steps,         # remat reruns the forward
                 dq: per_step * steps, dkv: per_step * steps,
                 "xent_fwd": head, "xent_dx": head, "xent_dw": head})
    if got != want:
        raise AssertionError(f"{tag} launches {got}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{tag} non-finite loss: {losses}")
    # the first warm-up step measures the initial params; the timed steps'
    # mean must be below ``fall`` of that (one repeated batch of learnable
    # rows: GPT-2 1.5B went from 10.43 to a timed mean of 1.26 on an H100,
    # with Adam oscillating from step to step, so no single step is gated)
    first, mean = losses[0], sum(losses[warmup:]) / steps
    if not mean < fall * first:
        raise AssertionError(f"{tag} loss did not fall on learnable data: "
                             f"{losses}")
    step = sorted(step_s)[len(step_s) // 2]
    tokens = rows * seq
    mfu = cfg.flops_per_token() * tokens / step / PEAK_OPS_PER_S[
        "torch.bfloat16"]
    log(f"{tag} launches over {steps} steps {got} (per step: {fwd} "
        f"{2 * per_step} = {cfg.n_layer} layers x gas {gas} x 2, the "
        f"checkpoint reruns the forward in the backward; {dq} = {dkv} = "
        f"{per_step}; each xent kernel {gas if fused else 0}: the head sits "
        "outside the layer checkpoints; the other attention kernels 0)")
    log(f"{tag} losses {[round(x, 4) for x in losses]}: initial {first:.4f}"
        f", mean of the {steps} timed steps {mean:.4f} (gate < {fall} of the "
        "initial)")
    log(f"{tag} step {step * 1e3:.1f} ms median (min {min(step_s) * 1e3:.1f},"
        f" max {max(step_s) * 1e3:.1f}), {tokens / step:.0f} tokens/s, MFU "
        f"{mfu:.1%} of 989 TFLOP/s ({cfg.flops_per_token() / 1e9:.2f} GFLOP "
        f"per token, attention counted dense); peak memory {peak / 2**30:.2f} GiB ({state_bytes / 2**30:.2f}"
        " GiB of state before the steps)")
    result = {"launches": got, "step_ms": step * 1e3,
              "tokens_per_s": tokens / step, "mfu": mfu, "peak_bytes": peak,
              "losses": losses, "loss_rel": loss_rel,
              "grad_rel": grad_rel[worst], "shares": {}, "heads": heads,
              "gas": gas}
    if cuda and profile_steps:
        prof = profile_calls(
            lambda: [engine.train_batch(dict(data))
                     for _ in range(profile_steps)], profile_steps,
            "training steps")
        if prof:
            for kname in kernel_names(flash + sparse) + XENT_KERNEL_NAMES:
                us = sum(v for k, v in prof["by_name"].items()
                         if f"{kname}<" in k or k.startswith(kname)
                         or f"::{kname}(" in k)
                result["shares"][kname] = us / prof["busy"]
            result["busy_share"] = prof["busy"] / prof["wall"]
            result["busy_ms"] = prof["busy"] / profile_steps / 1e3
            log(f"{tag} hand-written kernels' share of device time: "
                + ", ".join(f"{k} {v:.1%}"
                            for k, v in result["shares"].items()))
    del engine
    _free_memory(dev)
    return result


# ------------------------------------------------------------------ phase 9
def phase_long_train(cfg=None, *, seq=8192, check_layers=4, warmup=2,
                     steps=5, device=None) -> dict:
    """The slice: ``gpt2("1.5b", max_seq=8192)`` trained on 8192-token rows
    with ``make_sparse_attention_fn(FixedSparsityConfig())`` as its
    attention_fn, through ``initialize(LONG_TRAIN_CONFIG, ...)`` →
    ``train_batch``: :func:`phase_train` with the sparse kernels' counters
    and the plain sparse Function as the 4-layer reference."""
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    sc = sa.FixedSparsityConfig()
    return phase_train(
        cfg or gpt2("1.5b", max_seq=seq), config=LONG_TRAIN_CONFIG,
        check_layers=check_layers, seq=seq, warmup=warmup, steps=steps,
        device=device, name=f"train sparse {seq}",
        attention=partial(sa.make_sparse_attention_fn, sc),
        reference=partial(_plain_sparse_attention, sc),
        kernels=(sa.sparse_fwd, sa.sparse_bwd_dq, sa.sparse_bwd_dkv))


# ------------------------------------------------------------------ phase 10
# (a) examples/evoformer_science.py at its full size, its SGD and its seed;
# (b) AlphaFold 2's MSA row-wise gated self-attention with pair bias (AF2
# supplementary information, Algorithm 7: 8 heads of 32, c_m 256, the bias
# a linear map of the LayerNorm'd pair representation, c_z 128) at the
# initial training crop of 256 residues and 128 MSA clusters, the clusters
# as the batch sharing one (1, 8, 256, 256) pair bias
EVO_EXAMPLE = dict(B=4, S=256, H=8, hd=32, d_pair=8, steps=50, lr=0.05)
AF2_MSA_ROW = dict(n_seq=128, n_res=256, c_m=256, c_z=128, H=8, hd=32,
                   warmup=2, steps=5, lr=0.05)
# the kernel path's losses against the plain path's, every step: fp32 both
# sides (3xTF32 products, another summation order; ~1e-6 expected); bf16
# phase 6's gate (TRAIN_LOSS_RTOL on the loss, TRAIN_GRAD_RTOL on every
# grad leaf in norm on the first step's shared weights)
EVO_FP32_LOSS_RTOL = 1e-4


def _example_state(B, S, H, hd, d_pair, device):
    """x, target and the trainable leaves of the example, drawn from
    ``np.random.default_rng(0)`` in its order (x, pair, target, wq, wk,
    wv, w_gate, w_bias) and moved to ``device`` as fp32."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    draw = lambda *shape: torch.from_numpy(                        # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(device)
    x, pair, target = draw(B, S, H * hd), draw(B, S, S, d_pair), \
        draw(B, S, H * hd)
    params = {n: (torch.from_numpy(rng.standard_normal(shape) * 0.05)
                  .float().to(device))
              for n, shape in (("wq", (H * hd, H * hd)),
                               ("wk", (H * hd, H * hd)),
                               ("wv", (H * hd, H * hd)),
                               ("w_gate", (H * hd, H * hd)),
                               ("w_bias", (d_pair, H)))}
    params["pair"] = pair
    return x, target, params


def _sgd_run(loss_fn, params, steps, lr, counters=()):
    """``steps`` SGD steps on fp32 ``params`` (each forward casts them):
    the losses, the first step's grads, the last step's |d pair| (``pair``
    or ``z``) and the launches of ``counters`` over the steps (zeroed just
    before the first)."""
    import torch

    leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
    for c in counters:
        c.launches = 0
    losses, first, last_pair = [], None, 0.0
    for _ in range(steps):
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(loss.item())
        g = dict(zip(leaves, grads))
        first = first or {n: t.detach().clone() for n, t in g.items()}
        last_pair = float(g["pair" if "pair" in g else "z"].norm())
        with torch.no_grad():
            for n, t in leaves.items():
                t -= lr * g[n]
    launches = {c.__name__: c.launches for c in counters}
    return losses, first, last_pair, launches


def phase_evoformer(device="cuda", example=None, af2=None,
                    profile_steps=2) -> dict:
    """Phase 10: the gated, pair-biased evoformer block trained through
    ``ops.evoformer.evoformer_attention``, its pair representation through
    the dq kernel's dbias. (a) the DS4Science example at its full size, 50
    SGD steps in fp32 and then bf16, against the plain path (the plain
    flash Function) on the same weights; (b) AlphaFold 2's MSA rows in
    bf16. Every step launches each flash kernel exactly once; the loss
    falls; d pair is not 0."""
    import torch

    from deepspeed_tpu_torch.ops import evoformer as evo
    from deepspeed_tpu_torch.ops import flash_attention as fa

    ex = {**EVO_EXAMPLE, **(example or {})}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    plain = _plain_flash_attention(causal=False, bias_is_constant=False)

    def plain_evo(q, k, v, *, bias=None, gate=None, mask=None):
        return plain(q, k, v, mask=mask, bias=bias) * torch.sigmoid(gate)

    B, S, H, hd = ex["B"], ex["S"], ex["H"], ex["hd"]
    x, target, params = _example_state(B, S, H, hd, ex["d_pair"], dev)
    result = {"example": {}}
    for dtype in (torch.float32, torch.bfloat16):
        def loss_fn(p, attention):
            w = {n: t.to(dtype) for n, t in p.items()}
            xx = x.to(dtype)
            q, k, v, gate = ((xx @ w[n]).reshape(B, S, H, hd)
                             for n in ("wq", "wk", "wv", "w_gate"))
            bias = torch.einsum("bstd,dh->bhst", w["pair"], w["w_bias"])
            out = attention(q, k, v, bias=bias, gate=gate)
            return ((out.reshape(B, S, H * hd).float() - target) ** 2).mean()

        t0 = time.perf_counter()
        got = _sgd_run(partial(loss_fn, attention=evo.evoformer_attention),
                       params, ex["steps"], ex["lr"],
                       counters if cuda else ())
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / ex["steps"] * 1e3
        ref = _sgd_run(partial(loss_fn, attention=plain_evo), params,
                       ex["steps"], ex["lr"])
        losses, first, dpair, launches = got
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref[0])]
        grad_rel = {n: _rel_norm(first[n], ref[1][n]) for n in first}
        want = {c.__name__: ex["steps"] for c in counters} if cuda else {}
        tag = f"[evoformer example {str(dtype)[6:]}]"
        log(f"{tag} B{B} S{S} H{H} hd{hd}, {ex['steps']} SGD steps at lr "
            f"{ex['lr']}: losses " + ", ".join(
                f"step {i} {losses[i]:.6f}" for i in range(0, ex["steps"], 10))
            + f", final {losses[-1]:.6f}; plain path {ref[0][0]:.6f} -> "
            f"{ref[0][-1]:.6f}; kernel vs plain loss max {max(rel):.2e} rel, "
            f"first step's grads max {max(grad_rel.values()):.2e} rel "
            f"({max(grad_rel, key=grad_rel.get)}); |d pair| at the last step "
            f"{dpair:.3e}; launches {launches}; {ms:.2f} ms a step "
            "(host clock, kernel path)")
        if dtype == torch.float32:
            close = max(rel) <= EVO_FP32_LOSS_RTOL
        else:
            close = max(rel) <= TRAIN_LOSS_RTOL \
                and max(grad_rel.values()) <= TRAIN_GRAD_RTOL
        ok = close and launches == want and losses[-1] < losses[0] \
            and dpair > 0 and all(math.isfinite(v) for v in losses)
        if not ok:
            raise AssertionError(f"{tag} losses {losses} vs {ref[0]}, grads "
                                 f"{grad_rel}, launches {launches}, d pair "
                                 f"{dpair}")
        result["example"][str(dtype)] = dict(
            losses=losses, plain_losses=ref[0], loss_rel=max(rel),
            grad_rel=max(grad_rel.values()), launches=launches, step_ms=ms)
    _free_memory(dev)
    result["af2"] = phase_af2_msa_row(device, af2, profile_steps)
    return result


def _layer_norm(x, scale, bias):
    import torch.nn.functional as F

    return F.layer_norm(x, (x.shape[-1],), scale, bias, eps=1e-5)


def phase_af2_msa_row(device="cuda", af2=None, profile_steps=2) -> dict:
    """Phase 10 (b): AlphaFold 2's MSA row-wise gated self-attention with
    pair bias in bf16, fp32 master weights and SGD: m (n_seq, n_res, c_m)
    LayerNorm'd and projected to q, k, v and the gate (n_seq, n_res, 8,
    32); the bias a linear map of the LayerNorm'd pair representation z
    (n_res, n_res, c_z), one (1, 8, n_res, n_res) shared by every row and
    learned (its dbias summed over the rows); a (n_seq, n_res) key mask on
    the padded residues; the loss an MSE over the live residues. First the
    kernel path against the plain path on the first step; then the timed
    steps with every flash count read; ms a step, peak memory, the kernels'
    share of device time; the plain path's peak memory."""
    import torch

    from deepspeed_tpu_torch.ops import evoformer as evo
    from deepspeed_tpu_torch.ops import flash_attention as fa

    a = {**AF2_MSA_ROW, **(af2 or {})}
    n_seq, n_res, c_m, c_z, H, hd = (a[k] for k in ("n_seq", "n_res", "c_m",
                                                    "c_z", "H", "hd"))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    gen = torch.Generator(device=dev).manual_seed(10)
    mk = lambda *shape, std=1.0: torch.randn(                      # noqa: E731
        shape, generator=gen, device=dev) * std
    m = mk(n_seq, n_res, c_m).bfloat16()
    target = mk(n_seq, n_res, c_m)
    live = min(AF2_LIVE, n_res - 1)
    mask = torch.ones((n_seq, n_res), dtype=torch.bool, device=dev)
    mask[:, live:] = False
    params = {"ln_m_scale": torch.ones(c_m, device=dev),
              "ln_m_bias": torch.zeros(c_m, device=dev),
              "ln_z_scale": torch.ones(c_z, device=dev),
              "ln_z_bias": torch.zeros(c_z, device=dev),
              "b_g": torch.ones(H * hd, device=dev),
              "w_b": mk(c_z, H, std=c_z ** -0.5),
              "z": mk(n_res, n_res, c_z)}
    for n in ("w_q", "w_k", "w_v", "w_g"):
        params[n] = mk(c_m, H * hd, std=c_m ** -0.5)
    params["w_o"] = mk(H * hd, c_m, std=(H * hd) ** -0.5)
    plain = _plain_flash_attention(causal=False, bias_is_constant=False)

    def plain_evo(q, k, v, *, bias=None, gate=None, mask=None):
        return plain(q, k, v, mask=mask, bias=bias) * torch.sigmoid(gate)

    def loss_fn(p, attention):
        w = {n: t.bfloat16() for n, t in p.items()}
        mm = _layer_norm(m, w["ln_m_scale"], w["ln_m_bias"])
        q, k, v = ((mm @ w[n]).reshape(n_seq, n_res, H, hd)
                   for n in ("w_q", "w_k", "w_v"))
        gate = (mm @ w["w_g"] + w["b_g"]).reshape(n_seq, n_res, H, hd)
        zz = _layer_norm(w["z"], w["ln_z_scale"], w["ln_z_bias"])
        bias = torch.einsum("ijc,ch->hij", zz, w["w_b"])[None]
        o = attention(q, k, v, bias=bias, gate=gate, mask=mask)
        out = o.reshape(n_seq, n_res, H * hd) @ w["w_o"]
        err = (out.float() - target) ** 2 * mask[..., None]
        return err.sum() / (mask.sum() * c_m)

    tag = f"[af2 msa row {n_seq}x{n_res} c_m {c_m} c_z {c_z} H{H} hd{hd}]"
    # the kernel path against the plain path on the first step; the plain
    # path's peak memory above what the state holds
    base = _free_memory(dev)
    ref = _sgd_run(partial(loss_fn, attention=plain_evo), params, 1, 0.0)
    sync()
    plain_peak = torch.cuda.max_memory_allocated() - base if cuda else 0
    base = _free_memory(dev)
    got = _sgd_run(partial(loss_fn, attention=evo.evoformer_attention),
                   params, 1, 0.0)
    sync()
    kernel_peak1 = torch.cuda.max_memory_allocated() - base if cuda else 0
    loss_rel = abs(got[0][0] - ref[0][0]) / abs(ref[0][0])
    grad_rel = {n: _rel_norm(got[1][n], ref[1][n]) for n in got[1]}
    # the pair LayerNorm's offset adds one constant to every score of a
    # head, which no softmax row sees: its gradient is 0 in exact
    # arithmetic and both paths give rounding noise (layers.bk of phase 6)
    noise = grad_rel.pop("ln_z_bias")
    worst = max(grad_rel, key=grad_rel.get)
    log(f"{tag} kernel vs plain path, bf16, first step: loss {got[0][0]:.6f}"
        f" vs {ref[0][0]:.6f} ({loss_rel:.2e} rel, tol {TRAIN_LOSS_RTOL}); "
        f"grads ||Δ||/||plain|| max {grad_rel[worst]:.2e} at {worst} (tol "
        f"{TRAIN_GRAD_RTOL}); dz {grad_rel['z']:.2e}; ln_z_bias (noise, not "
        f"gated) {noise:.2e}, |grad| {float(got[1]['ln_z_bias'].norm()):.2e}"
        f" against |dz| {float(got[1]['z'].norm()):.2e}; peak memory above "
        f"the state: kernel path {kernel_peak1 / 2**30:.3f} GiB, plain path "
        f"{plain_peak / 2**30:.3f} GiB")
    if not (loss_rel <= TRAIN_LOSS_RTOL
            and grad_rel[worst] <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"{tag} kernel vs plain: loss {loss_rel}, grads "
                             f"{grad_rel}")
    del ref, got
    # the main path: warm-up, then the counted and timed steps
    leaves = {n: t.clone().requires_grad_() for n, t in params.items()}

    issued = []                           # host clock at the last launch

    def step():
        loss = loss_fn(leaves, evo.evoformer_attention)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for t, g in zip(leaves.values(), grads):
                t -= a["lr"] * g
        issued.append(time.perf_counter())
        return loss.item(), float(grads[list(leaves).index("z")].norm())

    losses = [step()[0] for _ in range(a["warmup"])]
    base = _free_memory(dev)
    for c in counters:
        c.launches = 0
    step_s, issue_s, dz = [], [], 0.0
    for _ in range(a["steps"]):
        sync()
        t1 = time.perf_counter()
        loss, dz = step()                 # a host read: synchronizes
        step_s.append(time.perf_counter() - t1)
        issue_s.append(issued[-1] - t1)
        losses.append(loss)
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() - base if cuda else 0
    want = {c.__name__: a["steps"] for c in counters} if cuda else \
        dict.fromkeys(launches, 0)
    ms = sorted(step_s)[len(step_s) // 2] * 1e3
    issue_ms = sorted(issue_s)[len(issue_s) // 2] * 1e3
    log(f"{tag} {a['warmup']} + {a['steps']} SGD steps at lr {a['lr']}: "
        f"losses {[round(v, 6) for v in losses]}; launches {launches} (1 / 1"
        f" / 1 a step); |dz| at the last step {dz:.3e}; step {ms:.2f} ms "
        f"median (min {min(step_s) * 1e3:.2f}, max {max(step_s) * 1e3:.2f}), "
        f"of which the host issues its launches in {issue_ms:.2f} ms median, "
        f"then waits on the device; peak memory above the state "
        f"{peak / 2**30:.3f} GiB")
    if not (launches == want and losses[-1] < losses[0] and dz > 0
            and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{tag} launches {launches}, losses {losses}, "
                             f"dz {dz}")
    result = dict(losses=losses, loss_rel=loss_rel, grad_rel=grad_rel[worst],
                  launches=launches, step_ms=ms, issue_ms=issue_ms,
                  peak_bytes=peak, plain_peak_bytes=plain_peak, shares={})
    if cuda and profile_steps:
        prof = profile_calls(lambda: [step() for _ in range(profile_steps)],
                             profile_steps, "AF2 MSA-row steps")
        if prof:
            for kname in kernel_names(counters):
                us = sum(v for k, v in prof["by_name"].items()
                         if f"{kname}<" in k or k.startswith(kname)
                         or f"::{kname}(" in k)
                result["shares"][kname] = us / prof["busy"]
            result["busy_ms"] = prof["busy"] / profile_steps / 1e3
            result["busy_share"] = prof["busy"] / prof["wall"]
            log(f"{tag} the flash kernels' share of device time: "
                + ", ".join(f"{k} {v:.1%}"
                            for k, v in result["shares"].items())
                + f" (device busy {result['busy_ms']:.2f} ms a step)")
    del leaves
    _free_memory(dev)
    return result


def remat_sweep(cfg=None, *, seq=1024, steps=3) -> dict:
    """Where the training step's host time goes: the step of GPT-2 1.5B
    under its default config (the fused xent head) under each remat policy
    (``dots_saveable``, none, ``full``, ``save_names``,
    ``save_names_mlp``), median step ms and peak memory. A one-off
    measurement, not a phase::

        python3 -c "import chip_smoke as c; c.remat_sweep()"
    """
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.runtime import random_token_dataset

    cfg = cfg or gpt2("1.5b")
    dev = torch.device("cuda")
    engine = dt.initialize(TRAIN_CONFIG, dt.build_model(
        cfg, attention_fn=dt.make_flash_attention()), seed=1234)
    data = random_token_dataset(engine.train_batch_size, seq, cfg.vocab_size,
                                seed=5, learnable=True)
    out = {}
    for policy in ("dots_saveable", None, "full", "save_names",
                   "save_names_mlp"):
        engine.remat_policy = policy
        _free_memory(dev)
        engine.train_batch(_token_batch(data))
        step_s = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            float(engine.train_batch(_token_batch(data))["loss"])
            step_s.append(time.perf_counter() - t1)
        ms = sorted(step_s)[len(step_s) // 2] * 1e3
        peak = torch.cuda.max_memory_allocated()
        out[str(policy)] = {"step_ms": ms, "peak_bytes": peak}
        log(f"[remat] GPT-2 1.5B, {engine.train_batch_size}x{seq} tokens, "
            f"remat {policy}: step {ms:.1f} ms median of {steps} "
            f"({', '.join(f'{s * 1e3:.1f}' for s in step_s)}), peak memory "
            f"{peak / 2**30:.2f} GiB")
    del engine
    _free_memory(dev)
    return out


def flash_bias_rows(bias: dict, evo: dict) -> list:
    """Phases 5d and 10's rows of the flash kernels: with the bias at the
    AF2 rows' and the example's shapes (launches: phase 10's timed AF2
    steps and the example's 50 fp32 steps), and in fp32 at GPT-2 1.5B's
    shape (no main path runs fp32 without a bias: launches 0)."""
    import torch

    from deepspeed_tpu_torch.ops.flash_attention import library

    rows = []
    for shape, times, variant, launches, dtype, hd in (
            ("af2_msa_row", bias["biased"]["af2_msa_row"], "bias",
             evo["af2"]["launches"], torch.bfloat16, 32),
            ("evoformer_example", bias["biased"]["evoformer_example"], "bias",
             evo["example"]["torch.float32"]["launches"], torch.float32, 32),
            ("gpt2_1.5b fp32", bias["fp32"], "fp32", {}, torch.float32, 64)):
        for name, line in (("flash_fwd", 43), ("flash_bwd_dq", 228),
                           ("flash_bwd_dkv", 285)):
            rows.append({"name": name, "shape": shape, "route": "cuda",
                         "source": "deepspeed_tpu_torch/ops/csrc/"
                                   + library(name, dtype, hd) + ".cu",
                         "replaces": f"deepspeed_tpu/ops/flash_attention.py:"
                                     f"{line}",
                         "launches": launches.get(name, 0),
                         "max_abs_err": bias["max_abs_err"][variant][name],
                         **{k: times[name][k] for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}})
    return rows


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
    from deepspeed_tpu_torch.models import bert, gpt2, llama2, opt
    from deepspeed_tpu_torch.ops.flash_attention import library

    t0 = time.perf_counter()
    dev = phase_device()
    kern = phase_kernels()
    woq = phase_woq_kernels()
    flash = phase_flash_kernels()
    xent = phase_xent_kernels()
    sparse = phase_sparse_kernels()
    bias = phase_flash_bias_kernels()
    sl = phase_slice()
    woq8 = phase_woq(llama2("7b"), bits=8)
    woq4 = phase_woq(opt("6.7b"), bits=4)
    # phase 6, the unfused reference: fewer steps than the default-config
    # phase, the same depth, so step time and peak memory compare
    unfused = phase_train(warmup=2, steps=4, name="train unfused")
    train = phase_train(gpt2("1.5b"), check="head", name="train default")
    mlm = phase_train(
        bert("large", post_ln=True, embed_norm=True, mlm_transform=True,
             lm_head_bias=True), config=BERT_TRAIN_CONFIG, check="head",
        seq=512, warmup=3, steps=6, fall=0.8, name="train bert mlm")
    for label, r in (("GPT-2 1.5B", train), ("BERT-large", mlm)):
        h = r["heads"]
        log(f"[head] {label}: fused {h['fused']['ms']:.2f} ms and "
            f"{h['fused']['peak_bytes'] / 2**30:.2f} GiB, unfused "
            f"{h['unfused']['ms']:.2f} ms and "
            f"{h['unfused']['peak_bytes'] / 2**30:.2f} GiB per micro-batch, "
            "forward + backward alone")
    if "busy_ms" in unfused:
        h = train["heads"]["unfused"]["ms"] * unfused["gas"]
        log(f"[head] GPT-2 1.5B, fused_xent=False: the unfused head takes "
            f"{h:.2f} ms of the step's {unfused['busy_ms']:.2f} ms of device "
            f"time ({h / unfused['busy_ms']:.1%}); step "
            f"{unfused['step_ms']:.1f} ms and peak "
            f"{unfused['peak_bytes'] / 2**30:.2f} GiB against the default "
            f"config's {train['step_ms']:.1f} ms and "
            f"{train['peak_bytes'] / 2**30:.2f} GiB")
    long = phase_long_train()
    evo = phase_evoformer()
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
    # launches: the GPT-2 1.5B training run's timed steps; the same
    # kernels stand for the TPU's streamed ones (rows 5-7), timed at S 8192
    for name, line, streamed_line in (("flash_fwd", 43, 436),
                                      ("flash_bwd_dq", 228, 533),
                                      ("flash_bwd_dkv", 285, 581)):
        for at, times in ((line, flash[name]),
                          (streamed_line, {**flash["streamed"][name],
                                           "max_abs_err": flash[name][
                                               "max_abs_err"]})):
            kernels.append({"name": name, "route": "cuda",
                            "source": src + library(name, torch.bfloat16,
                                                    64) + ".cu",
                            "replaces": "deepspeed_tpu/ops/flash_attention"
                                        f".py:{at}",
                            "launches": train["launches"][name],
                            **{k: times[k] for k in keys}})
    # launches: the same run (GPT-2 1.5B under its default config)
    for name, line in (("xent_fwd", 49), ("xent_dx", 110), ("xent_dw", 128)):
        kernels.append({"name": name, "route": "cuda", "source": src + "xent.cu",
                        "replaces": f"deepspeed_tpu/ops/xent.py:{line}",
                        "launches": train["launches"][name],
                        **{k: xent[name][k] for k in keys}})
    # launches: phase 9 (GPT-2 1.5B at 8192 tokens, the Fixed layout)
    for name, line in (("sparse_fwd", 184), ("sparse_bwd_dq", 223),
                       ("sparse_bwd_dkv", 252)):
        kernels.append({"name": name, "route": "cuda",
                        "source": src + "sparse_attention.cu",
                        "replaces": f"deepspeed_tpu/ops/sparse_attention.py:"
                                    f"{line}",
                        "launches": long["launches"][name],
                        **{k: sparse[name][k] for k in keys}})
    log("[flash-bias] " + json.dumps({"kernels": flash_bias_rows(bias,
                                                                 evo)}))
    shapes = flash["shapes"]
    log("[flash-fwd] " + json.dumps({
        "shapes": {c: t["flash_fwd"] for c, t in shapes.items()},
        "host": flash["host"], "sass": dev["flash_sass"]["flash_fwd_sm90"]}))
    log("[flash-bwd] " + json.dumps({
        "shapes": {c: {n: t[n] for n in ("flash_bwd_dq", "flash_bwd_dkv")}
                   for c, t in shapes.items()},
        "sass": {k: v for k, v in dev["flash_sass"].items()
                 if k != "flash_fwd_sm90"}}))
    print(json.dumps({"kernels": kernels}))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
