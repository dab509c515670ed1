#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order (phase 14 runs second, right after phase 1, phase 15
right after phase 11, phases 17 and 18 after it, phase 16 last); any
failure raises and the script exits non-zero. The phases that profile a
window (11, 13, 14, 15, 16 and 17) and phases 12 and 18 each run in a
fresh process of their own (this script with
``--phase <name> --result <file>``, its result returned as JSON): late in
one long process a profiled window now and then lost a kernel record
(ROADMAP.md §3), and phases 12's and 18's pinned host buffers stay cached
in the process that allocated them. A child that fails or dies fails the run;
nothing is retried:

1. device: the card's name and power limit; build every CUDA kernel of
   ``deepspeed_tpu_torch/ops/csrc`` (nvcc, sm_90a, one process per source,
   all at once) and print nvcc's register / shared-memory lines; count the
   wgmma and TMA instructions in the SASS (cuobjdump) of the wgmma
   flash forward's and backward pair's libraries (bf16 / fp16, and the
   fp32 forward's and pair's 3xTF32 ones), of the sparse forward's and
   backward pair's and of the xent backward's (each > 0) and the kernels of
   theirs that spill, have a warpgroup wait injected or their wgmma
   serialized by ptxas (none), and print their shared memory (the fp32
   kernels' held to ``flash_fwd_f32_plan`` and ``flash_bwd_f32_plan``, the
   sparse forward's to ``sparse_fwd_plan``, the sparse backward pair's to
   ``sparse_bwd_plan``); the same for the tensor-core ``x @ W``
   kernels of ``woq_matmul.cu`` (mma.sync and TMA loads in their SASS, no
   spill, no injected wait);
2. kernels: each kernel (decode attention, the WOQ GEMMs ``woq_matmul``
   and ``woq_matmul_t``) against its plain PyTorch version on the card, at
   the main paths' shapes and the edge cases, within stated tolerances
   (decode attention also at its split plan's edges, with all rows empty,
   one 32768-position row, hd 40 / 256 and fp32 GQA, rows with L = 0
   exactly 0 and two calls bit-identical; both WOQ GEMMs in fp16 and at
   M 1 / 8 / 16 / 17 on both routes, each line naming its route, two calls
   bit-identical; both kernels at phase 11's slot step: decode attention at
   B 8, cache 1024 with ragged rows and idle ones past the cache, and
   ``woq_matmul`` int8 at M 8 on every Llama-2-7B projection and the
   head; decode attention over the paged pool's gathered view, bf16 and
   int8, bit for bit equal to it over a contiguous cache of the same
   bytes, and the gather timed against its bound); then timed on
   L2-cold inputs (device time: calls captured in a CUDA graph, replays
   timed with CUDA events) beside the plain version (eager calls), the
   PyTorch library call that computes the same function (device time),
   the bound and the host cost of a call: decode attention at Llama-2-7B's
   shape, Llama-2-70B's GQA heads and a B 16 / cache 4096 serving shape
   with ragged lengths (a ``[decode-attn]`` JSON line each), and
   ``woq_matmul`` at every x @ W shape of Llama-2-7B and OPT-6.7B in int8
   and int4 with the layer sums and the host cost of a call (a
   ``[woq-mm]`` JSON line); and at the shapes each rank of a
   tensor-parallel world of 2 / 4 gives them (``phase_tp_kernels``, a
   ``[tp-kernels]`` JSON line): decode attention at Llama-2-7B's heads
   (H = KV = 16 / 8) and the 70B GQA heads at tp 4 and 8 (H 16 / 8, KV 2 /
   1), B 8, cache 1024; ``woq_matmul`` int8, bf16 x, M 8 on Llama-2-7B's
   column shards (fused qkv, ``w_in`` / ``w_gate``) and row shards (``wo``;
   ``w_out`` at tp 2) with fp32 partials (``w_out`` at tp 4 cuts its rows
   off their groups: the per-use dequantize, not launched); ``woq_matmul_t``
   int4 on OPT-6.7B's tied table at V / 2 and V / 4, each one group;
3. slice: ``init_inference(...).generate`` on Llama-2-7B at full width in
   bf16 with seeded random weights (4 prompts x 512 tokens, 128 new
   tokens, greedy), with the kernel's launch count read around that one
   call; the kernel path's logits teacher-forced against the dense
   attention path; a sampled call repeated with the same request seeds;
4. WOQ slice: the same traffic through ``init_inference(..., {"quantize":
   True})`` on Llama-2-7B in int8 (untied head: ``woq_matmul``) and on
   OPT-6.7B in int4 (tied head: ``woq_matmul_t``), both at full width and
   depth, group 128, with every kernel's launch count read around one
   ``generate`` (the routes of every quantized decode projection's
   ``woq_matmul`` and of the tied head's ``woq_matmul_t`` printed, and
   gated to the tensor-core routes on the card); the kernel path's logits
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
   4-way hand split of a 50304-row vocab, combined by hand) and the
   backward call (dx, dW and db) against their plain versions in bf16 at
   GPT-2 1.5B's head shape (T 4092, V 50257, d 1600), BERT-large's (T 8192,
   V 30522, d 1024, with the bias), GPT-2 1.5B's at 8191 tokens and the
   edges (nothing divides, one token, d 2304 and 6144; a target in the
   last valid column, targets outside the vocab, rows with g = 0; the
   backward called twice, bit-identical); the forward timed at the GPT-2
   shape, the backward at all three heads, beside the bound, the plain
   versions and the library (``F.cross_entropy`` of ``F.linear`` and its
   autograd backward), with its host cost, its launch kinds' shares and
   its device time at vocab chunks of 1024, 2048, 4096 and 8192 rows
   (GPT-2 and BERT; an ``[xent-bwd]`` JSON line a shape);
5c. sparse kernels: the block-sparse forward, dq and dk/dv kernels against
   their plain versions in bf16 and fp16 at the slice's shape (B 1, H 25,
   S 8192, hd 64, the default Fixed layout, causal), each of the five
   layouts causal and not, blocks 16, 32 and 128, hd 128, 32 and 16, GQA
   and MQA, one block, a layout whose widest list is far wider than its
   narrowest and one whose last k-block no q-block keeps (each line naming
   the three kernels' libraries: the wgmma ones at blocks 64 and 128, hd
   32-128), the backward pair also fed the kernel forward's lse, a second
   forward and a second backward bit-identical, dk = dv = 0 exactly on the
   k-blocks no q-block keeps; the dense layout through them against the
   flash kernels;
   timed at the slice's shape beside the bound, the plain versions, SDPA
   under the expanded (S, S) boolean mask (forward and its autograd
   backward), the flash kernels on the dense causal problem, the sparse
   kernels in natural block order and the ``mma.sync`` backward pair in
   turns with the wgmma one;
5d. flash kernels with the bias operand and in fp32: the forward, dq
   (with and without dbias) and dk/dv kernels against their plain versions
   in bf16, fp16 and fp32 on every bias layout ((S, S), (H, S, S), (B, H,
   S, S), (B, 1, S, S), (1, H, S, S) and a (1, H, S, S) bias expanded at
   stride 0), bias dtypes other than q's, masks, GQA / MQA, hd 16-128,
   ragged S, dbias exactly 0 above a causal diagonal, a second forward
   bit-identical; the fp32 kernels without a bias on phase 5's cases and
   on S 2048-8192 at hd 32 / 64 (GQA group 8 among them), o exactly 0 on
   rows without a live key; timed at phase 10's two shapes
   (AlphaFold 2's MSA rows in bf16, the DS4Science example in fp32) beside
   the bound, the plain versions and SDPA with the bias as a float
   attn_mask (forward and its autograd backward), and in fp32 at GPT-2
   1.5B's shape beside SDPA in fp32; fp32 work is bounded as 3xTF32 on
   the tensor cores (three tf32 products at 495 TFLOP/s), the CUDA cores'
   67 TFLOP/s line printed beside;
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
   batch, and each head timed alone; launches exact (``xent_fwd`` /
   ``xent_bwd`` 2 / 2 per optimizer step at gas 2, flash as in phase 6);
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
   / 96 / 96 per optimizer step, flash 0, xent 2 / 2);
10. the evoformer block: ``ops.evoformer.evoformer_attention`` (the flash
   kernels with a learned pair bias, its dbias from the dq kernel, gated
   by sigmoid) trained by SGD. (a) ``examples/evoformer_science.py`` at
   its full size (B 4, S 256, H 8, hd 32, a full (B, H, S, S) bias
   projected from the pair representation) from its seeded weights, 50
   steps at lr 0.05 in fp32 (losses within 1e-4 of the plain path's at
   every step; its device time a step and the flash kernels' shares under
   the profiler) and in bf16 (phase 6's gate); (b) AlphaFold 2's MSA
   row-wise gated self-attention with pair bias at 128 clusters x 256
   residues in bf16, one (1, 8, 256, 256) bias shared by the rows, a key
   mask on padded residues: first step against the plain path, then 2 + 5
   steps with ms a step, peak memory against the plain path's and the
   kernels' share of device time. Launches exactly 1 / 1 / 1 a step;
11. serving: ``ServingEngine(init_inference(...), SERVING)`` on Llama-2-7B
   at full width and depth, 8 slots of 1024 positions, prefill chunks of
   256, greedy, (a) in bf16 with 32 requests and (b) in int8 WOQ with 16,
   prompts of 16-768 tokens and 16-128 new ones from seed 0, all submitted
   at t = 0, then ``drain()``; then through the paged pool (``PAGED``:
   pages of 16, 513 of them): (c) 11a's stream and (d) 11b's, their tokens
   equal 11a's / 11b's exactly; (e) 32 requests on 4 system prompts of 512
   tokens with two second turns (copy-on-write), served contiguous and
   paged (a prefix hit rate > 0 and >= 2 copy-on-write copies); (f) the
   first 16 of 11a's requests on 257 pages (evictions or defers > 0); (g)
   the same 16 with int8 KV; every request OK in full, one CUDA graph
   capture of the slot step (its recorded launches: decode attention
   ``n_layer``, ``woq_matmul`` 161 in int8; a profiled window of replays
   shows each of them launched on the device at every replay, by the
   kernel's name), every served token
   within 5% of max |logit| of its row's maximum in one dense
   teacher-forced forward, the replay and the eager slot step from the
   same state giving the same tokens; tokens/s, TTFT, TPOT, the graphed
   and the eager slot step's ms, the device's busy share over serving
   iterations, peak memory and solo ``generate`` parity recorded (a
   ``[serve]`` JSON line each; a ``[serve-paged]`` line sums up 11c-11g
   with the pools' snapshots and bytes);
12. checkpoint and resume: GPT-2 1.5B under ``TRAIN_CONFIG`` at full
   width and depth (18.7 GB of master, mu and nu). Free disk and the
   host's MemAvailable printed first; the tags live under
   ``chiprun_out/phase12_ckpt``, removed at the end. Engine E1 takes 2
   steps, ``save_checkpoint`` (sync, ``verify: "size"``), 2 more steps,
   run twice from one state (bit-identical: the step repeats); a fresh E2
   (another seed) ``load_checkpoint``s the tag and its 2 steps equal E1's
   bit for bit (losses, grad norms, lr, every master / mu / nu leaf, step,
   count, loss scale), with flash 192 / 96 / 96 and xent 2 / 2 launches a
   step; E2 saves async, takes a step while the writer runs, commits; the
   tag verifies and, loaded into E1, equals E2's state at the save. A
   ``[ckpt]`` JSON line: the state bytes, the sync save's wall and GB/s
   split into D2H, write + fsync and manifest, the async save's blocking
   ms and commit seconds, the loads' seconds (host buffers' allocation,
   read + copy) and GB/s, peak memory and free disk;
13. ZeRO over NCCL (``phase_zero``): GPT-2 1.5B under ``TRAIN_CONFIG`` at
   full width and depth. (a) The engine with no process group takes 2
   steps from one host copy of the initial state; its losses, grad norms
   and every master / mu / nu leaf are kept on the host. (b) In a world of
   one over NCCL (``init_distributed``), an engine at ZeRO stage 1, 2 and
   3 in turn takes the same 2 steps from the same state: every loss, grad
   norm and leaf bit-identical to (a), flash 192 / 96 / 96 and xent 2 / 2
   launches a step, and the collectives of a profiled step counted by
   kind (``c10d`` ops) against what the engine's layout issues (stage 3:
   an all-gather and a reduce-scatter per cut leaf, layer and micro-batch,
   and the gathers again in the backward; with a group the model's own
   collectives at tp 1 too, ``tp_train_collectives``), the NCCL kernels by
   name. A
   ``[zero]`` JSON line: per stage the median step, device busy and idle
   in the profiled step, the NCCL kernels' time, peak memory; the card;
14. MoE (``phase_moe``). (a) Mixtral-8x7B (``mixtral("8x7b",
   n_layer=MOE_SERVE_LAYERS, moe_drop_tokens=False)``, 8 experts, top-2,
   GQA 32 / 8) at full width and 16 of its 32 layers (the depth cut in PR
   22 to keep the run inside its limit beside phase 17; at 32 layers, ~48
   GB, one card holds it only in int8), int8 WOQ at group 128, its weights
   drawn on the card layer by layer and
   quantized into preallocated int8 stacks (``_moe_serve_engine``), served
   by phase 11's ``ServingEngine`` (8 slots of 1024, chunks of 256) on
   11b's 16 requests: phase 11's gates, the capture recording 16
   decode-attention and 33 ``woq_matmul`` launches (the fused qkv and
   ``wo`` a layer, the head; the expert banks dequantize at their point of
   use), and the banks' dequantize timed; (b) ``mixtral("8x7b",
   n_layer=2)`` trained at full width (bf16, AdamW, ZeRO 1, remat
   ``dots_saveable``, micro 2 x gas 2 x 1024 tokens, the ``moe`` section):
   phase 6's kernel-vs-plain gate at 2 layers with the tokens whose
   routing differs between the two paths counted, the router fp32 in the
   compute params, flash 8 / 4 / 4 launches a step, a falling loss. A
   ``[moe]`` JSON line.

15. tensor / expert parallelism in a world of one over NCCL
   (``phase_tp``, right after phase 11): each model first serves with no
   process group
   (the references), then ``init_distributed()`` joins a world of one
   rank. (a) Llama-2-7B int8 at full width and 8 of its 32 layers
   (``TP_SERVE_LAYERS``, the depth cut in PR 22 to keep the run inside its
   limit beside phase 17) built with
   ``tensor_parallel: 1`` serves phase 11b's 16 requests contiguous and
   paged: the tokens bit-identical to the reference's, one capture, the collectives the capture recorded and those a
   profiled eager slot step issued (``c10d`` ops by kind) both equal to
   ``tp_collectives(engine)`` (an all-reduce after ``wo`` and after
   ``w_out`` a layer, the embedding's all-reduce, the head's all-gather),
   NCCL's device records in the eager step, and phase 11's launch gates (8
   decode-attention and 41 ``woq_matmul`` launches a replay). A world of
   one runs NCCL's one-rank path: an in-place all-reduce puts no work on
   the device and an all-gather one copy, so NCCL's device records are
   gated in the eager step. (b) A 2-layer Mixtral-8x7B int8 at full
   width with ``expert_parallel: 1``: tokens bit-identical to the same
   engine with no process group, the ``("expert", "model")`` combine among
   the captured collectives, 2 decode-attention and 5 ``woq_matmul``
   launches a replay. A ``[tp]`` JSON line.

16. tensor / expert parallelism in training (``phase_tp_train``). (a) The
   xent kernels at a TP rank's training shapes (``phase_tp_train_kernels``):
   OPT-6.7B's tied head (T 4096, V 50272, d 4096) cut over tp 2, 4 and 8;
   each rank's ``xent_fwd`` in ``partials`` mode on its rows with shifted
   targets, combined with the collectives' arithmetic, then ``xent_bwd``
   with the global lse, against the kernels on the whole head (nll and lse
   within 1e-4, dx summed over the ranks and each dW shard within 2e-2 of
   max |whole|, the backward twice bit-identical), each shard's two calls
   timed beside their bounds; the flash kernels at OPT-6.7B's rank heads (H
   16 / 8 / 4, hd 128, S 2048) against their plain versions and SDPA. (b)
   OPT-6.7B at full width and 4 layers with the fused tied head
   (``TRAIN_CONFIG``, 2048 tokens, ``mesh: {model: 1}``) and phase 14b's
   2-layer Mixtral (``mesh: {expert: 1}``), each trained by the engine
   with no process group, then over NCCL in a world of one through every
   TP and EP branch (the vocab-parallel lookup, Megatron's *f* and *g*,
   ``fused_token_nll_tp``, the expert all-to-all): losses, grad norms and
   every master / mu / nu leaf bit-identical over 2 steps, flash and xent
   launches as the config implies, a profiled step's ``c10d`` collectives
   by kind exactly ``tp_train_collectives(engine)`` and NCCL's records on
   the device; step ms, tokens/s, MFU, peak memory and the device's busy
   share. A ``[tp-train]`` JSON line.

17. self-speculative decoding in the ``ServingEngine`` (``phase_spec``):
   Llama-2-7B at full width and depth, 8 slots of 1024, ``flash_decode``
   off, n-gram 3 drafts of up to 4 tokens verified by one fixed-shape
   5-token forward a step (a second CUDA graph); 17a bf16 over contiguous
   slots, 17b int8 WOQ over the paged pool; 16 requests, half motif-tiled
   prompts (prompt-lookup traffic), half phase 11's. Gates: every request
   served in full; the slot step and the verify each captured once; verify
   steps and accepted drafts; 161 ``woq_matmul`` launches a capture and a
   profiled window of 4 verify replays showing 4 x 161 by name (17b); no
   page leaked; the verify's logits, teacher-forced with the plain lane's
   own tokens from one state, within 5% of max |logit| of the plain
   steps', the eager verify's winners equal to the graphed one's; spec-on
   tokens equal spec-off's or part only where spec-off's top-two gap is at
   most the largest change of a logit difference that teacher-forced
   comparison saw. Recorded: tokens/s, TPOT, accepted tokens a step, spec
   on and off; the verify and plain step times. A ``[spec]`` JSON line;
   phase 2 checks and times ``woq_matmul`` at the verify's M 40 on every
   Llama-2-7B projection and the head (``[woq-mm-verify]``).

18. the KV tiers under the paged ``ServingEngine`` (``phase_tier``, its own
   process, after phase 17): Llama-2-7B bf16 at full width and depth, 8
   slots of 1024, pages of 16, 257 of them, chunks of 256, greedy; 10
   sessions of a 512-token prompt and 64 new tokens, then (after every
   first turn finished) the conversation and 64 more user tokens; a fresh
   engine a run: (e) 1025 pages, every resume a tree hit; (b) a 4 GiB host
   tier; (c) a 1 GiB host tier over a 4 GiB disk rung; (f) (b) with
   demote-ahead and an idle gap; (a) no tier; (d) (b) with int8 KV. Gates:
   every request in full, one capture a run, the tiers restoring with no
   fallback, (c) spilling and restoring from the disk, (f) staging and
   fast-freeing, no page leaked, the restored blocks of (b)'s first
   session bit-identical to their pages before the eviction, the tokens of
   (b), (c), (f) equal to (e)'s, (a) and (d) within phase 11's
   teacher-forced gate. Recorded: second-turn TTFT, the transfers' GB/s,
   the CRCs', admissions' and drains' host seconds, the disk's GB/s with
   O_DIRECT, prefill tokens saved. A ``[tier]`` JSON line; phase 1 also
   builds ``ops/csrc/aio.cpp`` with g++ and prints its command.

``remat_sweep()``, ``woq_probe()`` and ``checkpoint_write_probe()`` are
one-off measurements outside the phases: the default GPT-2 1.5B training
step under each remat policy, the tensor-core ``x @ W`` under each ring
depth and blocks an SM, and the checkpoint's three state files written
with 1-16 threads a file. Those of the serving path are in
``serve_probes.py``.

Before them, a ``[flash-bias]`` line holds the JSON of phases 5d and 10's
kernel rows (each flash kernel with the bias at phase 10's two shapes,
and in fp32 at GPT-2 1.5B's), a ``[flash-fwd]`` line phase 5's forward
timings at its other shapes, the host costs and the forward's SASS counts,
and a ``[flash-bwd]`` line the backward pair's timings at the same shapes
and the SASS counts of its four libraries. The kernels line lists each flash kernel twice: at GPT-2 1.5B's shape (rows 2-4
of PERF.md) and at S 8192, where it stands for the TPU's streamed kernel
(rows 5-7), and the fp32 forward's and backward pair's 3xTF32 kernels
(``flash_fwd_f32``, ``flash_bwd_dq_f32``, ``flash_bwd_dkv_f32``) at the
DS4Science example's shape with phase 10a's launches; each sparse row names
the library phase 9's launches run (the wgmma ones). The decode-attention
and ``woq_matmul`` rows also carry ``serving_launches``: phase 11's device
launches (11a's and 11b's), from the counts the run took: the wrappers'
count over the path less the capture's (the eager warm-up step), plus the
capture's count times the graph's replays; ``paged_serving_launches`` the
same for 11c-11g, ``mixtral_serving_launches`` for 14a, ``tp_launches``
for 15a, 15a paged and 15b, ``spec_serving_launches`` (``woq_matmul``)
for 17a and 17b, with ``verify_layer_int8`` its M 40 layer timing (phase
18's decode-attention launches are on its ``[tier]`` line); those rows and
``woq_matmul_t``'s carry
``tp_rank_shapes``, each rank shape's µs, bound and route; the flash rows
carry ``mixtral_train_launches``, 14b's timed steps'; the xent rows and
the first three flash rows carry ``tp_train_rank_shapes`` (16a: each
rank shard's or rank head count's µs and bound) and ``tp_train_launches``
(16b: each model's launches a step).
The last three lines of standard output are the kernels' JSON, then
``nvidia-smi``'s name and power limit of the card, then the device JSON.
Without a CUDA device, or outside the repository, it exits 1 and prints
no result.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from functools import partial
from pathlib import Path

# when this module was imported: a child's start-up is counted from here
_IMPORTED = time.perf_counter()

PEAK_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12, "torch.float16": 989e12,
                  "torch.float32": 67e12}
# fp32 products as 3xTF32 on the tensor cores: three tf32 products (495
# TFLOP/s dense) per fp32 product, the least time the card takes for the
# flash kernels' fp32 work (67 TFLOP/s is the CUDA cores')
TF32X3_OPS_PER_S = 495e12 / 3
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
    from deepspeed_tpu_torch.ops.flash_attention import (
        F32_FWD_WGMMA_HEAD_DIMS, F32_WGMMA_HEAD_DIMS, flash_bwd_f32_plan,
        flash_fwd_f32_plan)
    from deepspeed_tpu_torch.ops.sparse_attention import (WGMMA_FWD_HEAD_DIMS,
                                                          sparse_bwd_plan,
                                                          sparse_fwd_plan)
    from deepspeed_tpu_torch.platform.device import device_report

    rep = device_report()
    smi = rep["nvidia_smi"]
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"card {rep['name']} count {rep['count']}")
    t0 = time.perf_counter()
    built = builder.build_all()
    log(f"[build] {len(built)} source(s) in {time.perf_counter() - t0:.2f} s")
    for name, info in builder.build_all(builder.host_sources()).items():
        log(f"[build] {name}: g++ {info['seconds']:.2f} s: "
            f"{info['command']}")
    for name, info in built.items():
        log(f"[build] {name}: nvcc {info['seconds']:.2f} s -> {info['path']}")
        for line in info["log"].splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill", "Performance Loss")):
                log(f"[build]   {line.strip()}")
    sass = {}
    for lib in ("flash_fwd_sm90", "flash_bwd_dq_sm90", "flash_bwd_dkv_sm90",
                "flash_fwd_f32_sm90", "flash_bwd_dq_f32_sm90",
                "flash_bwd_dkv_f32_sm90", "sparse_fwd_sm90",
                "sparse_bwd_dq_sm90", "sparse_bwd_dkv_sm90", "xent_bwd_sm90"):
        sass[lib] = sass_counts(built[lib]["path"])
        fit = ptxas_fit(built[lib]["log"])
        log(f"[build] {lib}: SASS instructions {sass[lib]} (HGMMA: wgmma, "
            f"UTMALDG: TMA loads); ptxas: {fit['kernels']} kernels, "
            f"{fit['spilling']} spilling, {fit['injected_waits']} injected "
            "warpgroup waits or serialized wgmma (C7517 / C7519 / C7511 / "
            "C7512)")
        if not sass[lib]["HGMMA"] or not sass[lib]["UTMALDG"]:
            raise AssertionError(f"{lib} has no wgmma or TMA: {sass[lib]}")
        if not fit["kernels"] or fit["spilling"] or fit["injected_waits"]:
            raise AssertionError(f"{lib}: ptxas reports {fit}")
    # the tensor-core x @ W: mma.sync and TMA in its SASS, no spill, no
    # injected wait in its library
    woq = kernel_sass(built["woq_matmul"]["path"], "woq_matmul_mma_kernel")
    fit = ptxas_kernels(built["woq_matmul"]["log"], "woq_matmul_mma_kernel")
    waits = ptxas_fit(built["woq_matmul"]["log"])["injected_waits"]
    log(f"[build] woq_matmul_mma_kernel: {woq['kernels']} kernels, SASS "
        f"instructions {woq['counts']} (HMMA: mma.sync, UTMALDG / UBLKCP: "
        f"TMA / bulk loads); ptxas: {len(fit)} kernels, registers "
        f"{sorted({f['registers'] for f in fit.values()})}, "
        f"{sum(1 for f in fit.values() if f['spill'])} spilling, {waits} "
        "injected warpgroup waits or serialized wgmma (C7517 / C7519 / "
        "C7511 / C7512)")
    if not woq["kernels"] or not woq["counts"]["HMMA"] or not (
            woq["counts"]["UTMALDG"] or woq["counts"]["UBLKCP"]):
        raise AssertionError(f"woq_matmul_mma_kernel has no mma.sync or TMA "
                             f"load: {woq}")
    if not fit or any(f["spill"] for f in fit.values()) or waits:
        raise AssertionError(f"woq_matmul_mma_kernel: ptxas reports {fit}, "
                             f"{waits} injected waits")
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
        # the fp32 pair's shared memory is the plan's
        smem = getattr(builder.load(f"{kernel}_f32_sm90"),
                       f"dstpu_{kernel}_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        plans = {hd: flash_bwd_f32_plan(kernel, hd)
                 for hd in F32_WGMMA_HEAD_DIMS}
        log(f"[build] {kernel}_f32_sm90: dynamic shared memory " + ", ".join(
            f"hd {hd} {smem(hd)} B ({p['stages']} + {p['t_stages']} slots "
            f"of {p['step']} rows, units of {p['unit']})"
            for hd, p in plans.items()))
        if any(smem(hd) != p["smem_bytes"] for hd, p in plans.items()):
            raise AssertionError(f"{kernel}_f32_sm90's shared memory is not "
                                 f"flash_bwd_f32_plan's: {plans}")
    # the fp32 forward's and the sparse kernels' shared memory are their
    # plans'
    for lib, fn, plan, dims in (
            ("flash_fwd_f32_sm90", "dstpu_flash_fwd_f32_smem_bytes",
             flash_fwd_f32_plan, F32_FWD_WGMMA_HEAD_DIMS),
            ("sparse_fwd_sm90", "dstpu_sparse_fwd_smem_bytes",
             sparse_fwd_plan, WGMMA_FWD_HEAD_DIMS),
            ("sparse_bwd_dq_sm90", "dstpu_sparse_bwd_dq_smem_bytes",
             partial(sparse_bwd_plan, "sparse_bwd_dq"), WGMMA_FWD_HEAD_DIMS),
            ("sparse_bwd_dkv_sm90", "dstpu_sparse_bwd_dkv_smem_bytes",
             partial(sparse_bwd_plan, "sparse_bwd_dkv"),
             WGMMA_FWD_HEAD_DIMS)):
        smem = getattr(builder.load(lib), fn)
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        plans = {hd: plan(hd) for hd in dims}
        log(f"[build] {lib}: dynamic shared memory " + ", ".join(
            f"hd {hd} {smem(hd)} B ({p['stages']} stages)"
            for hd, p in plans.items()))
        if any(smem(hd) != p["smem_bytes"] for hd, p in plans.items()):
            raise AssertionError(f"{lib}'s shared memory is not its plan's: "
                                 f"{plans}")
    smem = builder.load("xent_bwd_sm90").dstpu_xent_bwd_smem_bytes
    smem.argtypes, smem.restype = [], ctypes.c_int
    log(f"[build] xent_bwd_sm90: dynamic shared memory {smem()} B")
    xent_sass = sass.pop("xent_bwd_sm90")
    return {"nvidia_smi": smi, "flash_sass": sass, "woq_sass": woq["counts"],
            "xent_sass": xent_sass}


def ptxas_fit(build_log: str) -> dict:
    """From nvcc's ``-Xptxas -v`` output: the kernels it reports, those
    that spill, and the warpgroup waits it injected into wgmma sequences
    (C7517 / C7519) or the wgmma sequences it serialized (C7511: an A
    fragment in accumulator registers; C7512: too few registers), each of
    which serializes the products."""
    import re

    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        build_log)
    return {"kernels": len(spills),
            "spilling": sum(1 for st, ld in spills if int(st) or int(ld)),
            "injected_waits": len(re.findall(r"\(C751[1279]\)",
                                             build_log))}


def ptxas_kernels(build_log: str, name: str) -> dict:
    """From nvcc's ``-Xptxas -v`` output: each kernel whose mangled name
    holds ``name``, with its registers and its spill bytes (stores +
    loads)."""
    import re

    found, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1) if name in m.group(1) else None
            if cur:
                found[cur] = {"registers": 0, "spill": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[cur]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[cur]["registers"] = int(m.group(1))
            cur = None
    return found


def kernel_sass(path: str, name: str) -> dict:
    """Counts of the mma.sync (HMMA), TMA load (UTMALDG) and bulk copy
    (UBLKCP) instructions in the SASS of a library's kernels whose mangled
    names hold ``name`` (cuobjdump), and how many such kernels there are."""
    import subprocess

    from deepspeed_tpu_torch.ops import builder

    tool = Path(builder.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    counts = dict.fromkeys(("HMMA", "UTMALDG", "UBLKCP"), 0)
    kernels = 0
    for part in out.split("Function : ")[1:]:
        if name not in part.split("\n", 1)[0]:
            continue
        kernels += 1
        for k in counts:
            counts[k] += part.count(k)
    return {"kernels": kernels, "counts": counts}


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


PAGE_SIZE = 16          # phase 11's paged streams


def _paged_view_check(gen, slots, max_len, lengths, device, H=32, hd=128,
                      ps=PAGE_SIZE, cfg_layers=32) -> dict:
    """Decode attention over the paged pool's gathered view (``_paged_view``
    at phase 11's slot step: 8 slots of 1024 in pages of 16, shuffled
    tables, the last row on scratch) against decode attention over a
    contiguous cache holding the same bytes, built page by page: bit for
    bit, fp (bf16) and int8 (the view dequantized against the pages'
    dequantized bytes). On the card the gather of one layer's K and V is
    timed against its bound (``cfg_layers`` of them a slot step)."""
    import torch

    from deepspeed_tpu_torch.inference.decode import _paged_view
    from deepspeed_tpu_torch.ops import decode_attention as da

    n = max_len // ps
    pages = 1 + slots * n
    perm = torch.randperm(pages - 1, generator=torch.Generator().manual_seed(
        5)) + 1
    table = perm[:slots * n].reshape(slots, n).to(torch.int32)
    table[-1] = 0                                     # an idle row: scratch
    table = table.to(device)
    mk = partial(torch.randn, generator=gen, device=device)
    q = mk((slots, 1, H, hd)).to(torch.bfloat16)
    length = torch.tensor(lengths, dtype=torch.int32, device=device)
    out = {}
    for kind in ("bf16", "int8"):
        if kind == "bf16":
            pk, pv = (mk((pages, H, ps, hd)).to(torch.bfloat16)
                      for _ in range(2))
            sk = sv = None
            dense = (pk, pv)
        else:
            pk, pv = (torch.randint(-127, 128, (pages, H, ps, hd),
                                    generator=gen, device=device,
                                    dtype=torch.int8) for _ in range(2))
            sk, sv = (torch.rand((pages, H, ps), generator=gen,
                                 device=device) * 0.02 for _ in range(2))
            dense = tuple((p.float() * s[..., None]).to(torch.bfloat16)
                          for p, s in ((pk, sk), (pv, sv)))
        ck = torch.empty((slots, H, max_len, hd), dtype=torch.bfloat16,
                         device=device)
        cv = torch.empty_like(ck)
        for b in range(slots):
            for j in range(n):
                page = int(table[b, j])
                ck[b, :, j * ps:(j + 1) * ps] = dense[0][page]
                cv[b, :, j * ps:(j + 1) * ps] = dense[1][page]
        vk = _paged_view(pk, sk, table, torch.bfloat16)
        vv = _paged_view(pv, sv, table, torch.bfloat16)
        got = da.decode_attention(q, vk, vv, length)
        want = da.decode_attention(q, ck, cv, length)
        same = torch.equal(vk, ck) and torch.equal(vv, cv) \
            and torch.equal(got, want)
        log(f"[kernel] decode_attention over the paged view ({kind} pool, "
            f"{slots} slots of {max_len} in pages of {ps}, lengths "
            f"{list(lengths)}): view == contiguous bytes and attention "
            f"bit-identical {same} {'ok' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"decode attention over the {kind} paged "
                                 "view differs from the contiguous cache's")
        out[kind] = same
        if str(device).startswith("cuda"):
            # the gather's cost a layer (K and V), device time, against its
            # bound: the pages' bytes read (scales too) and the view written
            ms = device_ms(lambda i: (_paged_view(pk, sk, table,
                                                  torch.bfloat16),
                                      _paged_view(pv, sv, table,
                                                  torch.bfloat16)), 1, 200)
            nbytes = 2 * (table.numel() * pk[0].nbytes
                          + (0 if sk is None else table.numel() * sk[0].nbytes)
                          + vk.nbytes)
            bound = nbytes / PEAK_BYTES_PER_S * 1e3
            out[f"{kind}_view_ms"] = ms
            out[f"{kind}_view_bound_ms"] = bound
            log(f"[kernel] the paged view's gather ({kind} pool), K and V of "
                f"one layer: {ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us "
                f"(bytes: {nbytes} B), {bound / ms:.1%} of it; "
                f"x {cfg_layers} layers {ms * cfg_layers:.3f} ms a step")
        del pk, pv, sk, sv, dense, ck, cv, vk, vv, got, want
    return out


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
    # phase 11's slot step: ragged rows, a full one and idle ones whose
    # length has grown past the cache (the kernel clamps it to S)
    slots, max_len = SERVING["slots"], SERVING["max_len"]
    serve_lengths = tuple((1 + 131 * i) % max_len for i in range(slots - 3)) \
        + (max_len - 1, max_len, max_len + 476)
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
        "serving": dict(B=slots, S=max_len, H=32, KV=32, hd=128,
                        lengths=serve_lengths),
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
    result = {"max_abs_err": errs["main"], "paged": _paged_view_check(
        gen, slots, max_len, serve_lengths, device)}
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
# OPT-6.7B's own x @ W shapes (d_ff 16384; wqkv and wo are Llama's), once
# per OPT layer each
WOQ_MM_OPT = (("w_in", 4096, 16384, 1, None), ("w_out", 16384, 4096, 1, None))
# (name, V, K, group) of x @ W.T, fp32 out: the OPT-6.7B tied head (50272
# rows: one group) and a multi-group table
WOQ_T_MAIN = (("opt_head", 50272, 4096, 128), ("table_32000", 32000, 4096, 128))
# edge cases: (kernel, M, rows, cols, group, bits, x dtype, out dtype)
WOQ_EDGES = (
    ("mm", 1, 4096, 4096, 128, 8, "bfloat16", None),
    ("mm", 17, 4096, 4096, 128, 4, "bfloat16", None),
    # the tensor-core route: M 8 / 16 / 17, fp16 x, fp32 out, one group of
    # 1600 rows split over K (GPT-2 1.5B's d_model)
    ("mm", 8, 4096, 11008, 128, 4, "float16", None),
    ("mm", 16, 4096, 4096, 128, 8, "bfloat16", None),
    ("mm", 17, 11008, 4096, 128, 8, "float16", "float32"),
    ("mm", 4, 4096, 32000, 128, 4, "float16", "float32"),
    ("mm", 4, 1600, 4800, 128, 8, "bfloat16", None),
    ("mm", 12, 1600, 6400, 128, 4, "bfloat16", "float32"),
    # the CUDA-core route: fp32 x, a group of 1000 rows, a ragged N
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
    """The route of the call: ``woq_route`` for x @ W, ``woq_t_route`` for
    x @ W.T (``"mma"`` or ``"simt"``)."""
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    if kernel == "mm":
        return wm.woq_route(x.dtype, x.shape[0], rows, cols, group)
    return wm.woq_t_route(x.dtype, cols, rows, group)


def _woq_check(gen, kernel, M, rows, cols, group, bits, xdtype, out, device):
    """Kernel vs plain on one case, and a second call bit-identical;
    returns (max abs err, share)."""
    import torch

    x, qt = _woq_case(gen, kernel, M, rows, cols, group, bits, xdtype, device)
    fn, plain = _woq_fns(kernel)
    kw = dict(group_size=qt.group_size, bits=qt.bits,
              out_dtype=out and getattr(torch, out))
    got = fn(x, qt.q, qt.scale, **kw)
    again = fn(x, qt.q, qt.scale, **kw)
    want = plain(x, qt.q, qt.scale, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    share = err / max(want.float().abs().max().item(), 1e-30)
    tol = WOQ_TOL_SHARE[str(got.dtype)]
    same = torch.equal(got, again)
    ok = math.isfinite(err) and share <= tol and same
    route = _woq_route(kernel, x, rows, cols, qt.group_size)
    log(f"[kernel] {fn.__name__:12s} (route {route}) M{M} {rows}x{cols} "
        f"g{qt.group_size} int{qt.bits} x {xdtype} out {got.dtype}: "
        f"max_abs_err {err:.3e}, {share:.2e} of max |out| (tol {tol:.2e}), "
        f"repeat bit-identical {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{fn.__name__} M{M} {rows}x{cols} int{bits}: "
                             f"share {share} > {tol} or repeat differs")
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
    route = _woq_route(kernel, x, rows, cols, gs)
    log(f"[kernel] {fn.__name__:12s} (route {route}) "
        f"M{M} {rows}x{cols} g{gs} int{bits} "
        f"out {out or 'bf16'}: kernel {kernel_ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, torch.matmul bf16 dense "
        f"{library_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}: {nbytes} B, "
        f"{ops} flop), kernel at {bound_ms / kernel_ms:.1%} of the bound")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "t_bytes": t_bytes, "t_ops": t_ops,
            "route": route}


WOQ_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "t_bytes", "t_ops")


def _layer_sum(parts) -> dict:
    """The sum of (times, timing) pairs' numbers: one layer's projections."""
    total = dict.fromkeys(WOQ_KEYS, 0.0)
    for times, t in parts:
        for k in WOQ_KEYS:
            total[k] += times * t[k]
    return total


# the verify forward's M: phase 17's 8 slots x (max_draft 4 + 1)
SPEC_VERIFY_M = 8 * 5


def phase_woq_kernels(device="cuda", iters=200, main=WOQ_MM_MAIN,
                      main_t=WOQ_T_MAIN, edges=WOQ_EDGES, M=4,
                      main_opt=WOQ_MM_OPT) -> dict:
    """Both WOQ kernels against their plain versions at the main shapes of
    both models (int8 and int4) and the edge cases, each line naming its
    route; on the card, every x @ W shape timed in int8 and int4 (a
    ``[woq-mm]`` JSON line), the x @ W.T head shapes, and the host cost of
    a call; and every Llama-2-7B projection and the head at the
    speculative verify's M (``SPEC_VERIFY_M``), checked with the
    ``woq_split_plan`` each runs (logged) and timed (``[woq-mm-verify]``).
    Returns the JSON numbers of each kernel: ``woq_matmul`` summed over one
    Llama-2-7B int8 layer's projections, ``woq_matmul_t`` at the OPT-6.7B
    int4 tied head."""
    import torch

    from deepspeed_tpu_torch.ops.woq_matmul import woq_split_plan

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
    # phase 11's int8 slot step: M = the slots, every Llama-2-7B projection
    # and the head (fp32 out)
    for _, K, N, _, out in main:
        _woq_check(gen, "mm", SERVING["slots"], K, N, 128, 8, "bfloat16", out,
                   device)
    # phase 17's verify forward: M = slots x (max_draft + 1), int8 and int4,
    # each with the split plan it runs
    verify_m = SPEC_VERIFY_M
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device == "cuda" else 132)
    plans = {}
    for bits in (8, 4):
        for name, K, N, _, out in main:
            plans[name] = woq_split_plan(verify_m, K, N, 128, sms)
            e, _ = _woq_check(gen, "mm", verify_m, K, N, 128, bits,
                              "bfloat16", out, device)
            errs["mm"] = max(errs["mm"], e)
    log(f"[kernel] woq_split_plan at the verify's M {verify_m} on {sms} SMs: "
        + json.dumps(plans))
    result = {"woq_matmul": {"max_abs_err": errs["mm"]},
              "woq_matmul_t": {"max_abs_err": errs["mmt"]}}
    if device != "cuda":
        return result

    shapes = {}
    for bits in (8, 4):
        for name, K, N, per_layer, out in main + tuple(
                (f"opt_{n}",) + tuple(rest) for n, *rest in main_opt):
            shapes[f"{name} int{bits}"] = _woq_timing(
                gen, "mm", M, K, N, 128, bits, out, iters)
        for name, V, K, group in main_t:
            t = _woq_timing(gen, "mmt", M, V, K, group, bits, "float32",
                            iters)
            if bits == 4 and name == "opt_head":
                head = t
    llama = {b: _layer_sum((per, shapes[f"{name} int{b}"])
                           for name, _, _, per, _ in main) for b in (8, 4)}
    opt4 = _layer_sum([(1, shapes["wqkv int4"]), (1, shapes["wo int4"])]
                      + [(1, shapes[f"opt_{n} int4"]) for n, *_ in main_opt])
    layer = llama[8]
    for r, t in (("woq_matmul", layer), ("woq_matmul_t", head)):
        result[r].update({k: t[k] for k in WOQ_KEYS[:4]})
        result[r]["bound_by"] = ("bytes" if t["t_bytes"] >= t["t_ops"]
                                 else "operations")
    result["woq_matmul"]["route"] = shapes["wo int8"]["route"]
    for label, t in (("one Llama-2-7B int8 layer (wqkv + wo + w_in + w_gate "
                      "+ w_out)", llama[8]),
                     ("one Llama-2-7B int4 layer", llama[4]),
                     ("one OPT-6.7B int4 layer (wqkv + wo + w_in + w_out)",
                      opt4)):
        log(f"[kernel] woq_matmul, {label}, M {M}: kernel "
            f"{t['ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us "
            f"({t['bound_ms'] / t['ms']:.1%}), torch.matmul bf16 dense "
            f"{t['library_ms'] * 1e3:.2f} us "
            f"({t['ms'] / t['library_ms']:.2f}x)")

    # the host's cost of one call at the wo shape: the decode loop is eager
    from deepspeed_tpu_torch.ops import woq_matmul as wm

    x, qt = _woq_case(gen, "mm", M, 4096, 4096, 128, 8, "bfloat16", device)
    w = torch.randn((4096, 4096), generator=gen, device=device,
                    dtype=torch.bfloat16)
    woq_host = host_us(lambda: wm.woq_matmul(x, qt.q, qt.scale,
                                             group_size=qt.group_size))
    mm_host = host_us(lambda: torch.matmul(x, w))
    log(f"[kernel] host cost per call, M {M} 4096x4096 int8: woq_matmul "
        f"{woq_host:.2f} us (route "
        f"{wm.woq_route(x.dtype, M, 4096, 4096, qt.group_size)}, one "
        f"launch), torch.matmul on the dense bf16 weight {mm_host:.2f} us")
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
    # the verify's M: every Llama-2-7B projection and the head timed in
    # int8 and int4, against their bound and cuBLAS on the dense bf16 weight
    verify = {f"{name} int{bits}": _woq_timing(gen, "mm", verify_m, K, N, 128,
                                               bits, out, iters // 2)
              for bits in (8, 4) for name, K, N, _, out in main}
    for b in (8, 4):
        t = _layer_sum((per, verify[f"{name} int{b}"])
                       for name, _, _, per, _ in main)
        log(f"[kernel] woq_matmul, one Llama-2-7B int{b} layer, M "
            f"{verify_m}: kernel {t['ms'] * 1e3:.2f} us, bound "
            f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_ms'] / t['ms']:.1%}), "
            f"torch.matmul bf16 dense {t['library_ms'] * 1e3:.2f} us "
            f"({t['ms'] / t['library_ms']:.2f}x)")
        verify[f"layer int{b}"] = t
    result["woq_matmul"]["verify"] = verify
    log("[woq-mm-verify] " + json.dumps({"M": verify_m, "plans": plans,
                                         "shapes": verify}))
    log("[woq-mm] " + json.dumps({
        "M": M, "shapes": {k: {n: v[n] for n in ("ms", "bound_ms",
                                                  "library_ms", "plain_ms",
                                                  "route")}
                           for k, v in shapes.items()},
        "layers": {"llama_int8": llama[8], "llama_int4": llama[4],
                   "opt_int4": opt4},
        "host_us": {"woq_matmul": woq_host, "torch_matmul": mm_host}}))
    return result


def woq_probe(shapes=(("wo", 4096, 4096), ("wqkv", 4096, 12288)),
              stages=(2, 3, 4), per_sm=(1, 2, 3), M=4, iters=400) -> list:
    """A one-off measurement outside the phases: the tensor-core x @ W
    (int8 and int4, bf16 x, M 4, group 128) under each ring depth (whole
    int8 stages: q 16 KB + x 2 KB) and each plan's blocks an SM, device
    time on L2-cold weights as phase 2 times it. Run: ``python3 -c
    "import chip_smoke as c; c.woq_probe()"`` on the card."""
    import torch

    from deepspeed_tpu_torch.ops import woq_matmul as wm

    rows = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, K, N in shapes:
        for bits in (8, 4):
            x, qt = _woq_case(gen, "mm", M, K, N, 128, bits, "bfloat16",
                              "cuda")
            set_bytes = qt.q.numel() + qt.scale.numel() * 4
            n = max(2, -(-200 * 2**20 // set_bytes))
            sets = [(torch.randint(-128, 128, qt.q.shape, generator=gen,
                                   device="cuda", dtype=torch.int8),
                     torch.rand(qt.scale.shape, generator=gen,
                                device="cuda") * 0.01) for _ in range(n)]
            out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
            want = wm.woq_matmul_plain(x, *sets[0], group_size=128,
                                       bits=bits)
            stage = (16384 if bits == 8 else 8192) + 2048
            for ns in stages:
                for bps in per_sm:
                    plan = wm.woq_split_plan(M, K, N, 128, sms,
                                             blocks_per_sm=bps,
                                             ring_bytes=ns * 18432)

                    def call(i, plan=plan):
                        err = wm._launch_mma(x, *sets[i % n], out, 128, bits,
                                             plan)
                        if err:
                            raise RuntimeError(f"launch failed: {err}")

                    call(0)
                    torch.cuda.synchronize()
                    share = ((out.float() - want.float()).abs().max()
                             / want.float().abs().max()).item()
                    if share > WOQ_TOL_SHARE["torch.bfloat16"]:
                        raise AssertionError(f"probe {name} int{bits}: "
                                             f"{share}")
                    us = device_ms(call, n, iters) * 1e3
                    row = {"shape": name, "bits": bits, "stages":
                           (ns * 18432) // stage, "int8_stages": ns,
                           "blocks_per_sm": bps, "blocks": plan["blocks"],
                           "nsplit": plan["nsplit"], "us": us}
                    rows.append(row)
                    log(f"[woq-probe] {json.dumps(row)}")
            del sets
    return rows


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
    # every quantized x @ W of the decode step on woq_route's tensor-core
    # route (the stacked layer leaves and an untied head)
    from deepspeed_tpu_torch.inference.quantization import QuantizedTensor

    mm_routes = {}
    for name, leaf in engine.params.items():
        if not isinstance(leaf, QuantizedTensor) or not (
                name.startswith("layers.") or name == "lm_head"):
            continue
        K, N = leaf.shape[-2:]
        mm_routes[name] = wm.woq_route(cfg.dtype, batch, K, N,
                                       leaf.group_size)
    log(f"{tag} woq_matmul routes of the decode projections (M {batch}): "
        f"{mm_routes}")
    if on_card and set(mm_routes.values()) != {"mma"}:
        raise AssertionError(f"{tag} a decode projection is off the "
                             f"tensor-core route: {mm_routes}")
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
            for name in ("woq_matmul_mma_kernel", "woq_matmul_kernel",
                         "woq_reduce_kernel", "woq_matmul_t_kernel",
                         "woq_matmul_t_mma_kernel"):
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
            "head_route": route, "mm_routes": mm_routes}


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
# phase 5d's fp32 cases beyond phase 5's: the longest sums a dk/dv unit of
# the 3xTF32 wgmma pair runs (G * S / 32 steps of 32 queries), at hd 64
# and 32, causal and not, GQA group 8. ALiBi only causal: without the cut
# its slope 0.5 lifts scores to ~S / 2, where fp32's own rounding of a
# score (2^-11 at 4096) moves p by more than the 1e-4 gate
FLASH_F32_LONG_CASES = (
    ("f32_hd64_4096", 1, 8, 8, 4096, 64, True, None, False),
    ("f32_hd64_8192", 1, 4, 4, 8192, 64, False, None, False),
    ("f32_hd64_gqa8_2048", 1, 16, 2, 2048, 64, True, None, False),
    ("f32_hd32_gqa8_8192", 1, 8, 1, 8192, 32, True, "left_pad", True),
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
    products of 2·B·H·S²·hd, halved when causal) at the tensor cores' rate
    for the operands' type (989 TFLOP/s bf16 / fp16; fp32 as 3xTF32, three
    tf32 products at 495 TFLOP/s: 165) against each input read and each
    output written once at 3.35 TB/s: ``side_bytes`` (the bias as stored
    and the (B, S) key mask) in each kernel, ``dbias_bytes`` as dq writes
    them. For fp32 ``cuda_core_ms`` is the same work at the CUDA cores'
    67 TFLOP/s, printed beside the bound: fp32 work off the tensor cores
    could not beat it."""
    prod = 2 * B * H * S * S * hd / (2 if causal else 1)
    qb, kvb, rowb = B * S * H * hd * esize, B * S * KV * hd * esize, B * H * S * 4
    work = {"flash_fwd": (2 * prod, 2 * qb + 2 * kvb + rowb + side_bytes),
            "flash_bwd_dq": (3 * prod, 3 * qb + 2 * kvb + 2 * rowb
                             + side_bytes + dbias_bytes),
            "flash_bwd_dkv": (4 * prod, 2 * qb + 4 * kvb + 2 * rowb
                              + side_bytes)}
    rate = TF32X3_OPS_PER_S if dtype == "torch.float32" \
        else PEAK_OPS_PER_S[dtype]
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / rate * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes), "ops": ops,
                     "bytes": nbytes, "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
        if dtype == "torch.float32":
            out[name]["cuda_core_ms"] = max(
                ops / PEAK_OPS_PER_S[dtype] * 1e3, t_bytes)
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
# tokens), BERT-large's MLM head (16 x 512 tokens, decoder bias), GPT-2
# 1.5B's at 8191 tokens (phase 9's micro-batch of 1 x 8192), then the
# edges: nothing divides a tile, one token, a d past a 128-column tile, the
# widest eligible d
XENT_CASES = (
    ("gpt2_1.5b", 4092, 50257, 1600, False),
    ("bert_large", 8192, 30522, 1024, True),
    ("gpt2_1.5b_8192", 8191, 50257, 1600, False),
    ("ragged", 77, 1000, 64, True),
    ("one_token", 1, 1000, 64, False),
    ("d_2304", 300, 3000, 2304, True),
    ("d_6144", 256, 2000, 6144, True),
)
# the backward is timed at the main paths' three heads; the vocab chunk is
# probed at the first two
XENT_TIMED = ("gpt2_1.5b", "bert_large", "gpt2_1.5b_8192")
XENT_VC_PROBE = (1024, 2048, 4096, 8192)
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
    """Least time of the forward and of the backward call on an H100, each
    input read and each output written once at 3.35 TB/s against the
    products at 989 TFLOP/s: 2 T V d FLOPs for the forward; for the
    backward (dx, dW and db) one recompute of the logits and two products,
    6 T V d. ``old_ops`` is the count of the pair of kernels before the
    backward formed each logits tile once (4 T V d for dx and again for
    dW), kept so the earlier rows can be read."""
    base = 2 * (T * d + V * d) + (2 * V if bias else 0) + 4 * T
    work = {"xent_fwd": (2 * T * V * d, base + 8 * T),
            "xent_bwd": (6 * T * V * d,
                         base + 8 * T + 2 * T * d + 2 * V * d + 4 * V)}
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_OPS_PER_S["torch.bfloat16"] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = {"bound_ms": max(t_ops, t_bytes), "ops": ops,
                     "bytes": nbytes, "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
    out["xent_bwd"]["old_ops"] = 8 * T * V * d
    return out


def phase_xent_kernels(device="cuda", cases=XENT_CASES, dtype=None,
                       tp_vocab=XENT_TP_VOCAB, iters=20,
                       timed=XENT_TIMED, vc_probe=XENT_VC_PROBE) -> dict:
    """The forward and the backward call against their plain versions on
    every case (the backward fed the plain forward's lse; called twice, bit
    for bit the same), the ``partials`` mode on each shard of a hand split
    of the vocab, combined by hand and held against the full forward; on
    the card, the forward timed at the first (GPT-2 1.5B's) shape and the
    backward at the ``timed`` shapes beside the bound, the plain version
    and the library, with its launch kinds' shares and the ``vc_probe``
    chunk widths. Rows ``xent_dx`` and ``xent_dw`` of the result both stand
    for the one backward call (TPU kernels #11-#12): dx's worst error and
    dW / db's, the same times."""
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
        dx, dw, db = xe.xent_bwd(x, w, b, t, lse_p, g)
        again = xe.xent_bwd(x, w, b, t, lse_p, g)
        sync()
        same = all(bool(torch.equal(a, r)) for a, r in zip((dx, dw, db),
                                                           again))
        pairs = {"nll": (nll, nll_p), "lse": (lse, lse_p), "dx": (dx, dx_p),
                 "dw": (dw, dw_p), "db": (db, db_p)}
        shares = {k: _share(a, r) for k, (a, r) in pairs.items()}
        finite = all(bool(torch.isfinite(a).all()) for a, _ in pairs.values())
        # masked rows take exactly no gradient; a target past the vocab or
        # below 0 leaves nll = lse
        exact = not bool(dx[::7].any()) and (
            T <= 2 or bool((nll[1:3] == lse[1:3]).all()))
        ok = finite and exact and same and all(
            shares[k] <= XENT_TOL_SHARE[k] for k in shares)
        log(f"[xent] {name:14s} T{T} V{V} d{d} bias {bias} {dtype}: "
            + ", ".join(f"{k} {v:.2e}" for k, v in shares.items())
            + f" of max |plain| (tol {XENT_TOL_SHARE}); g=0 rows and "
            f"out-of-vocab targets exact {exact}, repeat bit-identical "
            f"{same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"xent {name}: {shares}, finite {finite}, "
                                 f"exact {exact}, repeat {same}")
        for n, keys in (("xent_fwd", ("nll", "lse")), ("xent_dx", ("dx",)),
                        ("xent_dw", ("dw", "db"))):
            for k in keys:
                a, r = pairs[k]
                worst[n] = max(worst[n],
                               (a.float() - r.float()).abs().max().item())
        del x, w, b, dx, dw, dx_p, dw_p, pairs, again

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
    by_name = {c[0]: c for c in cases}
    result["xent_fwd"].update(_xent_fwd_timing(gen, cases[0], iters))
    result["shapes"] = {n: _xent_bwd_timing(gen, by_name[n], iters,
                                            vc_probe if i < 2 else ())
                        for i, n in enumerate(timed)}
    first = result["shapes"][timed[0]]
    for n in ("xent_dx", "xent_dw"):
        result[n].update({k: first[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return result


def _xent_sets(gen, case, k=2):
    """``k`` operand sets of a case in bf16 on the card with the plain
    forward's lse (one table alone passes the 50 MB L2)."""
    import torch

    from deepspeed_tpu_torch.ops import xent as xe

    _, T, V, d, bias = case
    sets = []
    for _ in range(k):
        x, w, b, t, g = _xent_case(gen, T, V, d, bias, torch.bfloat16, "cuda")
        lse = xe.xent_fwd_plain(x, w, b, t)[1]
        sets.append((x, w, b, t, lse, g))
    return sets


def _xent_library(sets, V):
    """The library calls the port never makes, device-timed: ``F.
    cross_entropy(F.linear(x, w, b).float(), t)`` and its autograd backward
    (forward + backward captured together, minus the forward)."""
    import torch
    import torch.nn.functional as F

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
        lib_f = device_ms(lib_fwd, 2, 20)
    return lib_f, device_ms(lib_fwd_bwd, 2, 20) - lib_f


def _xent_fwd_timing(gen, case, iters) -> dict:
    """The forward at one case's shape: kernel, plain, bound and the
    library's forward."""
    from deepspeed_tpu_torch.ops import xent as xe

    name, T, V, d, bias = case
    sets = _xent_sets(gen, case)
    ms = device_ms(lambda i: xe.xent_fwd(*sets[i % 2][:4]), 2, iters)
    plain = time_ms(lambda i: xe.xent_fwd_plain(*sets[i % 2][:4]),
                    max(iters // 10, 3))
    lib_f, _ = _xent_library(sets, V)
    b = xent_bound(T, V, d, bias)["xent_fwd"]
    log(f"[xent] xent_fwd {name} T{T} V{V} d{d} bf16: kernel {ms * 1e3:.2f} "
        f"us, plain {plain * 1e3:.2f} us, bound {b['bound_ms'] * 1e3:.2f} us "
        f"({b['bound_by']}: {b['bytes']} B, {b['ops']:.4g} flop), kernel at "
        f"{b['bound_ms'] / ms:.1%} of the bound; F.cross_entropy(F.linear(x, "
        f"w).float()) forward {lib_f * 1e3:.2f} us (device, not called by the "
        "port)")
    return dict(ms=ms, plain_ms=plain, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], library_ms=lib_f)


def _xent_bwd_timing(gen, case, iters, vc_probe=()) -> dict:
    """The backward call at one case's shape: device time (CUDA graph
    replays), the plain version (eager), the library's autograd backward,
    the bound (6 T V d; the old pair's 8 T V d beside it), the host cost of
    a call, each launch kind's share of the call's device time (profiler)
    and the call's device time at each ``vc_probe`` chunk width. Prints one
    ``[xent-bwd]`` JSON line."""
    import torch

    from deepspeed_tpu_torch.ops import xent as xe

    name, T, V, d, bias = case
    sets = _xent_sets(gen, case)
    plan = xe.xent_bwd_plan(T, V, d, torch.cuda.get_device_properties(
        0).multi_processor_count)
    ms = device_ms(lambda i: xe.xent_bwd(*sets[i % 2]), 2, iters)
    plain = time_ms(lambda i: xe.xent_bwd_plain(*sets[i % 2]), 3)
    _, lib_b = _xent_library(sets, V)
    host = host_us(lambda: xe.xent_bwd(*sets[0]), calls=8)
    prof = profile_calls(lambda: [xe.xent_bwd(*sets[i % 2])
                                  for i in range(4)], 4, f"xent_bwd {name}")
    kinds = {}
    if prof:
        for k in ("xent_dl_kernel", "xent_prod_kernel"):
            kinds[k] = sum(v for n, v in prof["by_name"].items()
                           if k in n) / prof["busy"]
    probe = {vc: device_ms(lambda i, vc=vc: xe.xent_bwd(*sets[i % 2], vc=vc),
                           2, iters) for vc in vc_probe}
    b = xent_bound(T, V, d, bias)["xent_bwd"]
    old = b["old_ops"] / PEAK_OPS_PER_S["torch.bfloat16"] * 1e3
    out = dict(ms=ms, plain_ms=plain, bound_ms=b["bound_ms"],
               bound_by=b["bound_by"], library_ms=lib_b, host_us=host,
               launches_per_call=plan["launches"], vc=plan["vc"],
               kind_shares=kinds, vc_probe_ms={str(k): v
                                               for k, v in probe.items()},
               old_bound_ms=old, ops=b["ops"], bytes=b["bytes"])
    log(f"[xent] xent_bwd {name} T{T} V{V} d{d} bias {bias} bf16: "
        f"{ms * 1e3:.2f} us a call ({plan['launches']} launches, vc "
        f"{plan['vc']}), plain {plain * 1e3:.2f} us, bound "
        f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}: 6 T V d = "
        f"{b['ops']:.4g} flop, {b['bytes']} B; the old pair's 8 T V d: "
        f"{old * 1e3:.2f} us), at {b['bound_ms'] / ms:.1%} of the bound; "
        f"library autograd backward {lib_b * 1e3:.2f} us ({ms / lib_b:.2f}x);"
        f" host {host:.1f} us a call; launch kinds "
        + ", ".join(f"{k} {v:.1%}" for k, v in kinds.items())
        + "; vc probe " + ", ".join(f"{k}: {v * 1e3:.2f} us"
                                    for k, v in probe.items()))
    log("[xent-bwd] " + json.dumps({name: out}))
    del sets
    return out


# ------------------------------------------------------- phase 5c, sparse
# (name, B, H, KV, S, hd, causal, config class, its fields): the slice's
# shape first (GPT-2 1.5B's heads at 8192 tokens under the default Fixed
# layout); then each layout at its defaults (block 64), causal and not;
# blocks 16, 32 and 128; hd 128 and 16; GQA and MQA; one block (S ==
# block); a layout whose global row keeps every block and whose other rows
# keep one or two without block 0, so a kernel that read its lists past
# k_n / q_n (whose padding is 0, a valid index) would add block 0; hd 32 at
# blocks 64 and 128 (the wgmma kernels' narrowest tiles, GQA); and a layout
# whose last k-block no q-block keeps (dk = dv = 0 there, exactly)
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
    ("fixed_hd32", 1, 8, 8, 2048, 32, True, "FixedSparsityConfig", {}),
    ("bigbird_gqa_hd32_block128_full", 1, 8, 2, 2048, 32, False,
     "BigBirdSparsityConfig", {"block": 128}),
    ("previous_block_empty_columns", 1, 4, 2, 1024, 64, True,
     "PreviousBlockConfig", {}),
)
# the dense layout through the sparse kernels against the flash kernels on
# the same inputs, (name, B, H, KV, S, hd, causal): the same function, so
# phase 5's tolerances
SPARSE_VS_FLASH = (("dense_vs_flash", 1, 25, 25, 2048, 64, True),
                   ("dense_vs_flash_gqa_full", 2, 4, 2, 1024, 128, False))
SPARSE_NAMES = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")


def _previous_block_layout(self, n: int):
    """Block i keeps blocks 0 and i - 1 and not itself: under the causal
    cut the last k-block's q-list is empty."""
    import numpy as np

    lay = np.zeros((n, n), bool)
    lay[:, 0] = True
    lay[np.arange(1, n), np.arange(n - 1)] = True
    return lay


def _sparse_config(cls: str, fields: dict):
    """The sparse module's config class ``cls``, or ``PreviousBlockConfig``
    (``_previous_block_layout``)."""
    import dataclasses

    from deepspeed_tpu_torch.ops import sparse_attention as sa

    if cls != "PreviousBlockConfig":
        return getattr(sa, cls)(**fields)
    return dataclasses.make_dataclass(
        cls, [], bases=(sa.SparsityConfig,), frozen=True,
        namespace={"make_layout": _previous_block_layout})(**fields)


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
            # the backward pair fed the kernel forward's o and lse, as
            # training feeds it, against the plain backward of the plain
            # forward's
            delta_k = fa.attention_delta(o, do)
            fed = {"dq": sa.sparse_bwd_dq(q, k, v, do, lse, delta_k, layout)}
            fed["dk"], fed["dv"] = sa.sparse_bwd_dkv(q, k, v, do, lse,
                                                     delta_k, layout)
            o2, lse2 = sa.sparse_fwd(q, k, v, layout)
            again = {"dq": sa.sparse_bwd_dq(q, k, v, do, lse_p, delta,
                                            layout)}
            again["dk"], again["dv"] = sa.sparse_bwd_dkv(q, k, v, do, lse_p,
                                                         delta, layout)
            if device == "cuda":
                torch.cuda.synchronize()
            same = torch.equal(o2, o) and torch.equal(lse2, lse)
            same_bwd = all(torch.equal(again[n], got[n]) for n in again)
            # the k-blocks that no q-block keeps: dk = dv = 0 exactly
            empty = (layout.q_n == 0).nonzero().flatten().tolist()
            rows = [p for jk in empty
                    for p in range(jk * cfg.block, (jk + 1) * cfg.block)]
            zeros = not any(bool(got[n][:, rows].any()) for n in ("dk", "dv"))
            tag = (f"[sparse] {name:24s} {str(dtype):15s} B{B} H{H} KV{KV} "
                   f"S{S} hd{hd} block {cfg.block} "
                   f"{'causal' if causal else 'full'}, lists "
                   f"{min(widths)}-{max(widths)} wide, on "
                   + " / ".join(sa.library(n, cfg.block, hd)
                                for n in SPARSE_NAMES))
            note(_check_shares(tag, got, want, lse, lse_p, dtype))
            _check_shares(tag + ", the backward fed its lse", {
                "o": o, **fed}, want, lse, lse_p, dtype)
            log(f"{tag}: a second forward bit-identical {same}, a second "
                f"dq, dk, dv bit-identical {same_bwd}; {len(empty)} k-blocks "
                f"kept by no q-block, their dk = dv = 0 {zeros}")
            if not (same and same_bwd and zeros):
                raise AssertionError(f"sparse {name} {dtype}: two calls "
                                     f"differ (forward {same}, backward "
                                     f"{same_bwd}) or dk / dv not 0 on "
                                     f"k-blocks {empty}")
            del q, k, v, do, o_p, lse_p, delta, want, got, o, lse, fed, o2
            del again
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
    port's flash kernels on the dense causal problem at the same shape, the
    sparse kernels launched in natural block order instead of widest list
    first, and at blocks 64 / 128 the mma.sync backward pair of
    ``sparse_attention.cu`` on the same inputs, timed in turns with the
    wgmma pair (wgmma, mma.sync, mma.sync, wgmma)."""
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
    # the mma.sync pair, called past the wrappers' route (no launch counted)
    mma = {"sparse_bwd_dq": lambda i: sa._bwd_dq_on("sparse_attention",
                                                    *bwd(i), layout),
           "sparse_bwd_dkv": lambda i: sa._bwd_dkv_on("sparse_attention",
                                                      *bwd(i), layout)}
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
                      flash_dense_bound_ms=fb["bound_ms"],
                      library=sa.library(n, cfg.block, hd))
        if n in mma and out[n]["library"] != "sparse_attention":
            turns = [device_ms(f, 4, iters)
                     for f in (lpt[n], mma[n], mma[n], lpt[n])]
            out[n]["ab_ms"] = {"wgmma": [turns[0], turns[3]],
                               "mma_sync": [turns[1], turns[2]]}
            log(f"[sparse] {n} {name}: wgmma {turns[0] * 1e3:.2f} / "
                f"{turns[3] * 1e3:.2f} us against the mma.sync kernel "
                f"{turns[1] * 1e3:.2f} / {turns[2] * 1e3:.2f} us, in turns "
                f"on the same inputs ({turns[1] / turns[0]:.2f}x)")
        log(f"[sparse] {n} ({out[n]['library']}) {name} B{B} H{H} KV{KV} "
            f"S{S} hd{hd} block {cfg.block} "
            f"{'causal' if causal else 'full'} bf16: kernel "
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
                             fp32_cases=FLASH_CASES + FLASH_F32_LONG_CASES,
                             dtypes=None,
                             iters=50) -> dict:
    """The three flash kernels with the bias operand against their plain
    versions on every case, in bf16, fp16 and fp32, each fed the plain
    forward's lse and delta; dq twice, once as the kernels read the bias
    and once with dbias, the bias expanded to (B, H, S, S) where it is
    broadcast (as a learned one reaches the kernels); dbias exactly 0
    above a causal diagonal. Then the fp32 kernels without a bias on phase
    5's cases and on FLASH_F32_LONG_CASES. On the card, timed at the first
    two cases' shapes and the fp32 kernels at GPT-2 1.5B's (phase 5's
    first case)."""
    import torch

    from deepspeed_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=device).manual_seed(6)
    dtypes = dtypes or (torch.bfloat16, torch.float16, torch.float32)
    # max |kernel - plain| of each kernel's outputs, over the biased runs
    # (every dtype), over the fp32 runs without a bias and over the fp32
    # runs (both) that the 3xTF32 wgmma kernels served
    worst = {v: dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv"), 0.0)
             for v in ("bias", "fp32", "fp32_wgmma")}

    def note(variant, outputs, dtype, hd):
        for n, (a, b) in outputs.items():
            k_name = _OUTPUT_OF[n]
            err = (a.float() - b.float()).abs().max().item()
            worst[variant][k_name] = max(worst[variant][k_name], err)
            if dtype == torch.float32 and \
                    fa.library(k_name, dtype, hd).endswith("_f32_sm90"):
                worst["fp32_wgmma"][k_name] = max(
                    worst["fp32_wgmma"][k_name], err)
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
            o2, lse2 = fa.flash_fwd(q, k, v, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            same = torch.equal(o2, o) and torch.equal(lse2, lse)
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
            ok = finite and hidden_zero and torch.equal(dq, dq2) and same \
                and dbias.dtype == bias.dtype and lse_err <= FLASH_LSE_ATOL \
                and shares["dbias"] <= dbias_tol \
                and all(v <= tol for n, v in shares.items() if n != "dbias")
            log(f"[flash-bias] {name:18s} {str(dtype):15s} B{B} H{H} KV{KV} "
                f"S{S} hd{case[5]} {case[8]} {case[9]} bias: " + ", ".join(
                    f"{n} {v:.2e}" for n, v in shares.items())
                + f" of max |plain| (tol {tol:g}, dbias {dbias_tol:g}); lse "
                f"{lse_err:.1e}; dbias "
                f"0 above the diagonal {hidden_zero}; a second forward "
                f"bit-identical {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash bias {name} {dtype}: {shares}, "
                                     f"lse {lse_err}, finite {finite}, "
                                     f"zeros {hidden_zero}, repeat {same}")
            note("bias", got, dtype, case[5])
            del x, o, o_p, dq, dq2, dq_p, dk, dv, dk_p, dv_p, dbias, dbias_p
            del o2, lse2
    for case in fp32_cases:
        name, shape = case[0], case[1:]
        x = _flash_case(gen, *shape, torch.float32, device)
        kw = dict(mask=x["mask"], alibi_slopes=x["slopes"], causal=x["causal"])
        q, k, v, do = x["q"], x["k"], x["v"], x["do"]
        o_p, lse_p = fa.flash_attention_fwd_plain(q, k, v, **kw)
        delta = fa.attention_delta(o_p, do)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        got = {"o": (o, o_p),
               "dq": (fa.flash_bwd_dq(q, k, v, do, lse_p, delta, **kw),
                      fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw))}
        dk_dv = zip(fa.flash_bwd_dkv(q, k, v, do, lse_p, delta, **kw),
                    fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw))
        got.update(zip(("dk", "dv"), dk_dv))
        o2, lse2 = fa.flash_fwd(q, k, v, **kw)
        shares = {n: _share(a, b) for n, (a, b) in got.items()}
        # the forward: lse on live rows, o exactly 0 on rows without a live
        # key, a second call bit-identical
        live = lse_p > fa.BIG_NEG / 2
        lse_err = (lse - lse_p).abs()[live].max().item()
        dead_zero = bool((o.transpose(1, 2)[~live] == 0).all())
        same = torch.equal(o2, o) and torch.equal(lse2, lse)
        ok = all(v <= FLASH_BIAS_TOL_SHARE["torch.float32"]
                 for v in shares.values()) \
            and all(bool(torch.isfinite(a).all()) for a, _ in got.values()) \
            and bool(torch.isfinite(lse).all()) \
            and lse_err <= FLASH_LSE_ATOL and dead_zero and same
        log(f"[flash-fp32] {name:20s} B{shape[0]} H{shape[1]} KV{shape[2]} "
            f"S{shape[3]} hd{shape[4]} (forward on "
            f"{fa.library('flash_fwd', torch.float32, shape[4])}): "
            + ", ".join(f"{n} {v:.2e}" for n, v in shares.items())
            + f" of max |plain| (tol 1e-4); lse {lse_err:.1e}; "
            f"{int((~live).sum())} dead rows, o 0 there {dead_zero}; a second"
            f" forward bit-identical {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash fp32 {name}: {shares}, lse "
                                 f"{lse_err}, dead rows 0 {dead_zero}, "
                                 f"repeat {same}")
        note("fp32", got, torch.float32, shape[4])
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
        if "cuda_core_ms" in b:
            out[n]["cuda_core_bound_ms"] = b["cuda_core_ms"]
        log(f"[flash-bias] {n} {name} B{B} H{H} S{S} hd{hd} "
            f"{'causal' if causal else 'full'} {dtype}, bias "
            f"{tuple(bias.shape)} {bias.dtype}"
            f"{', dbias (B, H, S, S)' if n == 'flash_bwd_dq' else ''}: "
            f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}: {b['bytes']} B, "
            f"{b['ops']:.4g} flop), kernel at {b['bound_ms'] / ms:.1%} of the "
            "bound" + (f"; at the CUDA cores' 67 TFLOP/s "
                       f"{b['cuda_core_ms'] * 1e3:.2f} us"
                       if "cuda_core_ms" in b else ""))
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
    3xTF32 bound (the 67 TFLOP/s CUDA-core line beside it), the plain
    versions and SDPA in fp32 (forward and its autograd backward), all
    device-timed but the plain versions."""
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
                      bound_by=b["bound_by"], library_ms=library[n],
                      cuda_core_bound_ms=b["cuda_core_ms"])
        log(f"[flash-fp32] {n} {name} B{B} H{H} KV{KV} S{S} hd{hd} "
            f"{'causal' if causal else 'full'} fp32 "
            f"({fa.library(n, torch.float32, hd)}): kernel {ms * 1e3:.2f} "
            f"us, plain {plain_ms * 1e3:.2f} us, bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']} as 3xTF32 at 495 "
            f"TFLOP/s: {b['bytes']} B, {b['ops']:.4g} flop), kernel at "
            f"{b['bound_ms'] / ms:.1%} of the bound; at the CUDA cores' 67 "
            f"TFLOP/s {b['cuda_core_ms'] * 1e3:.2f} us")
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
    """The loss and every leaf's grad at the compute dtype; the leaves the
    model keeps in fp32 (an MoE router) stay fp32, as the engine casts."""
    keep = set(model.fp32_param_names())
    params = {k: v.detach().to(_dtype_of(k, keep, dtype))
              .requires_grad_() for k, v in master.items()}
    loss = model.loss(params, batch, remat_policy=remat)
    loss.backward()
    return loss.detach().float(), {k: v.grad for k, v in params.items()}


def _dtype_of(name: str, keep: set, dtype):
    """fp32 for a leaf the model keeps in fp32, else ``dtype``."""
    import torch

    return torch.float32 if name.rsplit(".", 1)[-1] in keep else dtype


def _record_routes(model, log_to: list) -> None:
    """Wrap ``model._mlp_block`` (an MoE block) so its first ``n_layer``
    calls append (the top-k expert ids of every token in gating's pass
    order, the router's dtype): the forward's layers, not remat's reruns
    in the backward."""
    import torch

    inner = model._mlp_block
    n, k = model.cfg.n_layer, model.cfg.moe_top_k

    def block(y, p):
        if len(log_to) < n:
            with torch.no_grad():
                logits = y.float() @ p["router"].float()
                top = torch.topk(logits, k, dim=-1).indices
            log_to.append((top, p["router"].dtype))
        return inner(y, p)

    model._mlp_block = block


def _replay_routes(model, routes: list, flips: list) -> None:
    """Wrap ``model._mlp_block`` so layer i (told apart by its router's
    storage, so remat's reruns find theirs) routes as ``routes[i]`` (B, S,
    k, in pass order) through ``topk_gating``'s ``choices``; ``flips[i]``
    counts the tokens whose own top-k set differs (the first call a
    layer)."""
    import torch

    from deepspeed_tpu_torch.models import moe as moe_module

    inner, gating = model._mlp_block, moe_module.topk_gating
    layer_of: dict = {}

    def block(y, p):
        i = layer_of.setdefault(p["router"].data_ptr(), len(layer_of))
        chosen = routes[i]

        def forced(logits, top_k, capacity):
            if len(flips) == i:
                with torch.no_grad():
                    own = torch.topk(logits, top_k, dim=-1).indices.sort(-1)
                    flips.append(int((own.values != chosen.sort(-1).values)
                                     .any(-1).sum()))
            return gating(logits, top_k, capacity, choices=chosen)

        moe_module.topk_gating = forced
        try:
            return inner(y, p)
        finally:
            moe_module.topk_gating = gating

    model._mlp_block = block


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
                     "xent_dl_kernel", "xent_prod_kernel")


def kernel_names(fns) -> tuple:
    """The names under which the wrappers' kernels show in a profile:
    ``<wrapper>_kernel``, and for the three flash kernels their wgmma
    kernel ``<wrapper>_sm90_kernel`` and fp32 wgmma kernel
    ``<wrapper>_f32_sm90_kernel`` besides the mma.sync one (hd 16 and the
    rest of fp32), for the three sparse kernels their wgmma kernel
    ``<wrapper>_sm90_kernel`` besides the mma.sync one (blocks 16 and 32,
    hd 16)."""
    def names(fn):
        n = fn.__name__
        if n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            return f"{n}_kernel", f"{n}_sm90_kernel", f"{n}_f32_sm90_kernel"
        if n in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"):
            return f"{n}_kernel", f"{n}_sm90_kernel"
        return f"{n}_kernel",

    return tuple(n for fn in fns for n in names(fn))


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
    xent = (xe.xent_fwd, xe.xent_bwd)
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
    moe = cfg.num_experts > 1
    routes_k, flips = [], []
    if moe:
        # the reference routes as the path under test did (its own choices
        # counted): one near tie moved by bf16 would shift every later
        # token's capacity slot at two experts, and with them the drops
        _record_routes(under_test, routes_k)
    lk, gk = _loss_and_grads(under_test, master, mb, cfg.dtype, remat)
    if moe:
        _replay_routes(reference, [r for r, _ in routes_k], flips)
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
    if moe:
        tokens_routed = routes_k[0][0].shape[0] * routes_k[0][0].shape[1]
        log(f"{tag} routing: the plain path took the kernel path's expert "
            f"choices; tokens whose own top-{cfg.moe_top_k} set differs, by "
            f"layer {flips} of {tokens_routed} (recorded, not gated: bf16 "
            "attention outputs move near-tied router decisions)")
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
    router_dtypes, routes_e = [], []
    if moe:
        # the first warm-up step's compute params: the router stays fp32
        _record_routes(engine.model, routes_e)
    for i in range(warmup):
        losses.append(float(engine.train_batch(dict(data))["loss"]))
        if moe and i == 0:
            router_dtypes = sorted({str(d) for _, d in routes_e})
            del engine.model._mlp_block          # the class's block again
            log(f"{tag} the engine's compute params: router {router_dtypes}"
                f", the expert banks {engine.compute_dtype}")
            if router_dtypes != ["torch.float32"]:
                raise AssertionError(f"{tag} the router reached the MoE "
                                     f"block as {router_dtypes}, not fp32")

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
                 "xent_fwd": head, "xent_bwd": head})
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
        f"{per_step}; xent_fwd and xent_bwd {gas if fused else 0} each: the "
        "head sits outside the layer checkpoints; the other attention "
        "kernels 0)")
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
              "gas": gas, "route_flips": flips,
              "router_dtypes": router_dtypes}
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
        if cuda and profile_steps and dtype == torch.float32:
            result["example"][str(dtype)].update(_example_profile(
                partial(loss_fn, attention=evo.evoformer_attention), params,
                counters, profile_steps, tag))
    _free_memory(dev)
    result["af2"] = phase_af2_msa_row(device, af2, profile_steps)
    return result


def _example_profile(loss_fn, params, counters, steps, tag) -> dict:
    """Device time of the example's steps (loss and grads, as _sgd_run
    takes them) under the profiler, and each flash kernel's share of it
    by its kernels' names."""
    import torch

    leaves = {n: t.clone().requires_grad_() for n, t in params.items()}

    def step():
        torch.autograd.grad(loss_fn(leaves), list(leaves.values()))

    step()
    prof = profile_calls(lambda: [step() for _ in range(steps)], steps, tag)
    if not prof:
        return {}
    shares = {k: sum(v for n, v in prof["by_name"].items()
                     if f"{k}<" in n or n.startswith(k) or f"::{k}(" in n)
              / prof["busy"] for k in kernel_names(counters)}
    out = {"busy_ms": prof["busy"] / steps / 1e3,
           "busy_share": prof["busy"] / prof["wall"], "shares": shares}
    log(f"{tag} device busy {out['busy_ms']:.3f} ms a step "
        f"({out['busy_share']:.1%} of the wall); the flash kernels' share: "
        + ", ".join(f"{k} {v:.1%}" for k, v in shares.items() if v))
    return out


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


# ----------------------------------------------------------------- phase 11
SERVING = {"slots": 8, "max_len": 1024, "prefill_chunk": 256, "greedy": True}
# the stream: prompts uniform in [16, 768] tokens, max_new in [16, 128], all
# submitted at t = 0 (seed 0); 32 requests in bf16, 16 in int8
SERVE_PROMPT = (16, 768)
SERVE_NEW = (16, 128)
SERVE_KERNELS = {"decode_attention": "decode_attention_kernel",
                 "woq_matmul": "woq_matmul_mma_kernel"}
# the quiet time held on each side of a counted profile (_profile_counts)
PROFILE_MARGIN_S = 0.2


def _serve_stream(vocab: int, n: int, seed: int = 0, prompt=SERVE_PROMPT,
                  new=SERVE_NEW) -> list:
    """(prompt ids, max_new, request seed) for ``n`` requests."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt[0], prompt[1] + 1, n)
    news = rng.integers(new[0], new[1] + 1, n)
    return [(rng.integers(0, vocab, int(P)).astype(np.int32), int(N), i)
            for i, (P, N) in enumerate(zip(lens, news))]


# 11c-11g: the paged pool under the same engine, pages of 16 positions;
# 513 pages = 1 + 8 slots x 64, every slot coverable with no sharing
PAGED = {**SERVING, "page_size": PAGE_SIZE, "pool_pages": 513}


def _shared_stream(vocab: int, n: int = 32, seed: int = 3, systems: int = 4,
                   system: int = 512, suffix=(16, 256),
                   new=SERVE_NEW) -> list:
    """11e: ``n`` requests, each one of ``systems`` system prompts of
    ``system`` tokens and its own suffix, ``new`` tokens to generate; two
    of them are the second turns of two others, extending them past a
    partial block (the copy-on-write path), four places after them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, system).astype(np.int32)
             for _ in range(systems)]
    out = []
    for i in range(n - 4):
        tail = rng.integers(0, vocab, int(rng.integers(suffix[0],
                                                       suffix[1] + 1)))
        out.append(np.concatenate([heads[i % systems], tail]).astype(np.int32))
    out = [(p, int(rng.integers(new[0], new[1] + 1))) for p in out]
    for j, at in enumerate((2, 9)):
        # turn 1 ends 5 (then 7) tokens into a page; turn 2 is turn 1 and
        # 40 more tokens
        t1 = np.concatenate([heads[j], rng.integers(
            0, vocab, 37 + 2 * j)]).astype(np.int32)
        t2 = np.concatenate([t1, rng.integers(0, vocab, 40)]).astype(np.int32)
        out.insert(at, (t1, new[1]))
        out.insert(at + 5, (t2, new[0]))
    return [(p, nn, i) for i, (p, nn) in enumerate(out)]


def _serve_engine(cfg, bits=None, device=None, conf=None):
    """Phase 11's InferenceEngine: ``cfg``'s model from a seed, bf16 or
    int8 WOQ (``bits``); ``conf``: more inference config (phase 15's
    ``tensor_parallel``)."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import build_model

    dev = torch.device(device or "cuda")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(2024)
    conf = {"dtype": str(cfg.dtype).removeprefix("torch."), **(conf or {})}
    if bits:
        conf.update(quantize=True, quant_bits=bits, quant_group_size=128)
    kw = {} if device is None else {"device": device}
    engine = dt.init_inference(model, model.init(gen, device=dev,
                                                 dtype=cfg.dtype), conf, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return engine


def _step_bound(engine, lengths, kv_bits: int = 0) -> dict:
    """The least time of one slot step: the weights it reads once (every
    leaf but the token table, of which it reads a row a slot; a quantized
    leaf's integers and scales) and the live KV it reads (``lengths``
    positions a slot, K and V of every layer; int8 KV with its fp32 scale
    a head), over the card's memory rate."""
    from deepspeed_tpu_torch.inference.quantization import QuantizedTensor

    cfg = engine.model.cfg
    weights = sum((v.q.nbytes + v.scale.nbytes) if isinstance(
        v, QuantizedTensor) else v.nbytes for k, v in engine.params.items()
        if k != "tok_embed" or cfg.tie_embeddings)
    per_token = 2 * cfg.n_layer * cfg.kv_heads * (
        cfg.head_dim + 4 if kv_bits else
        cfg.head_dim * engine.compute_dtype.itemsize)
    kv = int(sum(lengths)) * per_token
    return {"bound_ms": (weights + kv) / PEAK_BYTES_PER_S * 1e3,
            "weight_bytes": weights, "kv_bytes": kv}


def _slot_marks(st):
    """What a slot step changes besides the KV it writes at each slot's
    ``length``, which a rerun from the same marks overwrites: the slots'
    lengths, tokens and done flags."""
    return st.cache.length.clone(), st.tok.clone(), st.done.clone()


def _slot_reset(st, marks) -> None:
    import torch

    with torch.inference_mode():     # the state's tensors are inference's
        for t, m in zip((st.cache.length, st.tok, st.done), marks):
            t.copy_(m)


def _profile_counts(fn) -> dict:
    """torch.profiler around one call of ``fn``: launches of each device
    kernel by name, the device's busy µs and the host wall µs.

    Kineto drops a device record whose converted time falls outside the
    host's capture window, and a graph replay puts its first kernels on
    the device within microseconds of the window's start (its last ones
    as close to the end), so the window is held open ``PROFILE_MARGIN_S``
    on each side of ``fn``: a record is then lost only to a clock skew
    larger than that. The wall time is ``fn``'s alone. ``lead_us``: the
    first device record's start less the first launch call's; ``tail_us``:
    the end of the first device synchronize after the last launch call (the
    one closing ``fn``, not the profiler's own at its exit) less the last
    device record's end; each is >= 0 on clocks that agree (None where a
    call is missing)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        time.sleep(PROFILE_MARGIN_S)
    counts, busy, order, launch, synced = {}, 0.0, [], [], []
    dur: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
            busy += e.time_range.elapsed_us()
            dur[e.name] = dur.get(e.name, 0.0) + e.time_range.elapsed_us()
            order.append((e.time_range.start, e.time_range.end, e.name[:60]))
        elif e.name in ("cudaGraphLaunch", "cudaLaunchKernel",
                        "cudaLaunchKernelExC", "cudaMemcpyAsync"):
            launch.append(e.time_range.start)
        elif e.name == "cudaDeviceSynchronize":
            synced.append((e.time_range.start, e.time_range.end))
    order.sort()
    closing = [end for start, end in synced
               if launch and start >= max(launch)]
    return {"counts": counts, "busy_us": busy, "wall_us": wall_us,
            "us_by_name": dur, "names": [n for *_, n in order],
            "ends": ([n for *_, n in order[:4]], [n for *_, n in order[-4:]]),
            "lead_us": order[0][0] - min(launch) if order and launch
            else None,
            "tail_us": min(closing) - max(t for _, t, _ in order)
            if order and closing else None}


def _missing_in_replays(names: list, replays: int) -> list:
    """Where a window of ``replays`` identical graph replays lost device
    records: each replay's records against the longest replay's, cut at
    the first record's name; (replay, position, names missing, the two
    records around them) for each gap."""
    import difflib

    head = names[0] if names else None
    starts = [i for i, n in enumerate(names) if n == head]
    cuts = [names[a:b] for a, b in zip(starts, starts[1:] + [len(names)])]
    if len(cuts) != replays:
        return [{"replays_found": len(cuts)}]
    full = max(cuts, key=len)
    out = []
    for r, got in enumerate(cuts):
        sm = difflib.SequenceMatcher(a=full, b=got, autojunk=False)
        for op, a0, a1, _, _ in sm.get_opcodes():
            if op != "equal":
                out.append({"replay": r, "at": a0, "of": len(full),
                            "missing": full[a0:a1][:3],
                            "around": full[max(a0 - 1, 0):a1 + 1][:5]})
    return out


def _kernel_launches(counts: dict, kernel: str) -> int:
    """Launches of a templated kernel, whatever its namespace and template
    arguments (the profiler names ``void (anonymous namespace)::k<...>``)."""
    return sum(v for k, v in counts.items() if f"{kernel}<" in k)


class _ServedRoutes:
    """The routing an MoE engine's ``ServingEngine`` served: for each
    request, the sorted top-k expert ids every layer gave each position
    whose K/V its cache kept. The prefill chunks' come from their eager
    MoE blocks (a final overlap chunk's overwrite the positions it
    recomputes); the slot step's from a static (L, slots, k) buffer that
    its MoE blocks write, in the CUDA graph too, read after every step
    against the slots' requests and lengths. ``stop()`` restores the
    engine's methods (the graph keeps writing the buffer)."""

    def __init__(self, srv):
        import torch

        self.srv, model = srv, srv.model
        cfg = model.cfg
        self.L, self.k = cfg.n_layer, cfg.moe_top_k
        self.max_len = srv.cfg.max_len
        self.buf = torch.zeros((self.L, srv.cfg.slots, self.k),
                               dtype=torch.long, device=srv.device)
        self.routes: dict = {}
        self._chunk: list = []
        self._calls = 0
        self.on = True
        block, infer = model._mlp_block, model._mlp_block_infer
        advance, step = srv._prefill_advance, srv.slot_step

        def top(y, p):
            logits = y.float() @ p["router"].float()
            return torch.topk(logits, self.k, dim=-1).indices.sort(-1).values

        def rec_block(y, p):                      # prefill chunks, T > 1
            if self.on:
                self._chunk.append(top(y, p)[0])
            return block(y, p)

        def rec_infer(y, p):                      # the slot step, T = 1
            self.buf[self._calls % self.L].copy_(top(y, p)[:, 0])
            self._calls += 1
            return infer(y, p)

        def rec_advance():
            req, plan, idx = srv._prefill[:3]
            ch = plan[idx]
            self._chunk.clear()
            out = advance()
            if self.on:
                n = ch.last_index + 1 if ch.final else len(ch.ids)
                self._of(req.rid)[:, ch.start:ch.start + n] = torch.stack(
                    self._chunk)[:, :n]
            return out

        def rec_step(graphed=None):
            st = srv.state
            lens = st.cache.length.clone()
            running = dict(srv.sched.running)
            out = step(graphed=graphed)
            if self.on:
                for slot, req in running.items():
                    self._of(req.rid)[:, lens[slot]] = self.buf[:, slot]
            return out

        model._mlp_block, model._mlp_block_infer = rec_block, rec_infer
        srv._prefill_advance, srv.slot_step = rec_advance, rec_step

    def _of(self, rid):
        import torch

        if rid not in self.routes:
            self.routes[rid] = torch.full((self.L, self.max_len, self.k), -1,
                                          dtype=torch.long,
                                          device=self.buf.device)
        return self.routes[rid]

    def stop(self) -> None:
        self.on = False
        for obj, names in ((self.srv.model, ("_mlp_block",
                                             "_mlp_block_infer")),
                           (self.srv, ("_prefill_advance", "slot_step"))):
            for n in names:
                delattr(obj, n)


def _forced_gating(routes, stats: dict):
    """``topk_gating`` with each layer's expert choices taken from
    ``routes`` (L, T, k), one group of T tokens: for a reference forward
    that routes as the served run did. Each choice the reference's own
    argmax would not make is counted in ``stats`` with its margin: the
    reference's k-th best router logit less the served expert's, over the
    row's max |router logit|."""
    import torch

    from deepspeed_tpu_torch.models.moe import topk_gating

    layer = {"i": 0}

    def gating(logits, top_k, capacity):
        forced = routes[layer["i"]][None, :logits.shape[-2]]    # (1, T, k)
        layer["i"] += 1
        own = torch.topk(logits, top_k, dim=-1)
        differ = (own.indices.sort(-1).values != forced).any(-1)
        low = torch.gather(logits, -1, forced).min(-1).values
        margin = (own.values[..., -1] - low).clamp_min(0) \
            / logits.abs().amax(-1)
        stats["decisions"] = stats.get("decisions", 0) + differ.numel()
        stats["flips"] = stats.get("flips", 0) + int(differ.sum())
        stats["worst_margin"] = max(stats.get("worst_margin", 0.0),
                                    float(margin.max()))
        # the passes take the served experts in the order of their gates
        order = torch.gather(logits, -1, forced).argsort(-1, descending=True)
        return topk_gating(logits, top_k, capacity,
                           choices=torch.gather(forced, -1, order))

    return gating


def phase_serve(cfg=None, *, bits=None, requests=32, serving=None,
                prompt=SERVE_PROMPT, new=SERVE_NEW, device=None,
                solo_checks=4, lab_prompt=512, lab_new=256, timed_steps=8,
                profile_steps=4, engine=None, stream=None, name="",
                want_tokens=None, lab_hook=None) -> dict:
    """Phase 11: ``ServingEngine(init_inference(...), SERVING)`` serving a
    seeded stream at full width and depth (bf16, or int8 WOQ with
    ``bits=8``), all requests submitted at t = 0, then ``drain()``. The
    kernel counts are zeroed before a one-request warm-up (whose first
    decode step is the eager warm-up and the graph's capture) and read
    after the drain. Gates: every request OK with ``max_new`` tokens;
    ``captures == 1``; the capture recorded ``n_layer`` decode-attention
    launches (and 161 ``woq_matmul`` in int8); a profiled window of
    replays shows those kernels launched on the device, ``n_layer`` (and
    161) a replay, by name; every served token within
    LOGIT_TOL_SHARE of its row's maximum in one dense teacher-forced
    forward; the graphed and the eager slot step give the same tokens from
    the same state. An MoE model's served routing is recorded
    (``_ServedRoutes``) and the teacher-forced forward routes as it did
    (``_forced_gating``), the choices its own router would not make
    counted with their margins: one bf16 near tie changes an expert, and
    random experts carry it far (PERF.md §6, PR 19).
    Recorded: tokens/s, TTFT, TPOT, both step times, the
    device's busy share over serving iterations, peak memory, the graph's
    private memory pool (the reserved bytes its capture added), solo
    ``generate`` parity, and the path's device launches, from the counts
    taken: the wrappers' (the eager warm-up step and the capture) less the
    capture's, plus the capture's times the graph's replays. An MoE model
    routes the slot step through its one-group dispatch, whose int8 expert
    banks dequantize at their point of use: 2 ``woq_matmul`` a layer (the
    fused qkv and ``wo``) then, and the banks' dequantize is timed alone
    (CUDA events, one layer's three banks, times ``n_layer``).

    ``engine``: phase 11's InferenceEngine for ``cfg`` and ``bits``
    (``_serve_engine``), built here if None. ``stream``: the requests
    (default: ``requests`` of ``_serve_stream``). ``serving`` with
    ``page_size`` runs the paged pool (11c-11g): the pool's snapshot and
    its bytes are recorded. ``want_tokens``: each request's tokens from
    another run of the same stream, which the served tokens must equal
    exactly (11c, 11d). ``lab_hook(srv, marks)``: more measurements of the
    lab's full slots on the card, from the state ``marks`` names; its dict
    joins the result (phase 15's collectives). ``profile_steps=0`` takes
    no profile (a reference run whose tokens another run is held to)."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.decode import (forward_with_cache,
                                                      init_cache)
    from deepspeed_tpu_torch.models import llama2
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import woq_matmul as wm
    from deepspeed_tpu_torch.resilience.guards import RequestStatus

    cfg = cfg or llama2("7b")
    serving = dict(serving or SERVING)
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    paged = serving.get("page_size", 0) > 0
    tag = f"[serve{' ' + name if name else ''} {cfg.n_layer}L " \
        f"d{cfg.d_model} " + (f"int{bits}" if bits
                               else f"{str(cfg.dtype)[6:]}") + \
        (f" paged {serving['page_size']}" if paged else "") + \
        (" kv-int8" if serving.get("kv_quant_bits") else "") + "]"
    t_phase = time.perf_counter()
    _free_memory(dev)
    own_engine = engine is None
    if own_engine:
        engine = _serve_engine(cfg, bits, device)
    srv = dt.ServingEngine(engine, serving)
    pool = {}
    if srv.graph is not None:
        capture = srv.graph.capture

        def counted_capture(forward, **kw):
            torch.cuda.synchronize()
            # as the capture itself does first: the delta is its pool
            torch.cuda.empty_cache()
            r0 = torch.cuda.memory_reserved()
            capture(forward, **kw)
            torch.cuda.synchronize()
            pool["bytes"] = torch.cuda.memory_reserved() - r0

        srv.graph.capture = counted_capture
    moe = cfg.num_experts > 1
    served_routes = _ServedRoutes(srv) if moe else None
    if stream is None:
        stream = _serve_stream(cfg.vocab_size, requests, prompt=prompt,
                               new=new)
    requests = len(stream)
    log(f"{tag} ServingEngine {serving}, flash_decode {engine.flash_decode}, "
        f"woq_kernel {getattr(engine.model, 'woq_kernel', None)}; "
        f"{requests} requests, prompts {min(len(p) for p, _, _ in stream)}-"
        f"{max(len(p) for p, _, _ in stream)}, max_new "
        f"{min(n for _, n, _ in stream)}-{max(n for _, n, _ in stream)}")

    # ---- the path, counted: warm-up request (eager step + capture), then
    # the stream from t = 0 to the end of the drain ----
    counters = (da.decode_attention, wm.woq_matmul, wm.woq_matmul_t)
    resident = _free_memory(dev)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    # the warm-up's prompt shares no block with the stream's: a prefix hit
    # on the paged pool would change a request's chunk plan
    srv.serve_batch([_serve_stream(cfg.vocab_size, 1, seed=99)[0][0][:32]],
                    4)
    sync()
    warm_s = time.perf_counter() - t0
    srv.stats.reset()
    rids = [srv.submit(p, n, seed=s) for p, n, s in stream]
    t0 = time.perf_counter()
    done = srv.drain()
    sync()
    drain_s = time.perf_counter() - t0
    counted = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if moe:
        served_routes.stop()
    snap = srv.stats.snapshot()
    pages = srv.pool.snapshot() if paged else None
    kvc = srv.state.cache
    kv_bytes = {k: getattr(kvc, k).nbytes for k in
                ("k", "v", "k_scale", "v_scale", "page_table")
                if getattr(kvc, k, None) is not None}
    replays = srv.graph.replays if srv.graph else 0
    captured = dict(srv.graph.captured_launches) if srv.graph else {}
    bad = [(r, done[r].status.value, len(done[r].tokens)) for r, (_, n, _)
           in zip(rids, stream) if done[r].status is not RequestStatus.OK
           or len(done[r].tokens) != n]
    if bad:
        raise AssertionError(f"{tag} requests not served in full: {bad}")
    streamed = [list(done[r].tokens) for r in rids]
    tokens = sum(n for _, n, _ in stream)
    exact_share = None
    if want_tokens is not None:
        same = sum(int(a == b) for g, w in zip(streamed, want_tokens)
                   for a, b in zip(g, w))
        exact_share = same / tokens
        apart = [i for i, (g, w) in enumerate(zip(streamed, want_tokens))
                 if g != w]
    if pages is not None:
        log(f"{tag} pool after the drain: {json.dumps(pages)}; pool bytes "
            f"{json.dumps(kv_bytes)} = {sum(kv_bytes.values()) / 2**30:.3f}"
            f" GiB")
    # woq_matmul a layer: the fused qkv, wo and the dense FFN's products; an
    # MoE layer's banks dequantize instead (MoETransformerLM._bank)
    per_layer = 2 if cfg.num_experts > 1 else (5 if cfg.is_glu else 4)
    per_step = {"decode_attention": cfg.n_layer if engine.flash_decode else 0,
                "woq_matmul": (per_layer * cfg.n_layer
                               + (not cfg.tie_embeddings))
                if bits and engine.model.woq_kernel else 0,
                "woq_matmul_t": 0}
    if want_tokens is not None:
        log(f"{tag} served tokens equal the reference run's: "
            f"{exact_share:.4f} of {tokens}; requests apart {apart}")
    log(f"{tag} {requests} requests, {tokens} tokens in {drain_s:.3f} s: "
        f"{tokens / drain_s:.1f} tok/s; TTFT p50 "
        f"{snap['ttft_s']['p50'] * 1e3:.1f} ms p99 "
        f"{snap['ttft_s']['p99'] * 1e3:.1f} ms; TPOT p50 "
        f"{snap['tpot_s']['p50'] * 1e3:.2f} ms p99 "
        f"{snap['tpot_s']['p99'] * 1e3:.2f} ms; {snap['iterations']} "
        f"iterations ({snap['prefill_chunks']} with a prefill chunk, "
        f"{snap['decode_steps']} decode steps); slot "
        f"occupancy {snap['slot_occupancy_avg']:.3f}; warm-up request "
        f"{warm_s:.2f} s; peak memory {peak / 2**30:.2f} GiB "
        f"({resident / 2**30:.2f} GiB resident before)")
    # on the device: the eager warm-up step's launches (the wrappers'
    # count less the capture's), then the captured ones at every replay
    launches = {k: v - captured.get(k, 0) + captured.get(k, 0) * replays
                for k, v in counted.items()}
    if pool:
        log(f"{tag} the slot step's CUDA graph holds a private pool of "
            f"{pool['bytes'] / 2**30:.3f} GiB (reserved bytes its capture "
            "added)")
    log(f"{tag} captures {srv.captures}; the wrappers' counts over the path "
        f"{counted} (the warm-up's eager step and the capture; the "
        f"{replays} replays run the captured launches {captured} without "
        f"the wrappers): device launches {launches}")
    if cuda:
        if srv.captures != 1:
            raise AssertionError(f"{tag} captures {srv.captures}, want 1")
        want = {k: 2 * v for k, v in per_step.items()}
        want_captured = {k: v for k, v in per_step.items() if v}
        if counted != want or captured != want_captured:
            raise AssertionError(f"{tag} wrapper counts {counted} (want "
                                 f"{want}), captured {captured} (want "
                                 f"{want_captured})")

    # ---- teacher-forced: prompt + served tokens through one dense
    # forward, fp32 logits ----
    worst, exact, total = 0.0, 0, 0
    route_stats: dict = {}
    from deepspeed_tpu_torch.models import moe as moe_module
    gating = moe_module.topk_gating
    with torch.inference_mode():
        for (p, n, _), rid in zip(stream, rids):
            toks = done[rid].tokens
            ids = torch.as_tensor(np.concatenate([p, toks[:-1]]),
                                  dtype=torch.long, device=dev)[None]
            if moe:
                R = served_routes.routes[rid][:, :ids.shape[1]]
                if bool((R < 0).any()):
                    raise AssertionError(f"{tag} request {rid}: positions "
                                         "with no served routing recorded")
                moe_module.topk_gating = _forced_gating(R, route_stats)
            try:
                lg, _ = forward_with_cache(
                    engine.model, engine.params, ids,
                    init_cache(cfg, 1, ids.shape[1], cfg.dtype, device=dev),
                    materialize=engine.materialize)
            finally:
                moe_module.topk_gating = gating
            rows = lg[0, len(p) - 1:]
            served = torch.as_tensor(toks, device=dev)
            top = rows.max(dim=-1).values
            gap = (top - rows.gather(1, served[:, None])[:, 0]) \
                / rows.abs().max(dim=-1).values
            worst = max(worst, gap.max().item())
            exact += int((rows.argmax(dim=-1) == served).sum())
            total += len(toks)
    log(f"{tag} teacher-forced (one dense forward a request, fp32 logits): "
        f"worst served-token gap to its row's max {worst:.4f} of max |logit| "
        f"(tol {LOGIT_TOL_SHARE}); served token == argmax for "
        f"{exact}/{total} = {exact / total:.4f}")
    if moe:
        log(f"{tag} routing: the teacher-forced forward took the served "
            "expert sets; its own router differs on "
            f"{route_stats['flips']} of {route_stats['decisions']} "
            "(token, layer) decisions, the worst "
            f"{route_stats['worst_margin']:.4f} of max |router logit| below "
            "its k-th choice (recorded, not gated: bf16 moves near-tied "
            "choices; the token gate holds the served path to the "
            "reference given its routing)")
    if not worst <= LOGIT_TOL_SHARE:
        raise AssertionError(f"{tag} a served token's logit is {worst:.4f} "
                             f"of max |logit| below its row's maximum")

    if want_tokens is not None and apart:
        raise AssertionError(f"{tag} requests {apart} served other tokens "
                             "than the reference run of the same stream")

    # ---- solo parity (recorded only): the shortest requests alone ----
    solo = {}
    for (p, n, s), rid in sorted(zip(stream, rids),
                                 key=lambda x: x[0][1])[:solo_checks]:
        alone = engine.generate(p[None], n, greedy=True, request_seeds=[s],
                                cache_len=serving["max_len"])[0].cpu()
        solo[rid] = float((alone == torch.as_tensor(
            done[rid].tokens)).float().mean())
    log(f"{tag} solo generate(request_seeds=[seed], cache_len="
        f"{serving['max_len']}) parity by request: {solo} (recorded: M "
        f"{serving['slots']} and M 1 GEMMs may part on a near tie)")

    # ---- the lab: a full set of slots, the slot step graphed and eager
    # from the same state, a profiled window ----
    srv.end_drain()
    lab = _serve_stream(cfg.vocab_size, serving["slots"], seed=1,
                        prompt=(lab_prompt, lab_prompt),
                        new=(lab_new, lab_new))
    lab_rids = [srv.submit(p, n, seed=s) for p, n, s in lab]
    for _ in range(64 * serving["slots"]):
        if srv.sched.occupancy == serving["slots"]:
            break
        srv.step()
    else:
        raise AssertionError(f"{tag} the lab's {serving['slots']} requests "
                             "did not all reach a slot")
    sync()
    st = srv.state
    marks = _slot_marks(st)
    lg_g, _ = srv.slot_step(graphed=cuda)
    lg_g, tok_g = lg_g.clone(), st.tok.clone()
    _slot_reset(st, marks)
    lg_e, _ = srv.slot_step(graphed=False)
    diff = (lg_g - lg_e).abs().max().item()
    same = bool(torch.equal(tok_g, st.tok))
    log(f"{tag} graph vs eager slot step from the same state: tokens "
        f"identical {same}, logits max |diff| {diff:.3e} (bit identity "
        "expected, not gated)")
    if not same:
        raise AssertionError(f"{tag} the graphed and the eager slot step "
                             "sampled different tokens")
    times = {}
    for graphed in (True, False, False, True) if cuda else (False,):
        _slot_reset(st, marks)
        sync()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            srv.slot_step(graphed=graphed)
        sync()
        times.setdefault(graphed, []).append(
            (time.perf_counter() - t0) / timed_steps * 1e3)
    step_ms = {("graph" if g else "eager"): sum(v) / len(v)
               for g, v in times.items()}
    bound = _step_bound(engine, marks[0].tolist(),
                        serving.get("kv_quant_bits", 0))
    log(f"{tag} slot step ({serving['slots']} slots at length "
        f"{int(marks[0].min())}-{int(marks[0].max())}), {timed_steps} "
        f"steps in turns graph / eager / eager / graph: "
        + ", ".join(f"{k} {v:.3f} ms ("
                    + ", ".join(f"{x:.3f}" for x in times[k == "graph"])
                    + ")" for k, v in step_ms.items())
        + f"; bound {bound['bound_ms']:.3f} ms ({bound['weight_bytes']} B of "
        f"weights, {bound['kv_bytes']} B of live KV), the graphed step at "
        f"{bound['bound_ms'] / step_ms.get('graph', step_ms['eager']):.1%}"
        " of it")
    prof = profile = None
    if cuda and profile_steps:
        _slot_reset(st, marks)
        prof = _profile_counts(lambda: [srv.slot_step(graphed=True)
                                        for _ in range(profile_steps)])
        seen = {k: _kernel_launches(prof["counts"], name)
                for k, name in SERVE_KERNELS.items()}
        want = {k: profile_steps * per_step[k] for k in SERVE_KERNELS}
        log(f"{tag} profiled {profile_steps} replays: kernel launches {seen} "
            f"(want {want}), device busy "
            f"{prof['busy_us'] / profile_steps / 1e3:.3f} ms a replay; the "
            f"window's first kernels {prof['ends'][0]}, lead "
            f"{prof['lead_us']} µs, tail {prof['tail_us']} µs")
        if seen != want:
            raise AssertionError(f"{tag} replays launched {seen}, want {want}"
                                 "; the window's first and last kernels "
                                 f"{prof['ends']}, lead {prof['lead_us']} µs,"
                                 f" tail {prof['tail_us']} µs; records lost "
                                 f"{_missing_in_replays(prof['names'], profile_steps)}")
        top = sorted(prof["us_by_name"].items(), key=lambda kv: -kv[1])[:6]
        log(f"{tag} a replay's kernels by device time: " + "; ".join(
            f"{us / profile_steps / 1e3:.3f} ms {name[:90]}"
            for name, us in top))
        _slot_reset(st, marks)
        profile = _profile_counts(lambda: [srv.step()
                                           for _ in range(profile_steps)])
        sync()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            srv.step()
        sync()
        iteration_ms = (time.perf_counter() - t0) / timed_steps * 1e3
        busy_ms = profile["busy_us"] / profile_steps / 1e3
        busy = profile["busy_us"] / profile["wall_us"]
        if lab_hook is not None:
            hooked = lab_hook(srv, marks)
        log(f"{tag} profiled {profile_steps} serving iterations ("
            f"{serving['slots']} slots decoding): wall "
            f"{profile['wall_us'] / profile_steps / 1e3:.3f} ms, device busy "
            f"{busy_ms:.3f} ms an iteration = {busy:.1%} of the profiled wall"
            f" (idle {1 - busy:.1%}); unprofiled, {timed_steps} iterations "
            f"take {iteration_ms:.3f} ms each (the profiled busy ms over "
            f"this unprofiled wall: {busy_ms / iteration_ms:.1%})")
    for rid in lab_rids:
        srv.cancel(rid)
    if srv.captures != (1 if cuda else 0):
        raise AssertionError(f"{tag} captures {srv.captures} after the lab")
    wall = time.perf_counter() - t_phase
    bank_ms = None
    if cuda and cfg.num_experts > 1 and bits:
        # the decode step's per-use dequantize of one layer's three banks,
        # timed alone, times the layers: what a replay spends on it
        from deepspeed_tpu_torch.models.transformer import layer_params

        banks = [n for n in ("w_in", "w_gate", "w_out")
                 if "layers." + n in engine.params]
        p0 = {k: v[0] for k, v in layer_params(engine.params).items()
              if k in banks}
        with torch.inference_mode():
            one = time_ms(lambda i: [engine.model._bank(p0, n, cfg.dtype)
                                     for n in banks], 5)
        bank_ms = one * cfg.n_layer
        log(f"{tag} the expert banks' per-use dequantize: {one:.3f} ms a "
            f"layer ({', '.join(banks)}; CUDA events, eager, alone), "
            f"{bank_ms:.3f} ms for the {cfg.n_layer} layers of a slot step")
    out = {"name": name, "serving": serving, "requests": requests,
           "tokens": tokens, "drain_s": drain_s,
           "tok_s": tokens / drain_s,
           "ttft_ms": {k: snap["ttft_s"][k] * 1e3 for k in ("p50", "p99")},
           "tpot_ms": {k: snap["tpot_s"][k] * 1e3 for k in ("p50", "p99")},
           "iterations": snap["iterations"], "replays": replays,
           "captures": srv.captures, "wrapper_counts": counted,
           "launches": launches,
           "captured": captured, "step_ms": step_ms, "step_bound": bound,
           "graph_vs_eager": diff,
           "teacher_forced_gap": worst, "argmax_share": exact / total,
           "solo_parity": solo, "peak_bytes": peak, "phase_s": wall,
           "kv_bytes": kv_bytes, "pages": pages, "exact_share": exact_share,
           "graph_pool_bytes": pool.get("bytes"), "bank_dequant_ms": bank_ms,
           "route_flips": route_stats.get("flips"),
           "route_decisions": route_stats.get("decisions"),
           "route_worst_margin": route_stats.get("worst_margin"),
           "captured_collectives": dict(srv.graph.captured_collectives)
           if srv.graph else {}}
    if profile is not None:
        out.update(busy_ms=busy_ms, iteration_ms=iteration_ms,
                   profiled_iteration_ms=profile["wall_us"] / profile_steps
                   / 1e3, replay_busy_ms=prof["busy_us"] / profile_steps / 1e3)
        if lab_hook is not None:
            out.update(hooked)
    log(f"[serve] {json.dumps({'tag': tag, **out})}")
    del srv
    if own_engine:
        del engine
    _free_memory(dev)
    return {**out, "served": streamed}


def phase_serve_all(cfg, *, device=None, requests=32, requests8=16,
                    requests_fg=16, serving=SERVING, paged_serving=PAGED,
                    shared=None, **kw) -> tuple:
    """Phase 11's streams, each through ``phase_serve`` on one engine per
    dtype: 11a bf16 contiguous; 11c the same stream paged (tokens equal
    11a's); 11e the shared-prefix stream contiguous, then paged (gates:
    prefix hit rate > 0, >= 2 copy-on-write copies; the exact share
    against contiguous recorded); 11f the first ``requests_fg`` requests
    of 11a's stream on a pool of half the pages (gates: evictions or
    defers > 0; every request served); 11g the same requests with int8
    KV; then 11b int8 WOQ contiguous and 11d the
    same paged (tokens equal 11b's). Returns (11a, 11b, {name: paged
    run})."""
    import torch

    dev = torch.device(device or "cuda")
    run = partial(phase_serve, cfg, device=device, **kw)
    _free_memory(dev)
    eng = _serve_engine(cfg, None, device)
    serve = run(engine=eng, name="11a", requests=requests, serving=serving)
    paged = {"11c": run(engine=eng, name="11c", requests=requests,
                        serving=paged_serving, solo_checks=0,
                        want_tokens=serve["served"])}
    shared = shared or _shared_stream(cfg.vocab_size)
    flat = run(engine=eng, name="11e contiguous", stream=shared,
               serving=serving, solo_checks=0)
    paged["11e"] = run(engine=eng, name="11e", stream=shared,
                       serving=paged_serving, solo_checks=0)
    same = sum(int(a == b) for g, w in zip(paged["11e"]["served"],
                                           flat["served"])
               for a, b in zip(g, w))
    paged["11e"]["exact_share_vs_contiguous"] = same / flat["tokens"]
    paged["11e"]["contiguous"] = {k: flat[k] for k in (
        "tok_s", "ttft_ms", "tpot_ms", "peak_bytes", "step_ms")}
    pages = paged["11e"]["pages"]
    log(f"[serve 11e] prefix hit rate {pages['prefix_hit_rate']:.4f}, "
        f"prefill tokens saved {pages['prefill_tokens_saved']} of "
        f"{pages['prompt_tokens']}, copy-on-write copies "
        f"{pages['cow_copies']}; served tokens equal the contiguous run's: "
        f"{same / flat['tokens']:.4f}; TTFT p50 "
        f"{paged['11e']['ttft_ms']['p50']:.1f} ms paged, "
        f"{flat['ttft_ms']['p50']:.1f} ms contiguous")
    if not (pages["prefix_hit_rate"] > 0 and pages["cow_copies"] >= 2):
        raise AssertionError(f"[serve 11e] pool {pages}: want a prefix hit "
                             "rate > 0 and >= 2 copy-on-write copies")
    del flat
    head = _serve_stream(cfg.vocab_size, requests,
                         prompt=kw.get("prompt", SERVE_PROMPT),
                         new=kw.get("new", SERVE_NEW))[:requests_fg]
    # half the pages: the lab's prompts halve too, so its slots all fit
    paged["11f"] = run(engine=eng, name="11f", stream=head,
                       serving={**paged_serving,
                                "pool_pages": 1 + (paged_serving["pool_pages"]
                                                   - 1) // 2},
                       solo_checks=0,
                       lab_prompt=kw.get("lab_prompt", 512) // 2)
    pages = paged["11f"]["pages"]
    if not (pages["evictions"] > 0 or pages["defers"] > 0):
        raise AssertionError(f"[serve 11f] pool {pages}: no eviction and "
                             "no defer under pressure")
    paged["11g"] = run(engine=eng, name="11g", stream=head,
                       serving={**paged_serving, "kv_quant_bits": 8},
                       solo_checks=0)
    for k in ("11f", "11g"):
        r = paged[k]
        r["exact_share_vs_11a"] = sum(
            int(a == b) for g, w in zip(r["served"], serve["served"])
            for a, b in zip(g, w)) / r["tokens"]
        log(f"[serve {k}] served tokens equal 11a's: "
            f"{r['exact_share_vs_11a']:.4f}")
    del eng
    _free_memory(dev)
    eng = _serve_engine(cfg, 8, device)
    serve8 = run(engine=eng, name="11b", bits=8, requests=requests8,
                 serving=serving)
    paged["11d"] = run(engine=eng, name="11d", bits=8, requests=requests8,
                       serving=paged_serving, solo_checks=0,
                       want_tokens=serve8["served"])
    del eng
    _free_memory(dev)
    log("[serve-paged] " + json.dumps({k: {
        x: r.get(x) for x in (
            "tok_s", "ttft_ms", "tpot_ms", "step_ms", "step_bound",
            "peak_bytes",
            "kv_bytes", "pages", "exact_share", "exact_share_vs_11a",
            "exact_share_vs_contiguous", "contiguous", "launches",
            "replay_busy_ms", "teacher_forced_gap")}
        for k, r in paged.items()}))
    return serve, serve8, paged


# ----------------------------------------------------------------- phase 12
def _mem_available():
    """MemAvailable of the host in bytes (None where /proc/meminfo is
    missing)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _state_groups(engine) -> dict:
    return {"master": engine.master, "mu": engine.opt_state.mu,
            "nu": engine.opt_state.nu}


def _scalars_of(engine) -> tuple:
    return (engine.step, engine.opt_state.count, engine.skipped_steps,
            engine.global_steps, engine.loss_scale)


def _state_diff(a: dict, b: dict) -> list:
    """The (group, leaf) pairs whose tensors are not bit-identical."""
    import torch

    return [(g, k) for g in a for k in a[g]
            if not torch.equal(a[g][k], b[g][k])]


def _clone_state(engine) -> dict:
    return {g: {k: t.clone() for k, t in d.items()}
            for g, d in _state_groups(engine).items()}


def phase_checkpoint(cfg=None, *, config=None, seq=1024, device=None,
                     root=None) -> dict:
    """Phase 12, checkpoint and resume on the main path: ``gpt2("1.5b")``
    under ``TRAIN_CONFIG`` at full width and depth. (a) Engine E1 takes 2
    steps, saves (sync, ``verify: "size"``), takes 2 more; those 2 steps
    are first run twice from one state, to show the step repeats bit for
    bit. (b) A fresh E2 (another seed) loads the tag and takes 2 steps:
    losses, grad norms, lr and every master / mu / nu leaf bit-identical to
    E1's, (c) with every layer's flash launches and the xent head's counted.
    (d) E2 saves async, takes a step while the writer runs, then commits;
    the tag verifies and, loaded into E1, equals E2's state at the save.
    (e) a ``[ckpt]`` JSON line with the bytes, the phases' seconds and
    rates, peak memory and free disk. The tags live under ``root``
    (default ``chiprun_out/phase12_ckpt`` beside this script), removed at
    the end whatever happens."""
    import dataclasses
    import shutil

    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops import xent as xe
    from deepspeed_tpu_torch.resilience import verify_tag
    from deepspeed_tpu_torch.runtime import random_token_dataset

    cfg = cfg or gpt2("1.5b")
    config = config or TRAIN_CONFIG
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kw = {} if device is None else {"device": device}
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                sa.sparse_fwd, sa.sparse_bwd_dq, sa.sparse_bwd_dkv,
                xe.xent_fwd, xe.xent_bwd)
    gas = config["gradient_accumulation_steps"]
    rows = config["train_micro_batch_size_per_gpu"] * gas
    tag = f"[ckpt {cfg.n_layer}L d{cfg.d_model}]"
    base = Path(root) if root else \
        Path(__file__).resolve().parent / "chiprun_out" / "phase12_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    disk = shutil.disk_usage(base)
    mem = _mem_available()
    log(f"{tag} free disk {disk.free / 1e9:.2f} GB of {disk.total / 1e9:.2f}"
        f" at {base}; host MemAvailable "
        f"{'?' if mem is None else f'{mem / 1e9:.2f}'} GB; the phase holds "
        "two tags on the disk and one set of host buffers per engine")
    # five batches of learnable rows, one per step, made once on the host
    data = [_token_batch(random_token_dataset(rows, seq, cfg.vocab_size,
                                              seed=40 + i, learnable=True))
            for i in range(5)]

    def engine(seed, async_save):
        conf = {**config, "checkpoint": {"verify": "size",
                                         "async_save": async_save}}
        return dt.initialize(conf, dt.build_model(
            cfg, attention_fn=dt.make_flash_attention()), seed=seed, **kw)

    def steps(eng, batches):
        out = []
        for b in batches:
            m = eng.train_batch(dict(b))
            out.append((float(m["loss"]), float(m["grad_norm"]), m["lr"]))
        return out

    t_phase = time.perf_counter()
    try:
        _free_memory(dev)
        # ---- (a) E1: 2 steps, the sync save, the next 2 steps twice ----
        e1 = engine(1234, False)
        first = steps(e1, data[:2])
        t = time.perf_counter()
        e1.save_checkpoint(str(base))
        sync_wall = time.perf_counter() - t
        save_t = dict(e1.last_checkpoint_timing)
        state_bytes = save_t["bytes"]
        sync_tag = f"global_step{e1.global_steps}"
        if verify_tag(base / sync_tag, "size")[0] != "verified":
            raise AssertionError(f"{tag} the sync tag does not verify")
        # the step itself repeats bit for bit: run the next 2 steps from
        # one state twice, the second run on a copy swapped into E1
        at_save, scal = _clone_state(e1), _scalars_of(e1)
        run_a = steps(e1, data[2:4])
        final_a, scal_a = _state_groups(e1), _scalars_of(e1)
        e1.master, e1.opt_state.mu, e1.opt_state.nu = (
            at_save["master"], at_save["mu"], at_save["nu"])
        (e1.step, e1.opt_state.count, e1.skipped_steps, e1.global_steps,
         e1.loss_scale) = scal
        run_b = steps(e1, data[2:4])
        repeat_diff = _state_diff(final_a, _state_groups(e1))
        if run_a != run_b or repeat_diff or scal_a != _scalars_of(e1):
            raise AssertionError(
                f"{tag} the step does not repeat bit for bit: {run_a} vs "
                f"{run_b}; leaves {repeat_diff[:8]}")
        del final_a, at_save
        _free_memory(dev)
        log(f"{tag} E1: steps 1-2 {first}; steps 3-4 run twice from one "
            f"state, bit-identical: {run_a}")
        # ---- (b) E2 (another seed) resumes from the sync tag ----
        e2 = engine(4321, True)
        t = time.perf_counter()
        e2.load_checkpoint(str(base))
        load_wall = time.perf_counter() - t
        load_t = dict(e2.last_checkpoint_timing)
        for c in counters:
            c.launches = 0
        resumed = steps(e2, data[2:4])
        got = {c.__name__: c.launches for c in counters}
        diff = _state_diff(_state_groups(e1), _state_groups(e2))
        if resumed != run_a or diff or _scalars_of(e2) != _scalars_of(e1):
            raise AssertionError(
                f"{tag} resumed steps {resumed} vs unbroken {run_a}; leaves "
                f"that differ {diff[:8]}; scalars {_scalars_of(e2)} vs "
                f"{_scalars_of(e1)}")
        # ---- (c) the resumed steps ran through the kernels ----
        per_step = cfg.n_layer * gas if cuda else 0
        head = gas if cuda and e2.model._fused_xent_active(
            cuda, e2.compute_dtype) else 0
        want = dict.fromkeys(got, 0)
        want.update({"flash_fwd": 2 * per_step * 2, "flash_bwd_dq":
                     per_step * 2, "flash_bwd_dkv": per_step * 2,
                     "xent_fwd": head * 2, "xent_bwd": head * 2})
        if got != want:
            raise AssertionError(f"{tag} launches over the 2 resumed steps "
                                 f"{got}, want {want}")
        log(f"{tag} E2 resumed from {sync_tag}: steps 3-4 {resumed}, "
            f"bit-identical to E1's (losses, grad norms, lr, every master / "
            f"mu / nu leaf, step, count, loss scale); launches over the 2 "
            f"steps {got}")
        # ---- (d) the async save, raced by a step ----
        held = _clone_state(e2)
        held_scal = _scalars_of(e2)
        t = time.perf_counter()
        e2.save_checkpoint(str(base))
        blocking = time.perf_counter() - t
        async_tag = f"global_step{e2.global_steps}"
        steps(e2, data[4:5])
        racing = e2._pending_save is not None \
            and e2._pending_save.thread.is_alive()
        e2.wait_for_checkpoint()
        commit = time.perf_counter() - t
        async_t = dict(e2.last_checkpoint_timing)
        if verify_tag(base / async_tag, "size")[0] != "verified" or \
                (base / "latest").read_text() != async_tag:
            raise AssertionError(f"{tag} the async tag is not committed")
        t = time.perf_counter()
        e1.load_checkpoint(str(base))
        load2_wall = time.perf_counter() - t
        load2_t = dict(e1.last_checkpoint_timing)
        diff = _state_diff(held, _state_groups(e1))
        if diff or _scalars_of(e1) != held_scal:
            raise AssertionError(f"{tag} the async tag differs from E2's "
                                 f"state at its save: {diff[:8]}")
        log(f"{tag} async save of {async_tag}: blocked the loop "
            f"{blocking * 1e3:.1f} ms, the step after it ran while the "
            f"writer wrote: {racing}; committed after {commit:.2f} s; loaded"
            " into E1 it equals E2's state at the save, bit for bit")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        del held
        gb = state_bytes / 1e9
        out = {
            "state_bytes": state_bytes, "tags": [sync_tag, async_tag],
            "sync_save": {"wall_s": sync_wall, "gb_per_s": gb / sync_wall,
                          "alloc_s": save_t["alloc_s"],
                          "d2h_s": save_t["d2h_s"],
                          "write_fsync_s": save_t["write_s"],
                          "write_gb_per_s": gb / save_t["write_s"],
                          "manifest_s": save_t["manifest_s"]},
            "async_save": {"blocking_ms": blocking * 1e3,
                           "commit_s": commit, "write_fsync_s":
                           async_t.get("write_s"), "racing_step": racing},
            "load": {"wall_s": load_wall, "gb_per_s": gb / load_wall,
                     "alloc_s": load_t["alloc_s"],
                     "read_copy_s": load_t["read_copy_s"],
                     "read_copy_gb_per_s": gb / load_t["read_copy_s"]},
            "load_async_tag": {"wall_s": load2_wall,
                               "gb_per_s": gb / load2_wall,
                               "alloc_s": load2_t["alloc_s"],
                               "read_copy_s": load2_t["read_copy_s"]},
            "peak_bytes": peak, "free_disk_bytes": disk.free,
            "mem_available_bytes": mem, "launches": got,
            "steps": {"first": first, "resumed": resumed},
            "phase_s": time.perf_counter() - t_phase}
        log("[ckpt] " + json.dumps(out))
        del e1, e2
        return out
    finally:
        shutil.rmtree(base, ignore_errors=True)
        _free_memory(dev)


def zero_collectives(engine) -> dict:
    """The collectives one optimizer step of ``engine``'s ZeRO layout
    issues, by kind, from ``engine.plans`` (a line of one rank in a larger
    world issues none): the loss mean, the norm, the casts' gathers and the
    grad reductions, each leaf over the batch lines its copies see, a dense
    leaf cut over ZeRO summed over ``expert`` after its reduce-scatter, a
    KV head several ranks hold summed over ``model``. The model's own
    collectives are :func:`tp_train_collectives`'."""
    from deepspeed_tpu_torch.platform.mesh import AXIS_ORDER, BATCH_AXES

    cfg, mesh, part = engine.config, engine.mesh, engine.partitioner
    gas = int(cfg.gradient_accumulation_steps)
    n = {"allgather": 0, "reduce_scatter": 0, "allreduce": 0}

    def add(kind, axes, count=1):
        if not mesh.solo(axes):
            n[kind] += count

    def gather(plan, axes, row_axes):
        """A cast, or qwZ's int8 gather: the row max where the rows are
        cut, the payload, the scales where they are cut too."""
        last = plan.master.dim == len(plan.shape) - 1
        if plan.qwz and last:
            add("allreduce", row_axes)
        add("allgather", axes)
        if plan.qwz and not last:
            add("allgather", axes)

    batch = BATCH_AXES
    add("allreduce", batch)                                  # the loss
    add("allreduce", part.dp_axes + ("expert", "model"))     # the norm
    if cfg.fp16.enabled:
        add("allreduce", AXIS_ORDER)                         # finite
    sizes, rest = [], set()
    for k in sorted(engine.plans):
        plan = engine.plans[k]
        lines = engine._grad_lines(k)
        if plan.compute is not None:
            done = set(plan.compute.axes)
            if plan.hier:
                gather(plan, ("data",), plan.master.axes)
                add("reduce_scatter", ("data",))
                done.add("data")
            elif part.mics:
                add("allreduce", ("data",))
                done.add("data")
            layers = plan.shape[0] if plan.layered else 1
            # forward gathers, the backward's gathers again (every layer
            # but the last is freed in the forward), the reduce-scatters
            add("allgather", plan.compute.axes,
                gas * (2 * layers - 1 if plan.layered else 1))
            add("reduce_scatter", plan.compute.axes, gas * layers)
            rest.add(tuple(a for a in lines if a not in done))
            continue
        if plan.master is not None:
            gather(plan, plan.master.axes, plan.master.axes)
        if plan.master is None or part.stage != 2:
            add("allreduce", lines)
            continue
        sizes.append(int(math.prod(plan.shape)))
        done = set(part.dp_axes)
        if part.mics:
            add("allreduce", ("data",))
            done.add("data")
        rest.add(tuple(a for a in lines if a not in done))
    buckets, size = 0, 0
    for k in sizes:
        if buckets == 0 or size + k > \
                cfg.zero_optimization.reduce_bucket_size:
            buckets, size = buckets + 1, 0
        size += k
    add("reduce_scatter", part.dp_axes, buckets)
    for axes in rest:                  # one flat all-reduce a line
        if mesh.size(axes) > 1:
            add("allreduce", axes)
    if engine.layout is not None and engine.layout.kv_shared:
        add("allreduce", "model")
    return {k: v for k, v in n.items() if v}


def _recomputed(model, policy) -> dict:
    """The forward collectives of one layer that its remat region issues
    again in the backward, by kind: a checkpoint reruns its region in
    order up to the last op whose saved tensors the backward needs and
    stops there, so a region's trailing collective (a row-parallel
    reduction a residual add alone follows) is not issued again. ``wo``'s
    reduction runs again inside a whole-layer checkpoint (the MLP's
    products follow it), ``w_out``'s where a post-LN norm follows it
    inside the region, and an MoE block's whole exchange (its combine
    saves the returned slots)."""
    if policy in (None, "none"):
        return {}
    cfg = model.cfg
    moe = cfg.num_experts > 1
    whole = not policy.startswith("save_names")
    out = {}

    def add(kind, count=1):
        out[kind] = out.get(kind, 0) + count

    if whole:
        add("allreduce")
    if cfg.post_ln and not moe:
        add("allreduce")
    if moe:
        add("allreduce")
        add("alltoall", 2)
    return out


def tp_train_collectives(engine) -> dict:
    """The collectives one optimizer step of ``engine`` issues, by kind,
    from its config and layout (a line of one rank in a larger world, or no
    process group, issues none): :func:`zero_collectives`, and for each
    micro-batch the model's under its ``TPLayout``: the vocab-parallel
    embedding's all-reduce where the vocabulary is split; a layer's
    Megatron *g* after ``wo`` and ``w_out`` (forward) and *f* before q / k
    / v and ``w_in`` (backward), an MoE layer's two all-to-alls over
    ``expert`` each way in place of the dense MLP's, with its *f* and *g*;
    what a remat region issues again (:func:`_recomputed`); the head's
    ``fused_token_nll_tp`` (three all-reduces forward, dx's backward) or
    vocab-parallel NLL (max, sum, shift and target forward; *f* and the
    max's sum backward)."""
    n = dict(zero_collectives(engine))
    lay = engine.layout
    if lay is None:
        return n
    cfg, model = engine.model.cfg, engine.model
    gas = int(engine.config.gradient_accumulation_steps)

    def add(kind, axes, count=1):
        if not lay.mesh.solo(axes) and count:
            n[kind] = n.get(kind, 0) + count * gas

    moe = cfg.num_experts > 1
    if lay.vocab_split:
        add("allreduce", "model")                     # the embedding
    again = _recomputed(model, engine.remat_policy)
    L = cfg.n_layer
    add("allreduce", "model", L * 4)      # wo and w_out: f and g each
    if moe:
        add("alltoall", "expert", L * 4)
    add("allreduce", "model", L * again.get("allreduce", 0))
    add("alltoall", "expert", L * again.get("alltoall", 0))
    if model._fused_xent_active(engine.device.type == "cuda",
                                engine.compute_dtype):
        add("allreduce", "model", 4)
    elif lay.vocab_split:
        add("allreduce", "model", 6)
    return n


def _collective_kind(name: str):
    """A profiler event's collective kind: the ``c10d`` ops by name."""
    if not name.startswith("c10d::"):
        return None
    for kind in ("reduce_scatter", "allgather", "allreduce", "alltoall"):
        if kind in name:
            return kind
    return None


def _nested_in_itself(event) -> bool:
    """Is a profiler event inside an event of its own name? A collective
    issued inside a selective checkpoint's region is recorded again under
    its dispatch mode (``PythonDispatchMode``), one call seen twice."""
    p = event.cpu_parent
    while p is not None:
        if p.name == event.name:
            return True
        p = p.cpu_parent
    return False


def _measure_step(eng, batch, timed_batches, cuda: bool) -> dict:
    """One profiled optimizer step of ``eng`` (the ``c10d`` collectives by
    kind, NCCL's device records by name and time, device busy against the
    wall), then the timed steps (median); the state moves on."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        sync()
        t0 = time.perf_counter()
        eng.train_batch(dict(batch))
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kinds, nccl, busy = {}, {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            if "nccl" in e.name.lower():
                # ProcessGroupNCCL's device range of a collective
                # ("nccl:_all_gather_base"), or an NCCL kernel
                c, t = nccl.get(e.name, (0, 0.0))
                nccl[e.name] = (c + 1, t + us)
            if not e.name.startswith("nccl:"):   # a range, not work
                busy += us
        else:
            kind = _collective_kind(e.name)
            if kind and not _nested_in_itself(e):
                kinds[kind] = kinds.get(kind, 0) + 1
    times = []
    for b in timed_batches:
        sync()
        t0 = time.perf_counter()
        m = eng.train_batch(dict(b))
        float(m["loss"])
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms": statistics.median(times), "step_ms_all": times,
            "profiled_wall_ms": wall_us / 1e3,
            "busy_ms": busy / 1e3 if cuda else None,
            "idle_share": 1 - busy / wall_us if cuda else None,
            "nccl_ms": sum(t for k, (_, t) in nccl.items()
                           if k.startswith("nccl:")) / 1e3,
            "nccl_kernels": {k: {"count": c, "us": t}
                             for k, (c, t) in nccl.items()},
            "collectives": kinds}


def phase_zero(cfg=None, *, config=None, seq=1024, device=None, steps=2,
               timed=2, stages=(1, 2, 3)) -> dict:
    """Phase 13, ZeRO in a world of one over NCCL on the main path:
    ``gpt2("1.5b")`` under ``TRAIN_CONFIG``. (a) The engine with no
    process group (every leaf whole, no collective) takes ``steps`` steps
    from one copy of the initial state; its losses, grad norms and a copy
    of every master / mu / nu leaf are kept (on the device: 18.7 GB beside
    an engine's ~33 GiB, compared there in milliseconds). (b) ``init_
    distributed`` joins a world of one (NCCL; ``gloo`` with ``device=
    "cpu"``), and an engine at each of ``stages`` takes the same steps
    from the same state: everything bit-identical to (a) (every collective
    over a group of one is a copy), each layer's flash and the head's xent
    launches counted, then one profiled step (the ``c10d`` collectives by
    kind against :func:`tp_train_collectives`: the layout's and, with a
    group, the model's at tp 1, the NCCL kernels by name and
    time, device busy and idle) and ``timed`` timed steps (median). A
    ``[zero]`` JSON line; every engine is freed before the next."""
    import os

    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import gpt2
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import xent as xe
    from deepspeed_tpu_torch.platform.device import nvidia_smi_line
    from deepspeed_tpu_torch.platform.distributed import (_free_port,
                                                          init_distributed)
    from deepspeed_tpu_torch.runtime import random_token_dataset

    cfg = cfg or gpt2("1.5b")
    config = config or TRAIN_CONFIG
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kw = {} if device is None else {"device": device}
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, xe.xent_fwd,
                xe.xent_bwd)
    gas = config["gradient_accumulation_steps"]
    rows = config["train_micro_batch_size_per_gpu"] * gas
    tag = f"[zero {cfg.n_layer}L d{cfg.d_model}]"
    data = [_token_batch(random_token_dataset(rows, seq, cfg.vocab_size,
                                              seed=60 + i, learnable=True))
            for i in range(steps + 1 + timed)]
    t_phase = time.perf_counter()
    _free_memory(dev)
    gen = torch.Generator(device=dev).manual_seed(1234)
    init = dt.build_model(cfg).init(gen, device=dev, dtype=torch.float32)

    def engine(stage):
        conf = {**config, "zero_optimization": {"stage": stage}}
        return dt.initialize(conf, dt.build_model(
            cfg, attention_fn=dt.make_flash_attention()), params=init, **kw)

    def run(eng, batches):
        out = []
        for b in batches:
            m = eng.train_batch(dict(b))
            out.append((float(m["loss"]), float(m["grad_norm"]), m["lr"]))
        return out

    def state(eng):
        return {g: {k: t.detach().clone() for k, t in d.items()}
                for g, d in _state_groups(eng).items()}

    def measure(eng):
        return _measure_step(eng, data[steps], data[steps + 1:], cuda)

    out = {"card": nvidia_smi_line() if cuda else None, "stages": {}}
    try:
        # ---- (a) the engine with no process group ----
        if dist.is_initialized():
            raise AssertionError(f"{tag} a process group is already up")
        def peak(held):
            """The engine's own peak bytes: above what the phase holds."""
            return torch.cuda.max_memory_allocated() - held if cuda else 0

        held = _free_memory(dev)
        ref = engine(config["zero_optimization"]["stage"])
        want = run(ref, data[:steps])
        ref_peak = peak(held)
        want_state = state(ref)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        held += sum(t.numel() * t.element_size()
                    for d in want_state.values() for t in d.values())
        out["reference"] = {"steps": want, **measure(ref)}
        out["reference"]["peak_bytes"] = max(ref_peak, peak(held))
        del ref
        log(f"{tag} reference (no process group): steps {want}, "
            f"{out['reference']['step_ms']:.1f} ms a step")
        # ---- (b) a world of one over NCCL, stage by stage ----
        os.environ.pop("WORLD_SIZE", None)
        init_distributed(f"localhost:{_free_port()}", 1, 0, **kw)
        for stage in stages:
            held = _free_memory(dev)
            eng = engine(stage)
            for c in counters:
                c.launches = 0
            got = run(eng, data[:steps])
            launches = {c.__name__: c.launches for c in counters}
            diff = [(g, k) for g, d in _state_groups(eng).items()
                    for k, t in d.items()
                    if not torch.equal(t, want_state[g][k])]
            if got != want or diff:
                raise AssertionError(
                    f"{tag} stage {stage} over a world of one: steps {got} vs "
                    f"{want} with no process group; leaves that differ "
                    f"{diff[:8]}")
            per_step = cfg.n_layer * gas if cuda else 0
            head = gas if cuda and eng.model._fused_xent_active(
                cuda, eng.compute_dtype) else 0
            expect = {"flash_fwd": 2 * per_step * steps, "flash_bwd_dq":
                      per_step * steps, "flash_bwd_dkv": per_step * steps,
                      "xent_fwd": head * steps, "xent_bwd": head * steps}
            if launches != expect:
                raise AssertionError(f"{tag} stage {stage}: launches "
                                     f"{launches}, want {expect}")
            m = measure(eng)
            want_kinds = tp_train_collectives(eng)
            if m["collectives"] != want_kinds:
                raise AssertionError(
                    f"{tag} stage {stage}: collectives of a step "
                    f"{m['collectives']}, the layout issues {want_kinds}")
            if cuda and not m["nccl_kernels"]:
                raise AssertionError(f"{tag} stage {stage}: the profiler "
                                     "shows no NCCL work on the device")
            m["peak_bytes"] = peak(held)
            m["launches"] = launches
            m["gather_peak_layers"] = eng.gather_peak_layers
            out["stages"][stage] = m
            log(f"{tag} stage {stage}: bit-identical to the engine with no "
                f"process group over {steps} steps; launches {launches}; "
                f"collectives {m['collectives']}; step {m['step_ms']:.1f} ms"
                f", NCCL {m['nccl_ms']:.2f} ms, peak "
                f"{m['peak_bytes'] / 2**30:.2f} GiB")
            del eng
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        _free_memory(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log("[zero] " + json.dumps(out))
    return out


def checkpoint_write_probe(threads=(1, 2, 4, 8), nbytes=6_229_000_000,
                           root=None) -> dict:
    """How fast the checkpoint's three state files (master, mu, nu of GPT-2
    1.5B: ``nbytes`` each) reach the disk from pinned host buffers, written
    at once with ``threads`` writer threads a file (``tensorfile.
    write_file``), each set fsynced; then read back warm. A one-off
    measurement, not a phase::

        python3 -c "import chip_smoke as c; c.checkpoint_write_probe()"
    """
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from deepspeed_tpu_torch.runtime.checkpoint import tensorfile as tf

    base = Path(root) if root else \
        Path(__file__).resolve().parent / "chiprun_out" / "write_probe"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    out = {}
    try:
        t = time.perf_counter()
        bufs = [torch.zeros(nbytes, dtype=torch.uint8,
                            pin_memory=torch.cuda.is_available())
                for _ in range(3)]
        out["alloc_s"] = time.perf_counter() - t
        lay = tf.Layout.of({"x": (torch.uint8, (nbytes,))})
        for n in threads:
            t = time.perf_counter()
            with ThreadPoolExecutor(3) as ex:
                for f in [ex.submit(tf.write_file, base / f"{i}.safetensors",
                                    lay, b, n) for i, b in enumerate(bufs)]:
                    f.result()
            w = time.perf_counter() - t
            out[f"threads_{n}"] = {"write_s": w,
                                   "gb_per_s": 3 * nbytes / 1e9 / w}
            log(f"[ckpt-write] 3 files x {nbytes / 1e9:.2f} GB, {n} "
                f"thread(s) a file: {w:.2f} s, {3 * nbytes / 1e9 / w:.2f} "
                "GB/s")
        t = time.perf_counter()
        with ThreadPoolExecutor(3) as ex:
            for f in [ex.submit(tf.read_data, base / f"{i}.safetensors",
                                lay, b) for i, b in enumerate(bufs)]:
                f.result()
        r = time.perf_counter() - t
        out["read_warm"] = {"read_s": r, "gb_per_s": 3 * nbytes / 1e9 / r}
        log(f"[ckpt-write] read back (warm): {r:.2f} s, "
            f"{3 * nbytes / 1e9 / r:.2f} GB/s")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    return out


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
                             "library_ms", "cuda_core_bound_ms")
                            if k in times[name]}})
    return rows


# ----------------------------------------------------------------- phase 14
# 14b: TRAIN_CONFIG at micro 2 x gas 2 x 1024 tokens with the moe section
# (GShard training: capacity 1.25, drops on); a constant lr of 1e-3, as a
# 2-layer untied trunk learns the repeated-token rows more slowly than
# GPT-2 1.5B's 48 tied layers under phase 6's warm-up
MOE_TRAIN_CONFIG = {**TRAIN_CONFIG, "train_batch_size": 4,
                    "train_micro_batch_size_per_gpu": 2,
                    "gradient_accumulation_steps": 2,
                    "optimizer": {"type": "adamw",
                                  "params": {"lr": 1e-3,
                                             "weight_decay": 0.01}},
                    "scheduler": None,
                    "moe": {"enabled": True, "num_experts": 8}}


def _moe_serve_engine(cfg, *, bits=8, group=128, device=None, seed=2024,
                      conf=None):
    """14a's InferenceEngine over ``cfg``'s weights drawn on the card one
    layer at a time (fp32 normals from a seeded generator at the init's
    scales, rounded to ``cfg.dtype``), each weight the engine would
    quantize quantized at once into preallocated int8 stacks, as the
    engine quantizes it (``quantize``: one layer and one expert at a time).
    The transient is one layer's leaf: a bf16 Mixtral-8x7B (93 GB) never
    exists. The router stays fp32; norms are ones. ``conf``: more
    inference config (phase 15's ``expert_parallel``)."""
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.quantization import (
        QuantizedTensor, _should_quantize, quantize)
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.models.transformer import _BIASES

    dev = torch.device(device or "cuda")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    scales = model._init_scales()
    keep = set(model.fp32_param_names())
    params = {}
    for name, shape in model.param_shapes().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("_scale"):
            params[name] = torch.ones(shape, dtype=cfg.dtype, device=dev)
            continue
        if leaf.endswith("_bias") or leaf in _BIASES:
            params[name] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            continue
        scale = scales.get(name, 1.0 / math.sqrt(shape[-2]))
        dtype = torch.float32 if leaf in keep else cfg.dtype

        def draw(s, scale=scale, dtype=dtype):
            t = torch.randn(s, generator=gen, device=dev)
            return t.mul_(scale).to(dtype)

        if leaf in keep or not _should_quantize(
                leaf, torch.empty(shape, device="meta"), 4096):
            params[name] = draw(shape)
            continue
        layered = name.startswith("layers.")
        if not layered:
            params[name] = quantize(draw(shape), group, bits)
            continue
        first = quantize(draw(shape[1:]), group, bits)
        q = torch.empty((shape[0],) + tuple(first.q.shape), dtype=torch.int8,
                        device=dev)
        sc = torch.empty((shape[0],) + tuple(first.scale.shape),
                         dtype=torch.float32, device=dev)
        q[0].copy_(first.q)
        sc[0].copy_(first.scale)
        del first
        for i in range(1, shape[0]):
            qt = quantize(draw(shape[1:]), group, bits)
            q[i].copy_(qt.q)
            sc[i].copy_(qt.scale)
            del qt
        params[name] = QuantizedTensor(q, sc, group, bits)
    kw = {} if device is None else {"device": device}
    engine = dt.init_inference(
        model, params, {"dtype": str(cfg.dtype).removeprefix("torch."),
                        "quantize": True, "quant_bits": bits,
                        "quant_group_size": group, **(conf or {})}, **kw)
    del params
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return engine


# 14a's depth: 16 of Mixtral-8x7B's 32 layers (cut in PR 22, with 15a's, so
# that the run with phase 17 stays well inside its time limit: 14a took
# 111 s of it at 32 layers)
MOE_SERVE_LAYERS = 16


def phase_moe(serve_cfg=None, train_cfg=None, *, device=None, requests=16,
              serving=None, train_config=None, train_seq=1024, warmup=2,
              steps=4, **serve_kw) -> dict:
    """Phase 14: (a) Mixtral-8x7B int8 served at full width and
    ``MOE_SERVE_LAYERS`` layers (``phase_serve`` on ``_moe_serve_engine``,
    11b's stream); (b) a 2-layer
    full-width Mixtral trained (``phase_train`` under
    ``MOE_TRAIN_CONFIG``). Each engine is freed before the next. Small
    ``serve_cfg`` / ``train_cfg`` and ``device="cpu"`` rehearse it."""
    import torch

    from deepspeed_tpu_torch.inference.quantization import quantized_bytes
    from deepspeed_tpu_torch.models import mixtral

    dev = torch.device(device or "cuda")
    t0 = time.perf_counter()
    _free_memory(dev)
    scfg = serve_cfg or mixtral("8x7b", n_layer=MOE_SERVE_LAYERS,
                                moe_drop_tokens=False)
    t1 = time.perf_counter()
    engine = _moe_serve_engine(scfg, device=device)
    build_s = time.perf_counter() - t1
    wbytes = quantized_bytes(engine.params)
    log(f"[serve 14a] Mixtral {scfg.n_layer}L d{scfg.d_model} E"
        f"{scfg.num_experts} top-{scfg.moe_top_k} int8 built in {build_s:.1f}"
        f" s: {wbytes / 2**30:.2f} GiB of weights and scales "
        f"({scfg.param_count() / 1e9:.2f} B params, "
        f"{scfg.param_count(active_only=True) / 1e9:.2f} B active a token); "
        f"router {engine.params['layers.router'].dtype}")
    serve = phase_serve(scfg, bits=8, requests=requests,
                        serving=serving or SERVING, device=device,
                        engine=engine, name="14a", solo_checks=0, **serve_kw)
    del engine
    _free_memory(dev)
    tcfg = train_cfg or mixtral("8x7b", n_layer=2)
    train_config = train_config or {**MOE_TRAIN_CONFIG, "moe": {
        **MOE_TRAIN_CONFIG["moe"], "num_experts": tcfg.num_experts}}
    train = phase_train(tcfg, config=train_config,
                        check_layers=tcfg.n_layer, seq=train_seq,
                        warmup=warmup, steps=steps, name="train 14b",
                        device=device)
    _free_memory(dev)
    wall = time.perf_counter() - t0
    line = {"serve": {k: serve.get(k) for k in (
        "tok_s", "ttft_ms", "tpot_ms", "step_ms", "step_bound", "peak_bytes",
        "launches", "captured", "captures", "replay_busy_ms",
        "bank_dequant_ms", "graph_pool_bytes", "teacher_forced_gap",
        "argmax_share", "graph_vs_eager", "busy_ms", "iteration_ms")},
        "weight_bytes": wbytes, "build_s": build_s,
        "train": {k: train.get(k) for k in (
            "step_ms", "tokens_per_s", "mfu", "peak_bytes", "losses",
            "loss_rel", "grad_rel", "launches", "route_flips",
            "router_dtypes", "busy_share")},
        "phase_s": wall}
    log(f"[moe] {json.dumps(line)}")
    return {"serve": serve, "train": train, "phase_s": wall}


# ----------------------------------------------------------------- phase 15
# phase 2's rank shapes: (name, H, KV) of decode attention at B 8, cache
# 1024 (Llama-2-7B's heads at tp 2 / 4, the 70B GQA heads at tp 4 / 8)
TP_DECODE = (("llama7b_tp2", 16, 16), ("llama7b_tp4", 8, 8),
             ("70b_tp4", 16, 2), ("70b_tp8", 8, 1))
# (name, K, N, out) of woq_matmul int8, bf16 x, M 8: Llama-2-7B's column
# shards and its row shards, whose fp32 partials the rank all-reduces
TP_WOQ = (("wqkv_tp2", 4096, 6144, None), ("wqkv_tp4", 4096, 3072, None),
          ("w_in_tp2", 4096, 5504, None), ("w_in_tp4", 4096, 2752, None),
          ("wo_tp2", 2048, 4096, "float32"), ("wo_tp4", 1024, 4096, "float32"),
          ("w_out_tp2", 5504, 4096, "float32"))
# (name, V, K, group) of woq_matmul_t int4: OPT-6.7B's tied table on a rank
# of tp 2 / 4 (50272 rows at group 128: one group, so each rank's is one)
TP_WOQ_T = (("opt_head_tp2", 25136, 4096, 128),
            ("opt_head_tp4", 12568, 4096, 128))


def phase_tp_kernels(device="cuda", iters=100, M=8) -> dict:
    """Phase 2 at the rank shapes of a tensor-parallel world of 2 / 4:
    each kernel against its plain version at phase 2's gates (decode
    attention: L = 0 rows exactly 0, two calls bit-identical; WOQ: its
    share of max |out|, two calls bit-identical), then timed against its
    bound (bytes at 3.35 TB/s), its plain version and the library call.
    Llama-2-7B's ``w_out`` at tp 4 (86 groups over 4 ranks) takes the
    per-use dequantize, as the JAX package's gate does: checked, not
    launched. A ``[tp-kernels]`` JSON line."""
    import torch

    from deepspeed_tpu_torch.inference.quantization import quantize
    from deepspeed_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device=device).manual_seed(15)
    out = {"decode_attention": {}, "woq_matmul": {}, "woq_matmul_t": {}}
    for name, H, KV in TP_DECODE:
        q, ck, cv, length, _ = _case(gen, B=8, H=H, KV=KV, S=1024,
                                     lengths=(1, 1024, 513, 0, 700, 1023, 64,
                                              900), device=device)
        got = da.decode_attention(q, ck, cv, length)
        again = da.decode_attention(q, ck, cv, length)
        want = da.decode_attention_plain(q, ck, cv, length)
        err = (got.float() - want.float()).abs().max().item()
        ok = (math.isfinite(err) and err <= TOL["torch.bfloat16"]
              and torch.equal(got, again) and bool((got[3] == 0).all()))
        log(f"[kernel] decode_attention {name} B8 H{H} KV{KV} S1024: "
            f"max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"decode_attention {name}: err {err}")
        out["decode_attention"][name] = {"max_abs_err": err}
        del q, ck, cv, got, again, want
    for name, K, N, o in TP_WOQ:
        err, _ = _woq_check(gen, "mm", M, K, N, 128, 8, "bfloat16", o, device)
        out["woq_matmul"][name] = {"max_abs_err": err}
    for name, V, K, group in TP_WOQ_T:
        err, _ = _woq_check(gen, "mmt", M, V, K, group, 4, "bfloat16",
                            "float32", device)
        out["woq_matmul_t"][name] = {"max_abs_err": err}
    w = torch.randn((11008, 64), generator=gen, device=device)
    shard = quantize(w, 128, 8).rows(2752, 5504)
    if shard.aligned:
        raise AssertionError("w_out at tp 4: the shard should be off its "
                             "groups (the per-use dequantize)")
    out["woq_matmul"]["w_out_tp4"] = {"route": "per-use dequantize",
                                      "row0": shard.row0}
    if device != "cuda":
        return out
    for name, H, KV in TP_DECODE:
        out["decode_attention"][name].update(_decode_timing(
            gen, name, 8, H, KV, 128, 1024, 8, iters))
    for name, K, N, o in TP_WOQ:
        t = _woq_timing(gen, "mm", M, K, N, 128, 8, o, iters)
        out["woq_matmul"][name].update(t)
    for name, V, K, group in TP_WOQ_T:
        t = _woq_timing(gen, "mmt", M, V, K, group, 4, "float32", iters)
        out["woq_matmul_t"][name].update(t)
    for fam in out.values():
        for r in fam.values():
            if "ms" in r:
                r["bound_by"] = r.get("bound_by") or (
                    "bytes" if r["t_bytes"] >= r["t_ops"] else "operations")
    log("[tp-kernels] " + json.dumps(out))
    return out


def _rank_rows(shapes: dict) -> dict:
    """A kernel's rank shapes for the kernels line: µs, bound µs, route."""
    return {k: {"us": r["ms"] * 1e3, "bound_us": r["bound_ms"] * 1e3,
                "route": r.get("route", "cuda")} if "ms" in r
            else {"route": r.get("route")} for k, r in shapes.items()}


def tp_collectives(engine) -> dict:
    """The collectives one slot step (T = 1) of ``engine`` issues, by kind,
    from its config and layout (a line of one rank in a larger world, or
    no process group, issues none): the embedding's all-reduce and the
    head's all-gather where the vocabulary is split; a layer's all-reduce
    after ``wo`` and after ``w_out`` (one for both where a parallel residual
    reduces at tp > 1), an MoE layer's ``("expert", "model")`` combine in
    place of the second; ``tp_comm_quant`` at tp > 1 spells a dense
    reduction as ``int8_psum``'s two all-to-alls and two all-gathers."""
    from deepspeed_tpu_torch.inference.quantization import QuantizedTensor

    lay, cfg = engine.layout, engine.model.cfg
    n: dict = {}

    def add(kind, axes, count=1):
        if not lay.mesh.solo(axes):
            n[kind] = n.get(kind, 0) + count

    def reduce(dense_quantized):
        if dense_quantized:
            add("alltoall", "model", 2)
            add("allgather", "model", 2)
        else:
            add("allreduce", "model")

    tpq = lay.tp > 1 and bool(getattr(engine.model, "tp_quant", 0))
    wo_q = tpq and not isinstance(engine.params["layers.wo"],
                                  QuantizedTensor)
    moe = cfg.num_experts > 1
    if lay.vocab_split:
        add("allreduce", "model")
        add("allgather", "model")
    for _ in range(cfg.n_layer):
        if cfg.parallel_residual and lay.tp > 1 and not moe and not wo_q:
            add("allreduce", "model")
            continue
        reduce(wo_q)
        if moe:
            add("allreduce", ("expert", "model"))
        else:
            reduce(wo_q and not isinstance(engine.params["layers.w_out"],
                                           QuantizedTensor))
    return n


def _tp_lab(srv, marks) -> dict:
    """Phase 15's measurement on the lab's full slots: one eager slot step
    profiled, its ``c10d`` collectives by kind and NCCL's device records
    (the replays' own window is phase 11's gated one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    st = srv.state
    _slot_reset(st, marks)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        srv.slot_step(graphed=False)
        torch.cuda.synchronize()
    kinds, nccl = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if "nccl" in e.name.lower():
                nccl[e.name] = nccl.get(e.name, 0) + 1
        else:
            kind = _collective_kind(e.name)
            if kind:
                kinds[kind] = kinds.get(kind, 0) + 1
    return {"eager_collectives": kinds, "eager_nccl_records": nccl}


# 15a's depth: 8 of Llama-2-7B's 32 layers (cut in PR 22, with 14a's; the
# world-of-one checks are per layer, and their gates follow the depth)
TP_SERVE_LAYERS = 8


def phase_tp(cfg=None, moe_cfg=None, *, device=None, requests=16,
             moe_requests=16, serving=None, paged_serving=None,
             **serve_kw) -> dict:
    """Phase 15: tensor and expert parallelism in a world of one over NCCL
    (``gloo`` with ``device="cpu"``), on phase 11's serving path.

    First ``moe_cfg`` (a 2-layer Mixtral-8x7B int8 at full width) and
    ``cfg`` (Llama-2-7B int8 at ``TP_SERVE_LAYERS`` layers) serve 11b's
    stream with no process group and
    no profile: the references. Then
    ``init_distributed`` joins a world of one;
    (a) ``cfg``'s engine with ``tensor_parallel: 1`` serves 11b's stream
    contiguous and paged, (b) ``moe_cfg``'s with ``expert_parallel: 1`` its
    stream, each through ``phase_serve`` (profiled windows of 2 replays):
    its gates, tokens bit-identical to the reference, and the collectives
    the capture recorded equal to :func:`tp_collectives`; for 15a also
    those a profiled eager slot step issued, with NCCL's device records in
    that step. A ``[tp]`` JSON line; every engine is freed
    before the next and the process group destroyed at the end."""
    import os

    import torch
    import torch.distributed as dist

    from deepspeed_tpu_torch.models import llama2, mixtral
    from deepspeed_tpu_torch.platform.distributed import (_free_port,
                                                          init_distributed)

    cfg = cfg or llama2("7b", n_layer=TP_SERVE_LAYERS)
    moe_cfg = moe_cfg or mixtral("8x7b", n_layer=2, moe_drop_tokens=False)
    serving = serving or SERVING
    paged_serving = paged_serving or PAGED
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    # the references unprofiled, the sharded runs in windows of 2 replays
    # and one eager profile (15a's): a profiled window late in a run risks
    # ROADMAP §3's lost record
    run = partial(phase_serve, device=device, solo_checks=0,
                  **{"profile_steps": 2, **serve_kw})
    hook = _tp_lab if cuda else None
    _free_memory(dev)
    if dist.is_initialized():
        raise AssertionError("[tp] a process group is already up")
    eng = _moe_serve_engine(moe_cfg, device=device)
    ref_b = run(moe_cfg, bits=8, engine=eng, name="15b no group",
                requests=moe_requests, serving=serving, profile_steps=0)
    del eng
    _free_memory(dev)
    eng = _serve_engine(cfg, 8, device)
    ref_a = run(cfg, bits=8, engine=eng, name="15a no group",
                requests=requests, serving=serving, profile_steps=0)
    del eng
    _free_memory(dev)
    out = {"no_group_step_ms": {"15a": ref_a["step_ms"],
                                "15b": ref_b["step_ms"]}}
    os.environ.pop("WORLD_SIZE", None)
    init_distributed(f"localhost:{_free_port()}", 1, 0,
                     **({} if device is None else {"device": device}))
    try:
        runs = []
        eng = _serve_engine(cfg, 8, device, conf={"tensor_parallel": 1})
        for name, scfg in (("15a", serving), ("15a paged", paged_serving)):
            runs.append((name, run(
                cfg, bits=8, engine=eng, name=name, requests=requests,
                serving=scfg, want_tokens=ref_a["served"],
                lab_hook=hook if name == "15a" else None)))
        want = {"15a": tp_collectives(eng)}
        del eng
        _free_memory(dev)
        eng = _moe_serve_engine(moe_cfg, device=device,
                                conf={"expert_parallel": 1})
        runs.append(("15b", run(
            moe_cfg, bits=8, engine=eng, name="15b", requests=moe_requests,
            serving=serving, want_tokens=ref_b["served"])))
        want["15b"] = tp_collectives(eng)
        del eng
        for name, r in runs:
            w = want[name.split()[0]]
            got = {"captured": r["captured_collectives"],
                   "eager": r.get("eager_collectives", w)}
            log(f"[tp {name}] collectives a slot step: captured "
                f"{got['captured']}, a profiled eager step's c10d ops "
                f"{got['eager']}, reckoned {w}; NCCL's device records in "
                f"the eager step {r.get('eager_nccl_records')} (a world of "
                "one: NCCL's in-place all-reduce puts nothing on the "
                "device, an all-gather a copy); step ms {r['step_ms']}")
            if got["eager"] != w or (cuda and got["captured"] != w):
                raise AssertionError(f"[tp {name}] collectives {got}, the "
                                     f"layout issues {w}")
            if cuda and name == "15a" and not r.get("eager_nccl_records"):
                raise AssertionError(f"[tp {name}] no NCCL record on the "
                                     "device in the eager slot step")
            out[name] = {k: r.get(k) for k in (
                "tok_s", "ttft_ms", "tpot_ms", "step_ms", "step_bound",
                "launches", "captured", "captures", "captured_collectives",
                "eager_collectives", "eager_nccl_records", "exact_share",
                "replay_busy_ms", "peak_bytes", "kv_bytes")}
        out["collectives"] = want
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        _free_memory(dev)
    out["phase_s"] = time.perf_counter() - t0
    log("[tp] " + json.dumps(out))
    return out


# ----------------------------------------------------------------- phase 16
# 16a's shapes: OPT-6.7B's tied head (T tokens, V rows, d) cut over tp 2, 4
# and 8 (25136, 12568 and 6284 rows a rank), and the flash kernels at the
# rank's heads (OPT-6.7B's 32 heads over tp 2 / 4 / 8, hd 128, S 2048, B 2:
# 16b's micro-batch rows)
TP_TRAIN_HEAD = ("opt_6.7b_head", 4096, 50272, 4096)
TP_TRAIN_TPS = (2, 4, 8)
TP_TRAIN_FLASH = tuple((f"opt_6.7b_tp{tp}", 2, 32 // tp, 32 // tp, 2048, 128,
                        True, None, "torch.bfloat16") for tp in TP_TRAIN_TPS)
TP_XENT_TOL_SHARE = {"nll": 1e-4, "lse": 1e-4, "dx": 2e-2, "dw": 2e-2}
# 16b: OPT-6.7B at full width, 4 layers, the fused tied head, phase 7's
# config (micro 4 x gas 2, bf16, ZeRO 1, remat dots_saveable) at 2048
# tokens; and phase 14b's 2-layer Mixtral-8x7B
TP_TRAIN_SEQ = 2048


def phase_tp_train_kernels(device="cuda", head=TP_TRAIN_HEAD,
                           tps=TP_TRAIN_TPS, flash=TP_TRAIN_FLASH,
                           iters=20) -> dict:
    """Phase 16a: the xent kernels at a TP rank's training shapes. For
    each ``tp`` and each rank r: ``xent_fwd`` in ``partials`` mode on rows
    ``[v0, v0 + V / tp)`` of the head (a view of the table, its 16-byte
    aligned row v0) with the targets shifted by v0 (foreign ones, and two
    outside the vocabulary, match no row), the partials combined with
    ``ops.xent.tp_combine``'s arithmetic (the max, the sum of exps about
    it, the target logits summed), then ``xent_bwd`` against the
    global lse; held against ``xent_fwd`` / ``xent_bwd`` on the whole head:
    nll and lse within 1e-4, dx (the sum over the ranks) and each rank's dW
    within 2e-2 of max |whole|; each backward called twice, bit-identical.
    Each rank's two calls timed (device) beside their bounds; the plain
    versions once a ``tp``. Then the flash kernels at the rank's heads
    (``_flash_timing``: checked against the plain versions, timed against
    SDPA)."""
    import torch

    from deepspeed_tpu_torch.ops import xent as xe

    name, T, V, d = head
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(16)
    x, w, _, t, g = _xent_case(gen, T, V, d, False, torch.bfloat16, dev)
    nll_w, lse_w = xe.xent_fwd(x, w, None, t)
    dx_w, dw_w, _ = xe.xent_bwd(x, w, None, t, lse_w, g)
    out = {"head": {"T": T, "V": V, "d": d}, "shards": {}, "errors": {}}
    worst = {k: 0.0 for k in TP_XENT_TOL_SHARE}

    def share(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))

    for tp in tps:
        rows = V // tp
        parts, shards = [], []
        for r in range(tp):
            v0 = r * rows
            ws = w[v0:v0 + rows]
            if ws.data_ptr() % 16:
                raise AssertionError(f"[tp-train {name}] rank {r} of tp {tp}"
                                     ": its table rows are not 16-byte "
                                     "aligned")
            shards.append((v0, ws, t - v0))
            parts.append(xe.xent_fwd(x, ws, None, t - v0, partials=True))
        tgt = torch.stack([p[0] for p in parts]).sum(0)
        lse_l = torch.stack([p[1] for p in parts])
        m = lse_l.amax(0)
        lse = m + torch.log(torch.exp(lse_l - m).sum(0))
        nll = lse - tgt
        dx = torch.zeros(x.shape, dtype=torch.float32, device=dev)
        errs = {"nll": share(nll, nll_w), "lse": share(lse, lse_w), "dw": 0.0}
        for r, (v0, ws, tl) in enumerate(shards):
            dxr, dwr, _ = xe.xent_bwd(x, ws, None, tl, lse, g)
            dxr2, dwr2, _ = xe.xent_bwd(x, ws, None, tl, lse, g)
            if not (torch.equal(dxr, dxr2) and torch.equal(dwr, dwr2)):
                raise AssertionError(f"[tp-train {name}] tp {tp} rank {r}: "
                                     "the backward called twice differs")
            dx += dxr.float()
            errs["dw"] = max(errs["dw"], share(dwr, dw_w[v0:v0 + rows]))
        errs["dx"] = share(dx, dx_w)
        bad = {k: v for k, v in errs.items() if v > TP_XENT_TOL_SHARE[k]}
        if bad:
            raise AssertionError(f"[tp-train {name}] tp {tp}: {bad} against "
                                 f"the whole head (gates {TP_XENT_TOL_SHARE})")
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
        out["errors"][tp] = errs
        b = xent_bound(T, rows, d, False)
        v0, ws, tl = shards[0]
        plain = {"xent_fwd": time_ms(lambda i: xe.xent_fwd_plain(
                     x, ws, None, tl, partials=True), 3),
                 "xent_bwd": time_ms(lambda i: xe.xent_bwd_plain(
                     x, ws, None, tl, lse, g), 3)}
        for r, (v0, ws, tl) in enumerate(shards):
            fwd = device_ms(lambda i: xe.xent_fwd(x, ws, None, tl,
                                                  partials=True), 1, iters)
            bwd = device_ms(lambda i: xe.xent_bwd(x, ws, None, tl, lse, g),
                            1, iters)
            out["shards"][f"tp{tp}_r{r}"] = {
                "rows": rows, "v0": v0,
                "xent_fwd": {"ms": fwd, "bound_ms": b["xent_fwd"]["bound_ms"],
                             "bound_by": b["xent_fwd"]["bound_by"],
                             "plain_ms": plain["xent_fwd"]},
                "xent_bwd": {"ms": bwd, "bound_ms": b["xent_bwd"]["bound_ms"],
                             "bound_by": b["xent_bwd"]["bound_by"],
                             "plain_ms": plain["xent_bwd"]}}
            log(f"[tp-train] {name} tp {tp} rank {r} (rows [{v0}, "
                f"{v0 + rows})): xent_fwd partials {fwd * 1e3:.2f} us "
                f"(bound {b['xent_fwd']['bound_ms'] * 1e3:.2f}, "
                f"{b['xent_fwd']['bound_ms'] / fwd:.1%}), xent_bwd "
                f"{bwd * 1e3:.2f} us (bound "
                f"{b['xent_bwd']['bound_ms'] * 1e3:.2f}, "
                f"{b['xent_bwd']['bound_ms'] / bwd:.1%})")
        log(f"[tp-train] {name} tp {tp}: the shards' partials combined and "
            f"their backward against the whole head: {errs} (gates "
            f"{TP_XENT_TOL_SHARE} of max |whole|)")
    out["max_abs_err"] = worst
    out["flash"] = {}
    if dev.type == "cuda":
        for case in flash:
            out["flash"][case[0]] = _flash_timing(gen, case, iters)
    log("[tp-train-kernels] " + json.dumps(out))
    return out


def _host_copy(engine) -> dict:
    """The engine's master / mu / nu on the host (a reference that leaves
    the card's memory to the next engine)."""
    return {g: {k: t.detach().to("cpu", copy=True) for k, t in d.items()}
            for g, d in _state_groups(engine).items()}


def phase_tp_train(opt_cfg=None, moe_cfg=None, *, device=None,
                   seq=TP_TRAIN_SEQ, moe_seq=1024, steps=2, timed=2,
                   kernels=True) -> dict:
    """Phase 16: tensor and expert parallelism in training. (a) with
    ``kernels`` on the card: :func:`phase_tp_train_kernels`. (b) Each of
    ``opt_cfg`` (OPT-6.7B at full width, 4 layers, the fused tied head,
    under ``TRAIN_CONFIG`` with ``mesh: {model: 1}``) and ``moe_cfg``
    (phase 14b's 2-layer Mixtral-8x7B under ``MOE_TRAIN_CONFIG`` with
    ``mesh: {expert: 1}``): the engine with no process group takes
    ``steps`` steps from one initial state (its state kept on the host);
    then ``init_distributed`` joins a world of one over NCCL (``gloo`` with
    ``device="cpu"``) and the engine takes the same steps through every TP
    and EP branch (the vocab-parallel lookup, Megatron's *f* and *g*,
    ``fused_token_nll_tp``, the expert all-to-all), each collective over a
    group of one: losses, grad norms, lr and every master / mu / nu leaf
    bit-identical; flash and xent launches as the config implies; one
    profiled step's ``c10d`` collectives by kind exactly
    :func:`tp_train_collectives` and NCCL's records on the device; then
    ``timed`` steps: step ms, tokens/s, MFU at 989 TFLOP/s, peak memory,
    the device's busy share, beside the engine with no group's step
    (measured the same way after its state was copied). A ``[tp-train]``
    JSON line; every engine is
    freed before the next, the group destroyed after each model."""
    import os

    import torch
    import torch.distributed as dist

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import mixtral, opt
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import xent as xe
    from deepspeed_tpu_torch.platform.device import nvidia_smi_line
    from deepspeed_tpu_torch.platform.distributed import (_free_port,
                                                          init_distributed)
    from deepspeed_tpu_torch.runtime import random_token_dataset

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    kw = {} if device is None else {"device": device}
    t_phase = time.perf_counter()
    out = {"card": nvidia_smi_line() if cuda else None}
    if kernels and cuda:
        out["kernels"] = phase_tp_train_kernels(device=str(dev))
        _free_memory(dev)
    opt_cfg = opt_cfg or opt("6.7b", n_layer=4)
    moe_cfg = moe_cfg or mixtral("8x7b", n_layer=2)
    moe_config = {**MOE_TRAIN_CONFIG, "moe": {
        **MOE_TRAIN_CONFIG["moe"], "num_experts": moe_cfg.num_experts}}
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, xe.xent_fwd,
                xe.xent_bwd)
    runs = (("opt", opt_cfg, {**TRAIN_CONFIG, "mesh": {"model": 1}}, seq),
            ("mixtral", moe_cfg, {**moe_config, "mesh": {"expert": 1}},
             moe_seq))
    if dist.is_initialized():
        raise AssertionError("[tp-train] a process group is already up")
    for name, cfg, config, s in runs:
        tag = f"[tp-train {name} {cfg.n_layer}L d{cfg.d_model}]"
        gas = config["gradient_accumulation_steps"]
        rows = config["train_micro_batch_size_per_gpu"] * gas
        data = [_token_batch(random_token_dataset(rows, s, cfg.vocab_size,
                                                  seed=160 + i,
                                                  learnable=True))
                for i in range(steps + 1 + timed)]
        _free_memory(dev)

        def engine(conf):
            """An engine from the one initial state, drawn on the device
            from the same seed for each (and freed once it is copied)."""
            gen = torch.Generator(device=dev).manual_seed(1616)
            init = dt.build_model(cfg).init(gen, device=dev,
                                            dtype=torch.float32)
            return dt.initialize(conf, dt.build_model(
                cfg, attention_fn=dt.make_flash_attention()), params=init,
                **kw)

        def run(eng, batches):
            res = []
            for b in batches:
                m = eng.train_batch(dict(b))
                res.append((float(m["loss"]), float(m["grad_norm"]),
                            m["lr"]))
            return res

        ref = engine({k: v for k, v in config.items() if k != "mesh"})
        want = run(ref, data[:steps])
        want_state = _host_copy(ref)
        # the state moves on: the comparison's copy is taken
        no_group = _measure_step(ref, data[steps], data[steps + 1:], cuda)
        del ref
        _free_memory(dev)
        os.environ.pop("WORLD_SIZE", None)
        init_distributed(f"localhost:{_free_port()}", 1, 0, **kw)
        try:
            held = _free_memory(dev)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            eng = engine(config)
            for c in counters:
                c.launches = 0
            got = run(eng, data[:steps])
            launches = {c.__name__: c.launches for c in counters}
            diff = [(g, k) for g, d in _state_groups(eng).items()
                    for k, t in d.items()
                    if not torch.equal(t.detach().cpu(), want_state[g][k])]
            if got != want or diff:
                raise AssertionError(
                    f"{tag} over a world of one through the TP / EP branches:"
                    f" steps {got} vs {want} with no process group; leaves "
                    f"that differ {diff[:8]}")
            del want_state
            per_step = cfg.n_layer * gas if cuda else 0
            head = gas if cuda and eng.model._fused_xent_active(
                cuda, eng.compute_dtype) else 0
            expect = {"flash_fwd": 2 * per_step * steps, "flash_bwd_dq":
                      per_step * steps, "flash_bwd_dkv": per_step * steps,
                      "xent_fwd": head * steps, "xent_bwd": head * steps}
            if launches != expect:
                raise AssertionError(f"{tag} launches {launches}, want "
                                     f"{expect}")
            m = _measure_step(eng, data[steps], data[steps + 1:], cuda)
            want_kinds = tp_train_collectives(eng)
            if m["collectives"] != want_kinds:
                raise AssertionError(
                    f"{tag} collectives of a step {m['collectives']}, the "
                    f"config and layout issue {want_kinds}")
            if cuda and not m["nccl_kernels"]:
                raise AssertionError(f"{tag} the profiler shows no NCCL work "
                                     "on the device")
            tokens = rows * s
            flops = cfg.flops_per_token() * tokens
            m.update(
                steps=got, launches=launches,
                launches_per_step={k: v // steps for k, v in launches.items()},
                reckoned=want_kinds, tokens_per_s=tokens / m["step_ms"] * 1e3,
                mfu=flops / (m["step_ms"] / 1e3)
                / PEAK_OPS_PER_S["torch.bfloat16"],
                busy_share=(m["busy_ms"] / m["profiled_wall_ms"]
                            if cuda else None),
                peak_bytes=(torch.cuda.max_memory_allocated() - held
                            if cuda else 0),
                fused_head=bool(head), seq=s, rows=rows,
                no_group={k: no_group[k] for k in (
                    "step_ms", "step_ms_all", "busy_ms",
                    "profiled_wall_ms")})
            out[name] = m
            log(f"{tag} world of one, NCCL: bit-identical to the engine with "
                f"no process group over {steps} steps; launches {launches}; "
                f"collectives {m['collectives']}; step {m['step_ms']:.1f} ms, "
                f"{m['tokens_per_s']:.0f} tokens/s, MFU {m['mfu']:.1%}, busy "
                f"{m['busy_share'] or 0:.1%}, peak "
                f"{m['peak_bytes'] / 2**30:.2f} GiB; with no process group "
                f"{no_group['step_ms']:.1f} ms a step")
            del eng
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            _free_memory(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log("[tp-train] " + json.dumps(out))
    return out


# the phases run in a process of their own (``--phase``): each profiles a
# window, and late in one long process a window now and then lost a kernel
# record (ROADMAP.md §3); phase 12 for its host memory; the time a child
# may take
# ----------------------------------------------------------------- phase 17
SPEC = {"ngram": 3, "max_draft": 4}
SPEC_SERVING = {**SERVING, "speculation": SPEC}
SPEC_PAGED = {**PAGED, "speculation": SPEC}
# the motif-tiled half of the stream: a motif of 4-8 tokens tiled to a
# prompt of 128-512, 64-128 new tokens (prompt-lookup traffic: code edits,
# quoting a retrieved document)
SPEC_MOTIF = (4, 8)
SPEC_PROMPT = (128, 512)
SPEC_NEW = (64, 128)
# the verify forward's fp32 logits against the plain graphed step's,
# teacher-forced from one state: phase 3's gate (bf16 GEMMs at M 40 and at
# M 8 round apart)
SPEC_LOGIT_TOL_SHARE = LOGIT_TOL_SHARE


def _spec_stream(vocab: int, n: int = 16, seed: int = 17, motif=SPEC_MOTIF,
                 prompt=SPEC_PROMPT, new=SPEC_NEW) -> list:
    """Phase 17's stream: ``n`` requests, the even ones motif-tiled prompts
    (``motif`` tokens tiled to ``prompt``, ``new`` to generate), the odd
    ones the first ``n // 2`` of phase 11's stream; request seeds 1000 +
    i."""
    import numpy as np

    rng = np.random.default_rng(seed)
    plain = _serve_stream(vocab, 32)[:n // 2]
    out = []
    for i in range(n):
        if i % 2 == 0:
            m = rng.integers(0, vocab, int(rng.integers(motif[0],
                                                       motif[1] + 1)))
            P = int(rng.integers(prompt[0], prompt[1] + 1))
            p = np.tile(m, -(-P // len(m)))[:P].astype(np.int32)
            out.append((p, int(rng.integers(new[0], new[1] + 1)), 1000 + i))
        else:
            out.append((plain[i // 2][0], plain[i // 2][1], 1000 + i))
    return out


def _spec_warm(srv, vocab: int) -> None:
    """Phase 17's warm-up, one request at a time: a random 32-token prompt
    (plain steps: the slot graph's capture), then a motif-tiled one of up
    to 96 tokens (the verify graph's, once it drafts); no block shared
    with the stream."""
    import numpy as np

    P = min(96, srv.cfg.max_len // 2)
    motif = np.random.default_rng(99).integers(0, vocab, 5)
    for p, n in ((_serve_stream(vocab, 1, seed=99)[0][0][:32], 8),
                 (np.tile(motif, 20)[:P].astype(np.int32), P // 2)):
        srv.serve_batch([p], [n])


def _serve_timed(srv, stream, sync) -> tuple:
    """Submit ``stream`` at t = 0 and drain; (rids, results, seconds)."""
    srv.stats.reset()
    rids = [srv.submit(p, n, seed=s) for p, n, s in stream]
    t0 = time.perf_counter()
    done = srv.drain()
    sync()
    return rids, done, time.perf_counter() - t0


def _spec_gaps(srv) -> tuple:
    """Record the plain lane's top-two logit gap of every token it emits:
    ``srv.slot_step`` wrapped, each step's (slot -> (rid, token index))
    and its (slots,) gap on the device; ``read()`` returns {rid: {index:
    gap}} after one host read."""
    import torch

    steps = []
    step = srv.slot_step

    def rec(graphed=None):
        at = {s: (r.rid, len(r.tokens)) for s, r in srv.sched.running.items()}
        lg, ok = step(graphed=graphed)
        top = lg[:, 0].topk(2, dim=-1).values
        steps.append((at, top[:, 0] - top[:, 1]))
        return lg, ok

    def read() -> dict:
        gaps = torch.stack([g for _, g in steps]).cpu().tolist() \
            if steps else []
        out: dict = {}
        for (at, _), row in zip(steps, gaps):
            for slot, (rid, idx) in at.items():
                out.setdefault(rid, {})[idx] = row[slot]
        return out

    srv.slot_step = rec
    return read


def _spec_lab(srv, cfg, tag, cuda, lab_prompt, lab_new, timed,
              profile_steps, per_step) -> dict:
    """Phase 17's measurements on full slots: max_draft + 1 plain graphed
    steps from one state, then (the state reset) one graphed verify fed the
    plain lane's own next tokens as drafts: the largest |logit| distance
    and the largest change of a logit difference (each row's spread of
    the verify's logits less the plain step's), the winners against the
    plain tokens; the eager verify against the graphed one from the same
    state (the same winners: gated); the graphed plain step and verify
    replay timed in turns; a profiled window of ``profile_steps`` verify
    replays counted by kernel name (``per_step`` each: gated)."""
    import torch

    K = srv.cfg.speculation.max_draft
    slots = srv.cfg.slots
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    srv.end_drain()
    lab = _serve_stream(cfg.vocab_size, slots, seed=1,
                        prompt=(lab_prompt, lab_prompt),
                        new=(lab_new, lab_new))
    rids = [srv.submit(p, n, seed=s) for p, n, s in lab]
    for _ in range(64 * slots):
        if srv.sched.occupancy == slots:
            break
        srv.step()
    else:
        raise AssertionError(f"{tag} the lab's {slots} requests did not all "
                             "reach a slot")
    sync()
    st = srv.state
    marks = _slot_marks(st)
    plain_lg, plain_tok = [], []
    for _ in range(K + 1):
        lg, _ = srv.slot_step(graphed=cuda)
        plain_lg.append(lg[:, 0].clone())
        plain_tok.append(st.tok.clone())
    _slot_reset(st, marks)
    drafts = torch.stack(plain_tok[:K], dim=1).cpu().numpy()
    lg_v, back = srv.verify_step(drafts, graphed=cuda)
    lg_v, back = lg_v.clone(), back.clone()
    want = torch.stack(plain_lg, dim=1)
    delta = lg_v - want
    dist = delta.abs().max().item()
    spread = (delta.amax(-1) - delta.amin(-1)).max().item()
    scale = want.abs().max().item()
    winners = (back[:, :-1] == torch.stack(plain_tok, dim=1)).float()
    _slot_reset(st, marks)
    lg_e, back_e = srv.verify_step(drafts, graphed=False)
    eager_same = bool(torch.equal(back_e, back))
    eager_diff = (lg_e - lg_v).abs().max().item()
    log(f"{tag} teacher-forced from one state ({slots} slots at length "
        f"{int(marks[0].min())}-{int(marks[0].max())}): the verify's logits "
        f"against {K + 1} plain graphed steps' max |diff| {dist:.4e} = "
        f"{dist / scale:.3e} of max |logit| {scale:.3f} (tol "
        f"{SPEC_LOGIT_TOL_SHARE}), largest change of a logit difference "
        f"{spread:.4e}; winners equal to the plain tokens "
        f"{winners.mean().item():.4f}; eager vs graphed verify: winners "
        f"identical {eager_same}, logits max |diff| {eager_diff:.3e}")
    if not dist <= SPEC_LOGIT_TOL_SHARE * scale:
        raise AssertionError(f"{tag} the verify's logits are {dist:.4e} from "
                             f"the plain steps' ({dist / scale:.3e} of max "
                             "|logit|)")
    if not eager_same:
        raise AssertionError(f"{tag} the graphed and the eager verify gave "
                             "different winners")
    times: dict = {}
    for verify in (True, False, False, True):
        _slot_reset(st, marks)
        sync()
        t0 = time.perf_counter()
        for _ in range(timed):
            if verify:
                srv.verify_step(drafts, graphed=cuda)
            else:
                srv.slot_step(graphed=cuda)
        sync()
        times.setdefault("verify" if verify else "step", []).append(
            (time.perf_counter() - t0) / timed * 1e3)
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    log(f"{tag} {timed} graphed verify replays (M {slots * (K + 1)}) and "
        f"plain steps (M {slots}) in turns: verify {ms['verify']:.3f} ms ("
        + ", ".join(f"{x:.3f}" for x in times["verify"]) + f"), plain step "
        f"{ms['step']:.3f} ms (" + ", ".join(f"{x:.3f}"
                                            for x in times["step"]) + ")")
    out = {"teacher_forced_max_abs": dist, "teacher_forced_share":
           dist / scale, "logit_difference_change": spread,
           "winners_equal_share": winners.mean().item(),
           "eager_vs_graph_logits": eager_diff, "verify_ms": ms["verify"],
           "step_ms": ms["step"], "lab_lengths": marks[0].tolist()}
    if cuda and profile_steps:
        _slot_reset(st, marks)
        prof = _profile_counts(lambda: [srv.verify_step(drafts, graphed=True)
                                        for _ in range(profile_steps)])
        seen = {k: _kernel_launches(prof["counts"], SERVE_KERNELS[k])
                for k in per_step}
        want_seen = {k: profile_steps * v for k, v in per_step.items()}
        busy = prof["busy_us"] / profile_steps / 1e3
        log(f"{tag} profiled {profile_steps} verify replays: kernel launches "
            f"{seen} (want {want_seen}), device busy {busy:.3f} ms a replay; "
            f"lead {prof['lead_us']} µs, tail {prof['tail_us']} µs")
        if seen != want_seen:
            raise AssertionError(
                f"{tag} verify replays launched {seen}, want {want_seen}; the "
                f"window's first and last kernels {prof['ends']}, lead "
                f"{prof['lead_us']} µs, tail {prof['tail_us']} µs; records "
                f"lost {_missing_in_replays(prof['names'], profile_steps)}")
        top = sorted(prof["us_by_name"].items(), key=lambda kv: -kv[1])[:6]
        log(f"{tag} a verify replay's kernels by device time: " + "; ".join(
            f"{us / profile_steps / 1e3:.3f} ms {name[:90]}"
            for name, us in top))
        out.update(verify_busy_ms=busy, verify_profile_launches=seen)
    for rid in rids:
        srv.cancel(rid)
    return out


def _first_divergences(on: list, off: list, rids_off: list, gaps: dict,
                       limit: float) -> tuple:
    """Spec-on against spec-off tokens: (the share of equal tokens, each
    first divergence as (request, index, spec-off's top-two gap there),
    those whose gap exceeds ``limit``)."""
    same = total = 0
    parts, bad = [], []
    for i, (a, b, rid) in enumerate(zip(on, off, rids_off)):
        same += sum(int(x == y) for x, y in zip(a, b))
        total += len(b)
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        g = gaps.get(rid, {}).get(j)
        parts.append((i, j, g))
        if g is None or g > limit:
            bad.append((i, j, g))
    return same / total, parts, bad


def _spec_way(engine, cfg, name, bits, serving, stream, *, device,
              lab_prompt, lab_new, timed, profile_steps) -> dict:
    """One way of phase 17 on one engine: the stream with speculation on
    (gated), the lab (``_spec_lab``), then the same stream with it off,
    its tokens held to spec-on's."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import woq_matmul as wm
    from deepspeed_tpu_torch.resilience.guards import RequestStatus

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    paged = serving.get("page_size", 0) > 0
    tag = f"[spec {name} {cfg.n_layer}L d{cfg.d_model} " + (
        f"int{bits}" if bits else str(cfg.dtype)[6:]) + \
        (f" paged {serving['page_size']}" if paged else "") + "]"
    # woq_matmul a replay of either graph: the fused qkv, wo, w_in, w_gate
    # and w_out of every layer, and the untied head
    per = (5 * cfg.n_layer + (not cfg.tie_embeddings)) \
        if bits and engine.model.woq_kernel else 0
    per_step = {"woq_matmul": per} if per else {}
    counters = (da.decode_attention, wm.woq_matmul, wm.woq_matmul_t)
    srv = dt.ServingEngine(engine, serving)
    log(f"{tag} ServingEngine {serving}, flash_decode {engine.flash_decode};"
        f" {len(stream)} requests, prompts "
        f"{min(len(p) for p, _, _ in stream)}-"
        f"{max(len(p) for p, _, _ in stream)}, max_new "
        f"{min(n for _, n, _ in stream)}-{max(n for _, n, _ in stream)}")
    for c in counters:
        c.launches = 0
    _spec_warm(srv, cfg.vocab_size)
    rids, done, drain_s = _serve_timed(srv, stream, sync)
    counted = {c.__name__: c.launches for c in counters}
    snap, spec = srv.stats.snapshot(), srv.spec_snapshot()
    bad = [(r, done[r].status.value, len(done[r].tokens))
           for r, (_, n, _) in zip(rids, stream)
           if done[r].status is not RequestStatus.OK
           or len(done[r].tokens) != n]
    if bad:
        raise AssertionError(f"{tag} requests not served in full: {bad}")
    on = [list(done[r].tokens) for r in rids]
    tokens = sum(n for _, n, _ in stream)
    graphs = {"step": srv.graph, "verify": srv.verify_graph}
    captured = {k: dict(g.captured_launches) if g else {}
                for k, g in graphs.items()}
    replays = {k: g.replays if g else 0 for k, g in graphs.items()}
    launches = {k: v - sum(c.get(k, 0) for c in captured.values())
                + sum(captured[g].get(k, 0) * replays[g] for g in captured)
                for k, v in counted.items()}
    pages = srv.pool.snapshot() if paged else None
    log(f"{tag} spec on: {len(stream)} requests, {tokens} tokens in "
        f"{drain_s:.3f} s: {tokens / drain_s:.1f} tok/s; TPOT p50 "
        f"{snap['tpot_s']['p50'] * 1e3:.2f} ms; TTFT p50 "
        f"{snap['ttft_s']['p50'] * 1e3:.1f} ms; speculation {json.dumps(spec)}"
        f"; captures slot step {srv.captures}, verify {srv.verify_captures}; "
        f"the wrappers' counts {counted}, captured {captured}, replays "
        f"{replays}: device launches {launches}")
    if cuda:
        if srv.captures != 1 or srv.verify_captures != 1:
            raise AssertionError(f"{tag} captures: slot step {srv.captures}, "
                                 f"verify {srv.verify_captures}; want 1 each")
        want = {k: 4 * per_step.get(k, 0) for k in counted}
        if counted != want or captured != {"step": per_step,
                                           "verify": per_step}:
            raise AssertionError(f"{tag} wrapper counts {counted} (want "
                                 f"{want}: two eager steps and two captures)"
                                 f", captured {captured} (want {per_step} "
                                 "each)")
    if not (spec["verify_steps"] > 0 and spec["accepted_tokens"] > 0):
        raise AssertionError(f"{tag} speculation {spec}: want verify steps "
                             "and accepted drafts")
    if pages is not None:
        log(f"{tag} pool after the drain: {json.dumps(pages)}")
        if pages["free_pages"] + pages["tree_held_pages"] \
                != pages["usable_pages"]:
            raise AssertionError(f"{tag} pages leaked: {pages}")
    lab = _spec_lab(srv, cfg, tag, cuda, lab_prompt, lab_new, timed,
                    profile_steps, per_step)
    if srv.captures != (1 if cuda else 0) or \
            srv.verify_captures != (1 if cuda else 0):
        raise AssertionError(f"{tag} captures {srv.captures} / "
                             f"{srv.verify_captures} after the lab")
    del srv
    _free_memory(dev)

    # ---- the same stream, speculation off: its tokens, and each token's
    # top-two logit gap ----
    off_cfg = {k: v for k, v in serving.items() if k != "speculation"}
    off = dt.ServingEngine(engine, off_cfg)
    read_gaps = _spec_gaps(off)
    _spec_warm(off, cfg.vocab_size)
    rids_off, done_off, drain_off = _serve_timed(off, stream, sync)
    snap_off = off.stats.snapshot()
    offt = [list(done_off[r].tokens) for r in rids_off]
    gaps = read_gaps()
    share, parts, apart = _first_divergences(
        on, offt, rids_off, gaps, lab["logit_difference_change"])
    log(f"{tag} spec off: {tokens / drain_off:.1f} tok/s, TPOT p50 "
        f"{snap_off['tpot_s']['p50'] * 1e3:.2f} ms (spec on: "
        f"{tokens / drain_s:.1f} tok/s, {snap['tpot_s']['p50'] * 1e3:.2f} "
        f"ms; accepted tokens a step {spec['accepted_tokens_per_step']:.3f})"
        f"; spec-on tokens equal spec-off's: {share:.4f}; first divergences "
        f"(request, token, spec-off's top-two gap) {parts}, each allowed up "
        f"to the lab's largest change of a logit difference "
        f"{lab['logit_difference_change']:.4e}")
    if apart:
        raise AssertionError(f"{tag} spec-on parts from spec-off where "
                             f"spec-off's top-two gap exceeds "
                             f"{lab['logit_difference_change']:.4e}: {apart}")
    del off
    _free_memory(dev)
    return {"name": name, "serving": serving, "requests": len(stream),
            "tokens": tokens, "tok_s": tokens / drain_s,
            "tpot_ms_p50": snap["tpot_s"]["p50"] * 1e3,
            "ttft_ms_p50": snap["ttft_s"]["p50"] * 1e3,
            "off_tok_s": tokens / drain_off,
            "off_tpot_ms_p50": snap_off["tpot_s"]["p50"] * 1e3,
            "speculation": spec, "captures": 1 if cuda else 0,
            "wrapper_counts": counted, "captured": captured,
            "replays": replays, "launches": launches, "pages": pages,
            "exact_share": share, "divergences": parts,
            "tokens_equal": np.mean([a == b for a, b in zip(on, offt)]),
            **lab}


def phase_spec(cfg=None, *, device=None, requests=16, serving=SPEC_SERVING,
               paged_serving=SPEC_PAGED, stream=None, lab_prompt=512,
               lab_new=256, timed=8, profile_steps=4) -> dict:
    """Phase 17: self-speculative decoding in the ``ServingEngine`` on
    Llama-2-7B at full width and depth, ``flash_decode`` off (the verify
    runs the dense cache attention), ``SPEC`` (n-gram 3, max_draft 4):
    17a bf16 over contiguous slots, 17b int8 WOQ over the paged pool
    (``PAGED``'s pages). Each serves ``_spec_stream`` (half motif-tiled
    prompts, half phase 11's requests) after a warm-up, the kernel counts
    zeroed before it. Gates: every request OK with its ``max_new`` tokens;
    the slot graph and the verify graph each captured exactly once; verify
    steps and accepted drafts > 0; in int8 each capture records 161
    ``woq_matmul`` launches and a profiled window of verify replays shows
    161 a replay by name; the pool ends with every page free or held by
    the tree; the teacher-forced verify within ``SPEC_LOGIT_TOL_SHARE`` of
    the plain steps' logits, and the eager verify's winners equal the
    graphed one's; spec-on tokens equal spec-off's (the same stream, the
    same engine), or each first divergence falls where spec-off's top-two
    logit gap is at most the lab's largest change of a logit difference
    (the verify's GEMMs run at M 40, the plain step's at M 8, and round
    apart). Recorded: tokens/s, TPOT and the accepted tokens a step with
    speculation on and off, the exact share, the verify and plain step
    times. A ``[spec]`` JSON line."""
    import torch

    from deepspeed_tpu_torch.models import llama2

    cfg = cfg or llama2("7b")
    dev = torch.device(device or "cuda")
    stream = stream or _spec_stream(cfg.vocab_size, requests)
    out = {}
    for name, bits, scfg in (("17a", None, serving),
                             ("17b", 8, paged_serving)):
        _free_memory(dev)
        engine = _serve_engine(cfg, bits, device,
                               conf={"flash_decode": False})
        out[name] = _spec_way(engine, cfg, name, bits, scfg, stream,
                              device=device, lab_prompt=lab_prompt,
                              lab_new=lab_new, timed=timed,
                              profile_steps=profile_steps)
        del engine
        _free_memory(dev)
    log("[spec] " + json.dumps(out, default=_jsonable))
    return out


# ----------------------------------------------------------------- phase 18
# the KV tiers under the paged ServingEngine: 10 sessions of a 512-token
# prompt, two turns each, on 257 pages of 16 (256 usable < 10 x 32 prompt
# blocks, so the earlier sessions' prefixes are evicted)
TIER_PAGED = {**SERVING, "page_size": PAGE_SIZE, "pool_pages": 257}
TIER_SESSIONS = 10      # cut from 16 for the run's time limit
TIER_PROMPT = 512
TIER_NEW = 64           # each turn's new tokens
TIER_FOLLOW = 64        # the user tokens a second turn appends
TIER_HOST = 4 << 30
TIER_HOST_SMALL = 1 << 30
TIER_NVME = 4 << 30
TIER_IDLE_S = 1.0       # run (f)'s demote_ahead_idle_s
TIER_PROBE_FILES = 64   # the aio probe's files, one pool page each


def _tier_sessions(vocab: int, n: int, prompt: int, follow: int,
                   seed: int = 23) -> list:
    """(first prompt, second turn's user tokens) of ``n`` sessions."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, prompt).astype(np.int32),
             rng.integers(0, vocab, follow).astype(np.int32))
            for _ in range(n)]


def _tier_turns(srv, sessions, new: int, sync, idle_s=None) -> dict:
    """Both turns of every session: the first turns submitted at once and
    drained; with ``idle_s``, an idle gap past it and idle steps until
    demote-ahead stages nothing more; then every second turn (the first
    prompt, its output and the user's tokens) submitted at once and
    drained, its TTFT from the stats reset just before."""
    import numpy as np

    srv.stats.reset()
    rids = [srv.submit(p, new, seed=i) for i, (p, _) in enumerate(sessions)]
    t0 = time.perf_counter()
    done = srv.drain()
    sync()
    first_s = time.perf_counter() - t0
    srv.end_drain()
    first = [done[r] for r in rids]
    gap_steps = 0
    if idle_s is not None:
        time.sleep(idle_s + 0.5)
        staged = srv.stats.registry.counter("Serve/demote_ahead_staged")
        last = -1
        while staged.value != last and gap_steps < 32:
            last = staged.value
            srv.step()
            gap_steps += 1
    prompts = [np.concatenate([p, np.asarray(r.tokens, np.int32), f])
               for (p, f), r in zip(sessions, first)]
    counted = srv.stats.registry.snapshot()["counters"]
    srv.stats.reset()
    rids = [srv.submit(p, new, seed=100 + i) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    done = srv.drain()
    sync()
    second_s = time.perf_counter() - t0
    srv.end_drain()
    for k, v in srv.stats.registry.snapshot()["counters"].items():
        counted[k] = counted.get(k, 0) + v
    return {"first": first, "second": [done[r] for r in rids],
            "prompts": [p for p, _ in sessions] + prompts,
            "snap": srv.stats.snapshot(), "counters": counted,
            "first_s": first_s,
            "second_s": second_s, "gap_steps": gap_steps}


def _tier_forced_gap(engine, cfg, prompts, tokens, dev) -> tuple:
    """Phase 11's teacher-forced gate: each prompt and its served tokens
    through one dense forward; the worst served token's gap to its row's
    maximum (a share of max |logit|) and the argmax share."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.decode import (forward_with_cache,
                                                      init_cache)

    worst, exact, total = 0.0, 0, 0
    with torch.inference_mode():
        for p, toks in zip(prompts, tokens):
            ids = torch.as_tensor(np.concatenate([p, toks[:-1]]),
                                  dtype=torch.long, device=dev)[None]
            lg, _ = forward_with_cache(
                engine.model, engine.params, ids,
                init_cache(cfg, 1, ids.shape[1], cfg.dtype, device=dev),
                materialize=engine.materialize)
            rows = lg[0, len(p) - 1:]
            served = torch.as_tensor(toks, device=dev)
            gap = (rows.max(dim=-1).values
                   - rows.gather(1, served[:, None])[:, 0]) \
                / rows.abs().max(dim=-1).values
            worst = max(worst, gap.max().item())
            exact += int((rows.argmax(dim=-1) == served).sum())
            total += len(toks)
    return worst, exact / total


def _tier_block_probe(srv, prompt, dev) -> dict:
    """Clone, at its eviction, each pool page of ``prompt``'s blocks that
    a demotion gathers; at a restore of those blocks, hold the prefill
    cache's pages to the clones, bit for bit. Returns the tally the
    wrappers fill."""
    import torch

    from deepspeed_tpu_torch.serving.pages import _page_split

    ps = srv.cfg.page_size
    want = tuple(int(t) for t in prompt)
    before, tally = {}, {"blocks": 0, "equal": 0}
    demote, restore, pop = (srv._demote_pages, srv._restore_dispatch,
                            srv.sched.pop_next)
    seated = {}

    def on_demote(entries):
        c = srv.state.cache
        for e in entries:
            if tuple(e["tokens"]) == want[:len(e["tokens"])]:
                before[len(e["tokens"])] = (c.k[:, e["page"]].clone(),
                                            c.v[:, e["page"]].clone())
        demote(entries)

    def on_restore(cache, alloc):
        restore(cache, alloc)
        p = seated.get("prompt")
        n = cache.k.shape[3] // ps
        for b in range(alloc.shared, alloc.shared + alloc.restored):
            end = (b + 1) * ps
            if end in before and tuple(int(t) for t in p[:end]) \
                    == want[:end]:
                k, v = before[end]
                tally["blocks"] += 1
                tally["equal"] += int(
                    torch.equal(_page_split(cache.k, n, ps)[:, b], k)
                    and torch.equal(_page_split(cache.v, n, ps)[:, b], v))

    def pop_next():
        req = pop()
        if req is not None:
            seated["prompt"] = req.prompt
        return req

    srv.pool.on_demote = on_demote
    srv._restore_dispatch = on_restore
    srv.sched.pop_next = pop_next
    return tally


def _tier_host_probe(srv) -> tuple:
    """Sum the host seconds of the tier's pieces over a run: the CRCs
    (``tiles_crc``, a put's and a host match's, on the CRC threads, so
    thread-seconds), the admissions (``try_admit``: tree match, tier match
    with its CRCs, evictions and the demote dispatch), the demote dispatch
    alone, the drains, the restores' dispatch. Returns the dict the
    wrappers fill and a function that puts ``tiles_crc`` back."""
    from deepspeed_tpu_torch.serving import hostkv, tiering

    acc = {"crc_s": 0.0, "crc_bytes": 0, "admit_s": 0.0, "dispatch_s": 0.0,
           "drain_s": 0.0, "restore_s": 0.0}
    crc = tiering.tiles_crc

    def timed(key, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[key] += time.perf_counter() - t
        return run

    def counted_crc(tiles):
        acc["crc_bytes"] += sum(int(v.nbytes) for v in tiles.values())
        return crc(tiles)

    tiering.tiles_crc = hostkv.tiles_crc = timed("crc_s", counted_crc)
    srv.pool.try_admit = timed("admit_s", srv.pool.try_admit)
    srv._dispatch_demote_gather = timed("dispatch_s",
                                        srv._dispatch_demote_gather)
    srv._drain_demotes = timed("drain_s", srv._drain_demotes)
    srv._restore_dispatch = timed("restore_s", srv._restore_dispatch)

    def undo():
        tiering.tiles_crc = hostkv.tiles_crc = crc

    return acc, undo


def _aio_probe(path: str, nbytes: int, files: int) -> dict:
    """``files`` writes, then reads, of ``nbytes`` each through the disk
    rung's ``AIOFileStore`` (O_DIRECT asked for, pinned buffers), timed;
    the reads checked against the writes."""
    import torch

    from deepspeed_tpu_torch.ops.aio import AIOFileStore

    store = AIOFileStore(path, n_threads=4, use_direct=True)
    pin = torch.cuda.is_available()
    src = [torch.full((nbytes,), i % 251, dtype=torch.uint8,
                      pin_memory=pin).numpy() for i in range(files)]
    t0 = time.perf_counter()
    store.wait([store.submit_write(f"w{i}.bin", b)
                for i, b in enumerate(src)][-1])
    write_s = time.perf_counter() - t0
    dst = [torch.zeros(nbytes, dtype=torch.uint8, pin_memory=pin).numpy()
           for _ in range(files)]
    t0 = time.perf_counter()
    store.wait([store.submit_read(f"w{i}.bin", b)
                for i, b in enumerate(dst)][-1])
    read_s = time.perf_counter() - t0
    same = all((a == b).all() for a, b in zip(src, dst))
    for i in range(files):
        store.unlink(f"w{i}.bin")
    out = {"bytes": nbytes * files, "write_gb_s": nbytes * files / write_s
           / 1e9, "read_gb_s": nbytes * files / read_s / 1e9,
           "o_direct": store.aio.o_direct(), "errors": store.errors}
    store.close()
    if not same or out["errors"]:
        raise AssertionError(f"[tier] the aio probe read back other bytes "
                             f"or failed: {out}")
    return out


def _tier_run(engine, cfg, name, serving, sessions, new, device, *,
              idle_s=None, probe=False) -> dict:
    """One run of phase 18: a fresh ServingEngine, a warm-up request (the
    slot graph's capture), both turns; the kernel counts zeroed before the
    warm-up and read after the second turns. Gates: every request OK with
    its tokens, one capture, no page leaked, the tiers' bytes the sum of
    their entries, nothing pinned; with ``probe`` the restored blocks of
    session 0 bit-identical to their pages before the eviction."""
    import numpy as np
    import torch

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import woq_matmul as wm
    from deepspeed_tpu_torch.resilience.guards import RequestStatus

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tag = f"[tier {name}]"
    t_run = time.perf_counter()
    _free_memory(dev)
    srv = dt.ServingEngine(engine, serving)
    tally = _tier_block_probe(srv, sessions[0][0], dev) if probe else None
    host_s, undo = _tier_host_probe(srv) if srv.hostkv is not None \
        else (None, None)
    counters = (da.decode_attention, wm.woq_matmul)
    for c in counters:
        c.launches = 0
    srv.serve_batch([_serve_stream(cfg.vocab_size, 1, seed=99)[0][0][:32]],
                    4)
    turns = _tier_turns(srv, sessions, new, sync, idle_s=idle_s)
    counted = {c.__name__: c.launches for c in counters}
    if undo is not None:
        undo()
    replays = srv.graph.replays if srv.graph else 0
    captured = dict(srv.graph.captured_launches) if srv.graph else {}
    launches = {k: v - captured.get(k, 0) + captured.get(k, 0) * replays
                for k, v in counted.items()}
    bad = [(i, r.status.value, len(r.tokens)) for i, r in enumerate(
        turns["first"] + turns["second"])
        if r.status is not RequestStatus.OK or len(r.tokens) != new]
    if bad:
        raise AssertionError(f"{tag} requests not served in full: {bad}")
    if srv.captures != (1 if cuda else 0):
        raise AssertionError(f"{tag} captures {srv.captures}, want 1")
    per_step = cfg.n_layer if engine.flash_decode else 0
    if cuda and (counted["decode_attention"] != 2 * per_step
                 or captured.get("decode_attention", 0) != per_step
                 or not launches["decode_attention"]):
        raise AssertionError(f"{tag} decode attention counted "
                             f"{counted}, captured {captured}")
    pool = srv.pool
    leak = {"live": len(pool._alloc), "free": len(pool.free),
            "tree_held": pool.tree_held, "usable": pool.usable}
    if leak["live"] or leak["free"] + leak["tree_held"] != leak["usable"]:
        raise AssertionError(f"{tag} pages leaked: {leak}")
    stores = [st for st in (srv.hostkv, srv.nvmekv) if st is not None]
    for st in stores:
        if st.bytes_used != sum(e["nbytes"] for e in st.entries.values()) \
                or any(e["pinned"] for e in st.entries.values()) \
                or st.bytes_used > st.capacity_bytes:
            raise AssertionError(f"{tag} {st.kind}: bytes {st.bytes_used} "
                                 "against its entries, pins or budget")
    tiers = srv.tier_snapshot()
    ps = pool.snapshot()
    reg = turns["counters"]
    snap = turns["snap"]
    toks = [list(r.tokens) for r in turns["first"] + turns["second"]]
    out = {"name": name, "serving": serving, "captures": srv.captures,
           "counted": counted, "captured": captured, "replays": replays,
           "launches": launches,
           "ttft_ms": {k: snap["ttft_s"][k] * 1e3 for k in ("p50", "p99")},
           "second_tok_s": len(sessions) * new / turns["second_s"],
           "first_s": turns["first_s"], "second_s": turns["second_s"],
           "gap_steps": turns["gap_steps"],
           "prefill_tokens_saved": ps["prefill_tokens_saved"],
           "prompt_tokens": ps["prompt_tokens"],
           "evictions": ps["evictions"], "defers": ps["defers"],
           "tokens": toks, "prompts": turns["prompts"]}
    if tiers is not None:
        out["tiers"] = {k: v for k, v in tiers.items()
                        if not isinstance(v, dict) or k in ("io",
                                                            "nvme_tier")}
        out["staged"] = reg.get("Serve/demote_ahead_staged", 0)
        out["fastfrees"] = reg.get("Serve/demote_ahead_fastfrees", 0)
    if host_s is not None:
        out["host_s"] = host_s
    if tally is not None:
        out["block_probe"] = tally
        if not tally["blocks"] or tally["equal"] != tally["blocks"]:
            raise AssertionError(f"{tag} restored blocks against their "
                                 f"pages before the eviction: {tally}")
    srv.close()
    if serving.get("nvme_path"):
        out["aio_probe"] = _aio_probe(
            serving["nvme_path"], srv.state.cache.k[:, 0].nbytes * 2,
            TIER_PROBE_FILES if cuda else 4)
    del srv
    _free_memory(dev)
    out["run_s"] = time.perf_counter() - t_run
    log(f"{tag} TTFT of the second turns p50 {out['ttft_ms']['p50']:.1f} "
        f"ms p99 {out['ttft_ms']['p99']:.1f} ms; second turns "
        f"{out['second_tok_s']:.1f} tok/s; prefill tokens saved "
        f"{out['prefill_tokens_saved']} of {out['prompt_tokens']}; "
        f"evictions {out['evictions']}, defers {out['defers']}; launches "
        f"{launches}; tiers "
        + json.dumps({k: out.get("tiers", {}).get(k) for k in (
            "restores", "restored_pages", "hits", "misses", "prunes",
            "spills", "fallbacks", "demote_wait_s", "io")})
        + f"; {out['run_s']:.1f} s")
    return out


def phase_tier(cfg=None, *, device=None, sessions=TIER_SESSIONS,
               prompt=TIER_PROMPT, new=TIER_NEW, follow=TIER_FOLLOW,
               serving=TIER_PAGED, host=TIER_HOST, host_small=TIER_HOST_SMALL,
               nvme=TIER_NVME, idle_s=TIER_IDLE_S, nvme_root=None) -> dict:
    """Phase 18: the KV tiers under the paged ``ServingEngine`` on
    Llama-2-7B bf16 at full width and depth (8 slots of 1024, pages of 16,
    257 pages, chunks of 256, greedy), 10 two-turn sessions (a 512-token
    prompt and 64 new tokens, then that conversation and 64 more user
    tokens, submitted after every first turn finished), each run a fresh
    engine over one InferenceEngine: (e) 1025 pages, nothing evicted,
    every resume a tree hit; (b) a 4 GiB host tier; (c) a 1 GiB host tier
    over a 4 GiB disk rung under ``nvme_root``; (f) (b) with demote-ahead
    and an idle gap before the second turns; (a) no tier; (d) (b) with
    int8 KV. Gates: ``_tier_run``'s; restores > 0 and no fallback in (b),
    (c), (d), (f); (c) spills and restores blocks from the disk rung; (f)
    stages ahead and fast-frees; (b)'s restored blocks bit-identical to
    their pages before the eviction; the tokens of (b), (c) and (f) equal
    (e)'s; (a) and (d) within phase 11's teacher-forced tolerance. A
    ``[tier]`` JSON line."""
    import shutil
    import tempfile

    import torch

    from deepspeed_tpu_torch.models import llama2

    cfg = cfg or llama2("7b")
    dev = torch.device(device or "cuda")
    t0 = time.perf_counter()
    sess = _tier_sessions(cfg.vocab_size, sessions, prompt, follow)
    root = nvme_root or str(Path(__file__).resolve().parent / "chiprun_out"
                            / "phase18_nvme")
    os.makedirs(root, exist_ok=True)
    nvme_dir = tempfile.mkdtemp(prefix="tier_", dir=root)
    _free_memory(dev)
    engine = _serve_engine(cfg, None, device)
    # (e): four times the pages, so nothing is evicted
    big = {**serving, "pool_pages": 1 + 4 * (serving["pool_pages"] - 1)}
    runs = {"e": (big, {}),
            "b": ({**serving, "host_pool_bytes": host}, {"probe": True}),
            "c": ({**serving, "host_pool_bytes": host_small,
                   "nvme_pool_bytes": nvme, "nvme_path": nvme_dir}, {}),
            "f": ({**serving, "host_pool_bytes": host,
                   "demote_ahead_idle_s": idle_s}, {"idle_s": idle_s}),
            "a": (serving, {}),
            "d": ({**serving, "host_pool_bytes": host, "kv_quant_bits": 8},
                  {})}
    out = {}
    for name, (scfg, kw) in runs.items():
        out[name] = _tier_run(engine, cfg, name, scfg, sess, new, device,
                              **kw)
    for name in ("b", "c", "d", "f"):
        t = out[name]["tiers"]
        if not (t["restores"] > 0 and t["fallbacks"] == 0
                and t.get("nvme_tier", {}).get("fallbacks", 0) == 0):
            raise AssertionError(f"[tier {name}] restores {t['restores']}, "
                                 f"fallbacks {t['fallbacks']}")
    nv = out["c"]["tiers"]
    if not (nv["spills"] > 0 and nv["nvme_tier"]["hits"] > 0):
        raise AssertionError(f"[tier c] spills {nv['spills']}, blocks "
                             f"from the disk rung {nv['nvme_tier']['hits']}")
    if not (out["f"]["staged"] > 0 and out["f"]["fastfrees"] > 0):
        raise AssertionError(f"[tier f] staged {out['f']['staged']}, "
                             f"fast-frees {out['f']['fastfrees']}")
    if out["e"]["evictions"]:
        raise AssertionError(f"[tier e] evicted {out['e']['evictions']}")
    for name in ("b", "c", "f"):
        apart = [i for i, (g, w) in enumerate(zip(out[name]["tokens"],
                                                  out["e"]["tokens"]))
                 if g != w]
        out[name]["apart_from_e"] = apart
        if apart:
            raise AssertionError(f"[tier {name}] requests {apart} served "
                                 "other tokens than (e)'s tree hits")
    for name in ("a", "d"):
        r = out[name]
        gap, share = _tier_forced_gap(engine, cfg, r["prompts"],
                                      r["tokens"], dev)
        r["teacher_forced_gap"], r["argmax_share"] = gap, share
        log(f"[tier {name}] teacher-forced: worst served-token gap {gap:.4f}"
            f" of max |logit| (tol {LOGIT_TOL_SHARE}), argmax share "
            f"{share:.4f}")
        if not gap <= LOGIT_TOL_SHARE:
            raise AssertionError(f"[tier {name}] a served token's logit is "
                                 f"{gap:.4f} of max |logit| below its row's")
    del engine
    _free_memory(dev)
    shutil.rmtree(nvme_dir, ignore_errors=True)
    for r in out.values():
        del r["tokens"], r["prompts"]
    out["phase_s"] = time.perf_counter() - t0
    if dev.type == "cuda":
        from deepspeed_tpu_torch.platform.device import device_report

        out["card"] = device_report()["nvidia_smi"]
    log("[tier] " + json.dumps(out, default=_jsonable))
    return out


CHILD_TIMEOUT_S = 900


def _child_phases() -> dict:
    from deepspeed_tpu_torch.models import llama2

    return {"moe": phase_moe,
            "serve": lambda: phase_serve_all(llama2("7b")),
            "tp": phase_tp, "ckpt": phase_checkpoint, "zero": phase_zero,
            "tp_train": phase_tp_train, "spec": phase_spec,
            "tier": phase_tier}


def _jsonable(o):
    """What ``json`` cannot write: arrays and tensors as lists, the rest
    by ``repr``."""
    if hasattr(o, "tolist"):
        return o.tolist()
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    return repr(o)


def run_child(name: str) -> dict:
    """Phase ``name`` in a fresh process of this script; its result, read
    back from the JSON file the child writes. A child that exits non-zero,
    dies or writes no result fails the run."""
    import subprocess

    import torch

    torch.cuda.empty_cache()
    out = Path(__file__).resolve().parent / "chiprun_out" / "phases"
    out.mkdir(parents=True, exist_ok=True)
    res = out / f"{name}.json"
    res.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--phase", name, "--result", str(res)],
                          timeout=CHILD_TIMEOUT_S)
    if proc.returncode != 0 or not res.exists():
        raise AssertionError(f"phase {name} in its own process exited "
                             f"{proc.returncode}"
                             + ("" if res.exists() else ", no result"))
    log(f"[child] phase {name}: {time.perf_counter() - t0:.1f} s in its own "
        "process")
    return json.loads(res.read_text())


def _ready() -> int:
    """0 where there is a card and the package beside this script, else 1
    (with the reason on standard error)."""
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
    return 0


def child_main(name: str, result: str) -> int:
    """``--phase name --result file``: one phase, its result as JSON."""
    if _ready():
        return 1
    t0 = time.perf_counter()
    out = _child_phases()[name]()
    Path(result).write_text(json.dumps(out, default=_jsonable))
    log(f"[child] phase {name}: {time.perf_counter() - t0:.1f} s from its "
        f"start to its result, {t0 - _IMPORTED:.1f} s of imports and checks "
        "before it")
    return 0


def main() -> int:
    if _ready():
        return 1
    import torch

    from deepspeed_tpu_torch.models import bert, gpt2, llama2, opt
    from deepspeed_tpu_torch.ops.flash_attention import library
    from deepspeed_tpu_torch.ops.sparse_attention import \
        library as sparse_library

    t0 = time.perf_counter()
    laps: dict = {}

    def lap(label, fn, /, *args, **kw):
        """``fn(*args, **kw)``, its seconds kept under ``label``."""
        t = time.perf_counter()
        out = fn(*args, **kw)
        laps[label] = round(time.perf_counter() - t, 1)
        return out

    dev = lap("1 device", phase_device)
    # phase 14 second (its own process, as every profiled phase): after
    # phases 2-13 had run in one process, its long profiled window lost one
    # kernel record in two runs of two (ROADMAP.md §3)
    moe = lap("14 moe", run_child, "moe")
    kern = lap("2 decode attention", phase_kernels)
    woq = lap("2 woq", phase_woq_kernels)
    tpk = lap("2 tp kernels", phase_tp_kernels)
    flash = lap("5 flash", phase_flash_kernels)
    xent = lap("5b xent", phase_xent_kernels)
    sparse = lap("5c sparse", phase_sparse_kernels)
    bias = lap("5d flash bias", phase_flash_bias_kernels)
    sl = lap("3 slice", phase_slice)
    woq8 = lap("4 int8", phase_woq, llama2("7b"), bits=8)
    woq4 = lap("4 int4", phase_woq, opt("6.7b"), bits=4)
    # phase 6, the unfused reference: fewer steps than the default-config
    # phase, the same depth, so step time and peak memory compare
    unfused = lap("6 train unfused", phase_train, warmup=2, steps=4,
                  name="train unfused")
    train = lap("7 train default", phase_train, gpt2("1.5b"), check="head",
                name="train default")
    mlm = lap(
        "8 train bert", phase_train,
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
    long = lap("9 long train", phase_long_train)
    evo = lap("10 evoformer", phase_evoformer)
    serve, serve8, paged = lap("11 serve", run_child, "serve")
    # phase 15 right after phase 11, each in its own process: windows
    # counted by kernel name late in one process lost a record now and
    # then (ROADMAP.md §3); phase 17 (speculation) after them
    tp = lap("15 tp", run_child, "tp")
    spec = lap("17 spec", run_child, "spec")
    lap("18 tier", run_child, "tier")
    # phase 12 in its own process too: its pinned host buffers (18.7 GB)
    # stay cached in the process that allocated them, and phase 16 holds
    # a 2-layer Mixtral's state (38 GB) on the host beside them
    lap("12 ckpt", run_child, "ckpt")
    lap("13 zero", run_child, "zero")
    tpt = lap("16 tp train", run_child, "tp_train")
    log(f"[done] all phases in {time.perf_counter() - t0:.1f} s; by phase "
        f"{json.dumps(laps)}")
    tp_shapes = tpt["kernels"]["shards"]
    tp_flash = tpt["kernels"]["flash"]
    tp_launches = {k: tpt[k]["launches_per_step"] for k in ("opt",
                                                            "mixtral")}
    tp_runs = ("15a", "15a paged", "15b")
    src = "deepspeed_tpu_torch/ops/csrc/"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = [
        {"name": "decode_attention", "route": "cuda",
         "source": src + "decode_attention.cu",
         "replaces": "deepspeed_tpu/ops/decode_attention.py:41",
         "launches": sl["launches"],
         "serving_launches": serve["launches"]["decode_attention"],
         "paged_serving_launches": {
             k: r["launches"]["decode_attention"] for k, r in paged.items()},
         "mixtral_serving_launches": moe["serve"]["launches"][
             "decode_attention"],
         "tp_launches": {k: tp[k]["launches"]["decode_attention"]
                         for k in tp_runs},
         "tp_rank_shapes": _rank_rows(tpk["decode_attention"]),
         **{k: kern[k] for k in keys}},
        # launches: the Llama-2-7B int8 path (untied head)
        # woq_route: the kernel of woq_matmul's fixed route the main path
        # runs (every decode projection, phase 4's gate)
        {"name": "woq_matmul", "route": "cuda", "source": src + "woq_matmul.cu",
         "replaces": "deepspeed_tpu/ops/woq_matmul.py:62",
         "launches": woq8["launches"]["woq_matmul"],
         "serving_launches": serve8["launches"]["woq_matmul"],
         "paged_serving_launches": {
             k: r["launches"]["woq_matmul"] for k, r in paged.items()
             if r["launches"]["woq_matmul"]},
         "mixtral_serving_launches": moe["serve"]["launches"]["woq_matmul"],
         "tp_launches": {k: tp[k]["launches"]["woq_matmul"]
                         for k in tp_runs},
         "tp_rank_shapes": _rank_rows(tpk["woq_matmul"]),
         "spec_serving_launches": {k: r["launches"]["woq_matmul"]
                                   for k, r in spec.items()},
         "verify_layer_int8": {k: woq["woq_matmul"]["verify"][
             "layer int8"][k] for k in WOQ_KEYS[:4]},
         "woq_route": woq["woq_matmul"]["route"],
         **{k: woq["woq_matmul"][k] for k in keys}},
        # launches: the OPT-6.7B int4 path (tied head)
        {"name": "woq_matmul_t", "route": "cuda",
         "source": src + "woq_matmul.cu",
         "replaces": "deepspeed_tpu/ops/woq_matmul.py:130",
         "launches": woq4["launches"]["woq_matmul_t"],
         "tp_rank_shapes": _rank_rows(tpk["woq_matmul_t"]),
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
            tp_rows = {} if at != line else {
                "tp_train_rank_shapes": {
                    c: {"us": t[name]["ms"] * 1e3,
                        "bound_us": t[name]["bound_ms"] * 1e3,
                        "library_us": t[name]["library_ms"] * 1e3}
                    for c, t in tp_flash.items()},
                "tp_train_launches": {m: n[name]
                                      for m, n in tp_launches.items()}}
            kernels.append({"name": name, "route": "cuda",
                            "source": src + library(name, torch.bfloat16,
                                                    64) + ".cu",
                            "replaces": "deepspeed_tpu/ops/flash_attention"
                                        f".py:{at}",
                            "launches": train["launches"][name],
                            "mixtral_train_launches":
                                moe["train"]["launches"][name],
                            **tp_rows, **{k: times[k] for k in keys}})
    # launches: the same run (GPT-2 1.5B under its default config)
    # the backward's one call (xent_bwd) computes kernels #11 and #12: both
    # rows carry its launches and its times
    for name, line, source, wrapper in (
            ("xent_fwd", 49, "xent.cu", "xent_fwd"),
            ("xent_dx", 110, "xent_bwd_sm90.cu", "xent_bwd"),
            ("xent_dw", 128, "xent_bwd_sm90.cu", "xent_bwd")):
        kernels.append({"name": name, "route": "cuda", "source": src + source,
                        "replaces": f"deepspeed_tpu/ops/xent.py:{line}",
                        "launches": train["launches"][wrapper],
                        **({"call": "xent_bwd"} if wrapper == "xent_bwd"
                           else {}),
                        "tp_train_rank_shapes": {
                            k: {"us": r[wrapper]["ms"] * 1e3,
                                "bound_us": r[wrapper]["bound_ms"] * 1e3,
                                "bound_by": r[wrapper]["bound_by"]}
                            for k, r in tp_shapes.items()},
                        "tp_train_launches": {m: n[wrapper] for m, n
                                              in tp_launches.items()},
                        **{k: xent[name][k] for k in keys}})
    # launches: phase 9 (GPT-2 1.5B at 8192 tokens, the Fixed layout:
    # block 64, hd 64, whose forward runs on the wgmma library)
    for name, line in (("sparse_fwd", 184), ("sparse_bwd_dq", 223),
                       ("sparse_bwd_dkv", 252)):
        kernels.append({"name": name, "route": "cuda",
                        "source": src + sparse_library(name, 64, 64) + ".cu",
                        "replaces": f"deepspeed_tpu/ops/sparse_attention.py:"
                                    f"{line}",
                        "launches": long["launches"][name],
                        **{k: sparse[name][k] for k in keys}})
    # the fp32 forward's and backward pair's 3xTF32 wgmma kernels: timed at
    # the DS4Science example's shape, launches from its 50 fp32 steps
    # (phase 10a)
    fp32_launches = evo["example"]["torch.float32"]["launches"]
    for name, line in (("flash_fwd", 43), ("flash_bwd_dq", 228),
                       ("flash_bwd_dkv", 285)):
        times = bias["biased"]["evoformer_example"][name]
        kernels.append({"name": f"{name}_f32", "route": "cuda",
                        "source": src + library(name, torch.float32, 32)
                        + ".cu",
                        "replaces": f"deepspeed_tpu/ops/flash_attention.py:"
                                    f"{line}",
                        "launches": fp32_launches[name],
                        "max_abs_err": bias["max_abs_err"]["fp32_wgmma"][name],
                        **{k: times[k] for k in keys if k != "max_abs_err"}})
    log("[flash-bias] " + json.dumps({"kernels": flash_bias_rows(bias,
                                                                 evo)}))
    shapes = flash["shapes"]
    sass = dev["flash_sass"]
    fwd_libs = ("flash_fwd_sm90", "flash_fwd_f32_sm90")
    log("[flash-fwd] " + json.dumps({
        "shapes": {c: t["flash_fwd"] for c, t in shapes.items()},
        "host": flash["host"], "sass": {k: sass[k] for k in fwd_libs}}))
    log("[flash-bwd] " + json.dumps({
        "shapes": {c: {n: t[n] for n in ("flash_bwd_dq", "flash_bwd_dkv")}
                   for c, t in shapes.items()},
        "sass": {k: v for k, v in sass.items()
                 if k.startswith("flash_bwd")}}))
    log("[xent-bwd] " + json.dumps({"sass": dev["xent_sass"]}))
    print(json.dumps({"kernels": kernels}))
    print(dev["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if "--phase" in sys.argv:
        args = sys.argv[1:]
        rc = child_main(args[args.index("--phase") + 1],
                        args[args.index("--result") + 1])
        # the result is on the disk and every phase frees its engines and
        # process group itself: skip the interpreter's teardown of the
        # caches (tens of GB of device and pinned host memory)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    sys.exit(main())
