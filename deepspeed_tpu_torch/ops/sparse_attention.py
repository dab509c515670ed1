"""Block-sparse attention: sparsity configs, layout lists and kernels.

Counterpart of ``deepspeed_tpu/ops/sparse_attention.py``. Attention cost
drops from O(S²) to O(S·w) by computing only the (q-block, k-block) pairs a
block *layout* keeps. The configs (Dense, Fixed, Variable, BigBird,
BSLongformer) and ``_layout_lists`` are copies of the JAX package's, so
layouts and CSR lists agree bit for bit (BigBird draws its random blocks
from ``np.random.default_rng(seed)`` as JAX does).

The Pallas kernels ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``
become CUDA kernels for Hopper, built by ``ops/builder.py`` and called
through ctypes: at blocks 64 and 128, hd 32-128 the forward is
``csrc/sparse_fwd_sm90.cu`` and the backward pair
``csrc/sparse_bwd_dq_sm90.cu`` / ``csrc/sparse_bwd_dkv_sm90.cu`` (kernels in
``csrc/sparse_bwd_sm90.cuh``): wgmma, TMA producer warps walking the lists,
persistent blocks widest list first; blocks 16 and 32 and hd 16 take the
mma.sync kernels of ``csrc/sparse_attention.cu`` (each source's header
says what bounds its kernels and how they walk the lists). :func:`library`
routes every launch by a fixed table; :func:`sparse_units` mirrors the
wgmma kernels' schedule. The
wrappers
:func:`sparse_fwd`, :func:`sparse_bwd_dq` and :func:`sparse_bwd_dkv` launch
their kernel for CUDA tensors and take the plain PyTorch versions beside
them for CPU tensors only; on a CUDA tensor they launch or raise. Each
counts its launches in ``.launches``. The plain versions are the flash
plain versions (``ops/flash_attention.py``) with the layout expanded to an
(S, S) keep-mask.

On the card the kernels take bf16 and fp16 (fp32 accumulation), head dims
16, 32, 64 and 128 and blocks 16, 32, 64 and 128; fp32, other head dims
and other blocks raise there. The CPU path takes any of them. The JAX
package sends fp16 on its TPU down a dense path (Mosaic has no f16); here
fp16 goes through the kernels, as it does for flash attention.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from . import builder
from .registry import counted
from .flash_attention import (HALF_DTYPE_CODE, _check, _raise_on,
                              attention_delta, flash_attention_fwd_plain,
                              flash_bwd_dkv_plain, flash_bwd_dq_plain)

KERNEL_BLOCKS = (16, 32, 64, 128)


# ------------------------------------------------------------------ configs
@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Base: dense layout (reference ``DenseSparsityConfig``)."""

    block: int = 64

    def make_layout(self, n_blocks: int) -> np.ndarray:
        return np.ones((n_blocks, n_blocks), bool)


@dataclasses.dataclass(frozen=True)
class FixedSparsityConfig(SparsityConfig):
    """Local windows + periodic global blocks (reference
    ``FixedSparsityConfig``): each block attends its window of
    ``num_local_blocks``; the last ``num_global_blocks`` of each window are
    global (attended by and attending everyone)."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, n: int) -> np.ndarray:
        lay = np.zeros((n, n), bool)
        w = self.num_local_blocks
        for i in range(n):
            start = (i // w) * w
            lay[i, start:min(start + w, n)] = True
        for wstart in range(0, n, w):
            gstart = min(wstart + w, n) - self.num_global_blocks
            g = slice(max(wstart, gstart), min(wstart + w, n))
            lay[:, g] = True
            lay[g, :] = True
        return lay


@dataclasses.dataclass(frozen=True)
class VariableSparsityConfig(SparsityConfig):
    """Custom local window sizes + explicit global block indices
    (reference ``VariableSparsityConfig``)."""

    local_window_blocks: Sequence[int] = (4,)
    global_block_indices: Sequence[int] = (0,)

    def make_layout(self, n: int) -> np.ndarray:
        lay = np.zeros((n, n), bool)
        start = 0
        windows = list(self.local_window_blocks)
        wi = 0
        while start < n:
            w = windows[min(wi, len(windows) - 1)]
            end = min(start + w, n)
            lay[start:end, start:end] = True
            start = end
            wi += 1
        for g in self.global_block_indices:
            if g < n:
                lay[:, g] = True
                lay[g, :] = True
        return lay


@dataclasses.dataclass(frozen=True)
class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global (reference ``BigBirdSparsityConfig``)."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, n: int) -> np.ndarray:
        lay = np.zeros((n, n), bool)
        half = self.num_sliding_window_blocks // 2
        for i in range(n):
            lay[i, max(0, i - half):min(n, i + half + 1)] = True
        g = min(self.num_global_blocks, n)
        lay[:, :g] = True
        lay[:g, :] = True
        rng = np.random.default_rng(self.seed)
        for i in range(n):
            picks = rng.choice(n, size=min(self.num_random_blocks, n),
                               replace=False)
            lay[i, picks] = True
        return lay


@dataclasses.dataclass(frozen=True)
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + explicit global indices (reference
    ``BSLongformerSparsityConfig``)."""

    num_sliding_window_blocks: int = 3
    global_block_indices: Sequence[int] = (0,)

    def make_layout(self, n: int) -> np.ndarray:
        lay = np.zeros((n, n), bool)
        half = self.num_sliding_window_blocks // 2
        for i in range(n):
            lay[i, max(0, i - half):min(n, i + half + 1)] = True
        for g in self.global_block_indices:
            if g < n:
                lay[:, g] = True
                lay[g, :] = True
        return lay


# ----------------------------------------------------------- layout → lists
def _layout_lists(layout: np.ndarray, causal: bool):
    """Boolean layout → CSR-ish index lists for the kernels.

    Returns (k_idx (nq, A), k_n (nq,), q_idx (nk, B), q_n (nk,)) padded
    int32 arrays: active k-blocks per q-block and the transpose."""
    n = layout.shape[0]
    lay = layout.copy()
    if causal:
        lay &= np.tril(np.ones((n, n), bool))
    if not lay.any(axis=1).all():
        bad = np.where(~lay.any(axis=1))[0]
        raise ValueError(f"layout leaves q-blocks {bad.tolist()} with no "
                         "active k-blocks (causal masking removed them all?)")

    def lists(m):
        counts = m.sum(axis=1)
        width = int(counts.max())
        idx = np.zeros((m.shape[0], width), np.int32)
        for i in range(m.shape[0]):
            act = np.nonzero(m[i])[0]
            idx[i, :len(act)] = act
        return idx, counts.astype(np.int32)

    k_idx, k_n = lists(lay)
    q_idx, q_n = lists(lay.T)
    return k_idx, k_n, q_idx, q_n


@dataclasses.dataclass(frozen=True, eq=False)
class SparseLayout:
    """One (config, S, causal) layout on one device: the block layout
    (``blocks``, before the causal cut) for the plain versions, and the
    kernels' int32 lists. ``q_order`` / ``k_order`` are the q-blocks (k-blocks)
    in launch order, widest list first."""

    block: int
    causal: bool
    blocks: np.ndarray
    k_idx: torch.Tensor
    k_n: torch.Tensor
    q_idx: torch.Tensor
    q_n: torch.Tensor
    q_order: torch.Tensor
    k_order: torch.Tensor

    @property
    def seq(self) -> int:
        return self.blocks.shape[0] * self.block

    def keep(self, device) -> torch.Tensor:
        """(S, S) bool: the layout expanded to elements (causal not
        applied)."""
        blocks = torch.as_tensor(self.blocks, device=device)
        return blocks.repeat_interleave(self.block, 0) \
            .repeat_interleave(self.block, 1)

    def kept_elements(self) -> int:
        """(q, k) elements kept after the causal cut: b² per off-diagonal
        pair, b(b + 1)/2 per diagonal pair when causal."""
        b, lay = self.block, self.blocks
        if not self.causal:
            return int(lay.sum()) * b * b
        lay = lay & np.tril(np.ones(lay.shape, bool))
        diag = int(np.trace(lay))
        return (int(lay.sum()) - diag) * b * b + diag * b * (b + 1) // 2


_LAYOUTS: dict = {}


def sparse_layout(config: SparsityConfig, seq: int, causal: bool,
                  device) -> SparseLayout:
    """The layout of ``config`` at ``seq`` positions on ``device``, built and
    copied to the device once per (config, seq, causal, device) and cached:
    no call after the first copies lists from the host."""
    device = torch.device(device)
    key = (repr(config), seq, causal, str(device))
    lay = _LAYOUTS.get(key)
    if lay is None:
        block = config.block
        if seq % block != 0:
            raise ValueError(f"seq {seq} not divisible by sparsity block "
                             f"{block}")
        blocks = np.asarray(config.make_layout(seq // block), bool)
        lists = _layout_lists(blocks, causal)
        k_n, q_n = lists[1], lists[3]
        order = [np.argsort(-n, kind="stable").astype(np.int32)
                 for n in (k_n, q_n)]
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
             for a in (*lists, *order)]
        lay = _LAYOUTS[key] = SparseLayout(block, causal, blocks, *t)
    return lay


# ------------------------------------------------------------ plain versions
def _plain_kw(layout: SparseLayout, device) -> dict:
    return dict(causal=layout.causal, keep=layout.keep(device))


def sparse_attention_fwd_plain(q, k, v, layout: SparseLayout):
    """The forward kernel's function in plain tensor ops (the flash plain
    forward under the layout's keep-mask): o (B, S, H, hd) in q's dtype and
    the fp32 lse (B, H, S)."""
    return flash_attention_fwd_plain(q, k, v, **_plain_kw(layout, q.device))


def sparse_bwd_dq_plain(q, k, v, do, lse, delta, layout: SparseLayout):
    """dq (B, S, H, hd) under the layout's keep-mask."""
    return flash_bwd_dq_plain(q, k, v, do, lse, delta,
                              **_plain_kw(layout, q.device))


def sparse_bwd_dkv_plain(q, k, v, do, lse, delta, layout: SparseLayout):
    """(dk, dv) (B, S, KV, hd) under the layout's keep-mask, each KV head
    summed over its query heads."""
    return flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                               **_plain_kw(layout, q.device))


# ------------------------------------------------------------------ kernels
# the (block, hd) the wgmma kernels take, the forward
# (csrc/sparse_fwd_sm90.cu) and the backward pair (csrc/sparse_bwd_sm90.cuh)
WGMMA_FWD_BLOCKS = (64, 128)
WGMMA_FWD_HEAD_DIMS = (32, 64, 128)
SPARSE_KERNELS = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")


def library(kernel: str, block: int, hd: int) -> str:
    """The library whose kernel serves a launch of ``kernel``
    (``sparse_fwd``, ``sparse_bwd_dq`` or ``sparse_bwd_dkv``) at a layout
    block and head dim: the wgmma kernel ``csrc/<kernel>_sm90.cu`` at
    blocks 64 and 128, hd 32-128; the mma.sync kernels of
    ``csrc/sparse_attention.cu`` elsewhere. Fixed: a route never depends on
    a failure, and a failed wgmma launch raises."""
    if kernel not in SPARSE_KERNELS:
        raise ValueError(f"no sparse kernel {kernel!r}")
    if block in WGMMA_FWD_BLOCKS and hd in WGMMA_FWD_HEAD_DIMS:
        return f"{kernel}_sm90"
    return "sparse_attention"


def sparse_fwd_plan(hd: int) -> dict:
    """The tiles of the wgmma forward at head dim ``hd``, as
    ``csrc/sparse_fwd_sm90.cu`` builds them: ``pipes`` pipelines a block
    (a producer warp and a consumer warpgroup each), units of ``rows``
    query rows, tiles of ``keys`` keys (64-key chunks, two a tile but at hd
    128), ``stages`` K and V stages a pipeline, and the block's dynamic
    shared memory in ``smem_bytes``: per pipeline Q and the K and V rings
    (16-bit tiles) and its barriers (Q full and empty, four a stage), plus
    1024 bytes of alignment slack."""
    if hd not in WGMMA_FWD_HEAD_DIMS:
        raise ValueError(f"no wgmma sparse_fwd at hd {hd}")
    pipes, rows = 2, 64
    keys, stages = (64 if hd == 128 else 128), (4 if hd == 32 else 3)
    q_tile, tile = rows * hd * 2, keys * hd * 2
    smem = 1024 + pipes * (q_tile + 2 * stages * tile
                           + 8 * (2 + 4 * stages))
    return {"pipes": pipes, "rows": rows, "keys": keys, "stages": stages,
            "smem_bytes": smem}


def sparse_bwd_plan(kernel: str, hd: int) -> dict:
    """The tiles of the wgmma backward kernel ``kernel`` (``sparse_bwd_dq``
    or ``sparse_bwd_dkv``) at head dim ``hd``, as
    ``csrc/sparse_bwd_sm90.cuh`` builds them: ``pipes`` pipelines a block,
    units and streamed chunks of ``rows`` rows, ``stages`` stages a
    pipeline's ring, and the block's dynamic shared memory in
    ``smem_bytes``: per pipeline the unit's two 16-bit tiles (dq: Q and dO;
    dk/dv: K and V) and a ring of two tiles a stage (dq: K and V; dk/dv: Q
    and dO, with 512 bytes of lse and delta rows), and its barriers (dq:
    two, four a stage; dk/dv: two, two a stage), plus 1024 bytes of
    alignment slack."""
    if kernel not in ("sparse_bwd_dq", "sparse_bwd_dkv"):
        raise ValueError(f"no wgmma backward kernel {kernel!r}")
    if hd not in WGMMA_FWD_HEAD_DIMS:
        raise ValueError(f"no wgmma {kernel} at hd {hd}")
    pipes, rows = 2, 64
    tile = rows * hd * 2
    if kernel == "sparse_bwd_dq":
        stages = {32: 8, 64: 6, 128: 2}[hd]
        pipe = 2 * tile + 2 * stages * tile + 8 * (2 + 4 * stages)
    else:
        stages = {32: 8, 64: 5, 128: 2}[hd]
        pipe = 2 * tile + stages * (2 * tile + 512) + 8 * (2 + 2 * stages)
    return {"pipes": pipes, "rows": rows, "stages": stages,
            "smem_bytes": 1024 + pipes * pipe}


def sparse_units(layout: SparseLayout, B: int, heads: int, blocks: int,
                 kernel: str = "sparse_fwd") -> list:
    """The schedule of a wgmma sparse kernel, as ``csrc/sparse_fwd_sm90.cu``
    and ``csrc/sparse_bwd_sm90.cuh`` walk it over ``blocks`` persistent
    blocks of two pipelines: for each pipeline, its units in order, each a
    tuple (b, head, layout block, part) of 64 rows. The forward and dq
    walk query blocks over the query heads (``heads`` = H) in the layout's
    ``q_order``, dk/dv key blocks over the KV heads (``heads`` = KV) in its
    ``k_order``: widest list first. Units are numbered rank-major (the
    rank in that order), then part, b and head; pass k gives pipeline p
    unit k * P + p, or k * P + P - 1 - p on odd passes (P the
    pipelines)."""
    if kernel not in SPARSE_KERNELS:
        raise ValueError(f"no sparse kernel {kernel!r}")
    parts = layout.block // 64
    order = (layout.k_order if kernel == "sparse_bwd_dkv"
             else layout.q_order).tolist()
    nunits = len(order) * parts * B * heads
    npipes = 2 * blocks
    out = []
    for me in range(npipes):
        units, k = [], 0
        while True:
            u = k * npipes + (npipes - 1 - me if k & 1 else me)
            if u >= nunits:
                break
            hb, rest = u % (heads * B), u // (heads * B)
            units.append((hb // heads, hb % heads, order[rest // parts],
                          rest % parts))
            k += 1
        out.append(units)
    return out


def sparse_unit_chunks(layout: SparseLayout, kernel: str, block: int,
                       part: int) -> int:
    """The 64-row chunks of the other operand that a wgmma kernel's unit
    (part ``part`` of layout block ``block``) walks, one head's worth:
    every chunk of its list's entries, less the one that lies wholly on
    the hidden side of a causal diagonal 128-block (dq and the forward: the
    diagonal's upper key chunk for the first half; dk/dv: its first query
    chunk for the second half). dk/dv walks this for each query head of
    its group."""
    parts = layout.block // 64
    dkv = kernel == "sparse_bwd_dkv"
    idx, cnt = (layout.q_idx, layout.q_n) if dkv else (layout.k_idx,
                                                      layout.k_n)
    n = int(cnt[block])
    if n == 0:
        return 0
    diag = int(idx[block, 0 if dkv else n - 1]) == block
    skip = layout.causal and parts == 2 and diag and part == (1 if dkv
                                                              else 0)
    return n * parts - int(skip)


def _lib(name):
    """The loaded library ``csrc/<name>.cu``, its functions typed."""
    lib = builder.load(name)
    fns = [getattr(lib, f) for f in ("dstpu_sparse_fwd",
                                     "dstpu_sparse_bwd_dq",
                                     "dstpu_sparse_bwd_dkv")
           if hasattr(lib, f)]
    if fns[0].argtypes is None:
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # pointers and the stream as c_void_p: without argtypes ctypes
        # passes a Python int as a 32-bit C int and cuts the pointer
        pointers = {"dstpu_sparse_fwd": 8, "dstpu_sparse_bwd_dq": 10,
                    "dstpu_sparse_bwd_dkv": 11}
        for fn in fns:
            fn.argtypes = [P] * pointers[fn.__name__] + [I] * 9 + [F, P]
            fn.restype = I
    return lib


def _check_layout(name, q, layout: SparseLayout):
    """Raise on a layout the kernels do not take."""
    if layout.block not in KERNEL_BLOCKS:
        raise ValueError(f"{name}: sparsity block {layout.block} not in "
                         f"{KERNEL_BLOCKS}")
    if q.shape[1] != layout.seq:
        raise ValueError(f"{name}: q has {q.shape[1]} positions, the layout "
                         f"{layout.seq}")
    if layout.k_idx.device != q.device:
        raise ValueError(f"{name}: the layout's lists are on "
                         f"{layout.k_idx.device}, q on {q.device}")


def _launch_args(layout, q, k, lists_of):
    """The lists, shapes, dtype, scale and stream of a launch: the common
    tail of every sparse kernel's arguments."""
    B, S, H, hd = q.shape
    idx, cnt, order = lists_of
    return (idx.data_ptr(), cnt.data_ptr(), order.data_ptr(), idx.shape[1],
            B, S, H, k.shape[2], hd, layout.block, int(layout.causal),
            HALF_DTYPE_CODE[q.dtype], 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)


@counted
def sparse_fwd(q, k, v, layout: SparseLayout):
    """Forward: o (B, S, H, hd) and fp32 lse (B, H, S). q (B, S, H, hd),
    k/v (B, S, KV, hd) in the JAX layout."""
    if q.device.type == "cpu":
        return sparse_attention_fwd_plain(q, k, v, layout)
    B, S, H, _, _ = _check("sparse_fwd", q, k, v, codes=HALF_DTYPE_CODE)
    _check_layout("sparse_fwd", q, layout)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _lib(library("sparse_fwd", layout.block,
                       q.shape[3])).dstpu_sparse_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_launch_args(
            layout, q, k, (layout.k_idx, layout.k_n, layout.q_order)))
    _raise_on(err, "sparse_fwd")
    sparse_fwd.launches += 1
    return o, lse


@counted
def sparse_bwd_dq(q, k, v, do, lse, delta, layout: SparseLayout):
    """dq (B, S, H, hd) from dO, the forward's lse and delta (B, H, S)."""
    if q.device.type == "cpu":
        return sparse_bwd_dq_plain(q, k, v, do, lse, delta, layout)
    _check("sparse_bwd_dq", q, k, v, do, lse, delta,
           codes=HALF_DTYPE_CODE)
    _check_layout("sparse_bwd_dq", q, layout)
    dq = _bwd_dq_on(library("sparse_bwd_dq", layout.block, q.shape[3]),
                    q, k, v, do, lse, delta, layout)
    sparse_bwd_dq.launches += 1
    return dq


@counted
def sparse_bwd_dkv(q, k, v, do, lse, delta, layout: SparseLayout):
    """(dk, dv) (B, S, KV, hd), summed over each KV head's query heads."""
    if q.device.type == "cpu":
        return sparse_bwd_dkv_plain(q, k, v, do, lse, delta, layout)
    _check("sparse_bwd_dkv", q, k, v, do, lse, delta,
           codes=HALF_DTYPE_CODE)
    _check_layout("sparse_bwd_dkv", q, layout)
    dk, dv = _bwd_dkv_on(library("sparse_bwd_dkv", layout.block, q.shape[3]),
                         q, k, v, do, lse, delta, layout)
    sparse_bwd_dkv.launches += 1
    return dk, dv


def _bwd_dq_on(lib, q, k, v, do, lse, delta, layout):
    """dq from library ``lib``'s kernel on checked CUDA operands (the
    wrapper's route; chip_smoke.py and the card tests also name the
    mma.sync library here, to hold the two kernels against each other)."""
    dq = torch.empty_like(q)
    err = _lib(lib).dstpu_sparse_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_launch_args(
            layout, q, k, (layout.k_idx, layout.k_n, layout.q_order)))
    _raise_on(err, "sparse_bwd_dq")
    return dq


def _bwd_dkv_on(lib, q, k, v, do, lse, delta, layout):
    """(dk, dv) from library ``lib``'s kernel, as :func:`_bwd_dq_on`."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _lib(lib).dstpu_sparse_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_launch_args(layout, q, k,
                      (layout.q_idx, layout.q_n, layout.k_order)))
    _raise_on(err, "sparse_bwd_dkv")
    return dk, dv


# ------------------------------------------------------------ autograd
class _Sparse(torch.autograd.Function):
    """Forward saves (q, k, v, o, lse); backward computes delta = rowsum(dO·o)
    outside the kernels, then dq, then dk/dv (JAX ``_sparse_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, layout):
        o, lse = sparse_fwd(q, k, v, layout)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.layout = layout
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        dq = sparse_bwd_dq(q, k, v, do, lse, delta, ctx.layout)
        dk, dv = sparse_bwd_dkv(q, k, v, do, lse, delta, ctx.layout)
        return dq, dk, dv, None


def sparse_attention(q, k, v, config: SparsityConfig, *, causal: bool = True):
    """Block-sparse attention, differentiable. q: (B, S, H, hd); k/v: (B, S,
    KV, hd); returns (B, S, H, hd). GQA's query heads read KV head
    h // (H / KV) in the kernels, and dk/dv come out summed per group."""
    S = q.shape[1]
    if S % config.block != 0:
        raise ValueError(f"seq {S} not divisible by sparsity block "
                         f"{config.block}")
    layout = sparse_layout(config, S, causal, q.device)
    if q.device.type == "cuda":
        q, k, v = (t.contiguous() for t in (q, k, v))
    return _Sparse.apply(q, k, v, layout)


def make_sparse_attention_fn(config: SparsityConfig):
    """``attention_fn`` factory for :class:`TransformerLM` (mask unsupported:
    combine padding with the layout instead). It carries no capability
    flag, so the model refuses it for encoders and for ALiBi, as the JAX
    model does."""

    def attn(q, k, v, *, mask=None):
        if mask is not None:
            raise ValueError("sparse_attention does not take a padding mask; "
                             "fold padding into the sparsity layout")
        return sparse_attention(q, k, v, config)

    return attn
