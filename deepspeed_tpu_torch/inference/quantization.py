"""Weight-only int8/int4 quantization for inference (counterpart of
``deepspeed_tpu/inference/quantization.py``).

Weights are stored as int8 (or row-pair-packed int4) with fp32 group
scales and are consumed QUANTIZED by the decode step: through the CUDA
GEMMs of ``ops/woq_matmul.py`` when the model's ``woq_kernel`` is set, or
by a per-use dequantization at the point of consumption otherwise. Only
the prefill and the full ``forward`` read dense (dequantized) weights.

Layout, byte-compatible with the JAX package: groups of ``group_size``
rows along the weight's second-to-last dim (the contraction dim of an
``x @ W`` projection) share one scale row, so ``scale`` is ``(..., G, N)``
fp32. int4 packs two signed nibbles per byte along adjacent rows: row
``2r`` in the low nibble, ``2r + 1`` in the high.

Under tensor parallelism each rank holds its shard of every leaf
(``QuantizedTensor.rows`` / ``columns`` cut the bytes of the whole leaf's
quantization, so a rank's q and scales are JAX device r's) and the
consumption sites take the JAX package's rank-local branches:
:func:`row_partial` for a row-split (contraction-split) weight, an fp32
partial from the kernel that the caller all-reduces, or a per-use
dequantize where the shard's rows do not start and end on its groups;
:func:`woq_dot_t` on a vocabulary shard; :func:`tp_quant_dot` for the
quantized collective of ``tp_comm_quant``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.woq_matmul import unpack_int4 as _unpack_int4
from ..ops.woq_matmul import woq_matmul, woq_matmul_t

Params = dict


class QuantizedTensor:
    """int8 (or row-pair-packed int4) weight + per-channel group scales.

    ``q``: the weight's shape, or ``(..., K/2, N)`` packed for int4;
    ``scale``: ``(..., G, N)`` fp32 with ``G = K / group_size``. A row
    shard of a tensor-parallel rank (:meth:`rows`) whose rows do not start
    and end on its groups keeps the scale rows that cover them, and
    ``row0``, its first row's place in the first of them."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, group_size: int,
                 bits: int = 8, row0: int = 0):
        self.q = q
        self.scale = scale
        self.group_size = group_size
        self.bits = bits
        self.row0 = row0

    @property
    def aligned(self) -> bool:
        """Rows in whole groups from the first: the layout the kernels
        read (every leaf :func:`quantize` makes)."""
        return self.row0 == 0 and self.shape[-2] % self.group_size == 0

    @property
    def shape(self) -> tuple:
        """The logical (dequantized) shape."""
        if self.bits == 4:
            return (*self.q.shape[:-2], self.q.shape[-2] * 2, self.q.shape[-1])
        return tuple(self.q.shape)

    def __getitem__(self, i: int) -> "QuantizedTensor":
        """Layer ``i`` of a stacked ``(L, K, N)`` leaf (the per-layer loop's
        slice; groups never cross layers, so it is the layer's own
        quantization)."""
        if not isinstance(i, int) or self.q.ndim < 3:
            raise TypeError("QuantizedTensor indexes the leading layer dim "
                            "of a stacked leaf with an int")
        return QuantizedTensor(self.q[i], self.scale[i], self.group_size,
                               self.bits, self.row0)

    def columns(self, start: int, stop: int) -> "QuantizedTensor":
        """Output columns ``[start, stop)`` (contiguous copies): the scales
        are per column, so a fused ``[wq | wk | wv]`` splits into its
        parts' own bytes."""
        return QuantizedTensor(self.q[..., start:stop].contiguous(),
                               self.scale[..., start:stop].contiguous(),
                               self.group_size, self.bits, self.row0)

    def rows(self, start: int, stop: int) -> "QuantizedTensor":
        """Rows ``[start, stop)`` of the grouped (second-to-last) dim, the
        shard of a row-split leaf. int4 packs row pairs into a byte, so
        both ends must be even. A single-group leaf keeps its one scale row
        (the scale holds over every row) and the shard is its own group,
        as the JAX package's shard_map takes ``K // tp`` for it; a cut on
        group boundaries takes its groups' scale rows; any other cut keeps
        the scale rows that cover it and its offset in the first
        (``row0``), which only the per-use dequantize reads."""
        if self.row0 or not self.aligned:
            raise ValueError("QuantizedTensor.rows: cut a whole leaf")
        if self.bits == 4 and (start % 2 or stop % 2):
            raise ValueError(f"QuantizedTensor.rows: int4 packs row pairs; "
                             f"rows [{start}, {stop}) do not start and end "
                             "on a pair")
        p = 2 if self.bits == 4 else 1
        q = self.q[..., start // p:stop // p, :].contiguous()
        gs, G = self.group_size, self.scale.shape[-2]
        if G == 1:
            return QuantizedTensor(q, self.scale.clone(), stop - start,
                                   self.bits)
        g0, g1 = start // gs, -(-stop // gs)
        return QuantizedTensor(q, self.scale[..., g0:g1, :].contiguous(), gs,
                               self.bits, start % gs)

    def select(self, dim: int, start: int, stop: int) -> "QuantizedTensor":
        """Indices ``[start, stop)`` of a leading dim (the layer or the
        expert dim), whose scales are indexed alike."""
        if dim >= self.q.ndim - 2:
            raise ValueError("QuantizedTensor.select takes a leading dim")
        return QuantizedTensor(self.q.narrow(dim, start, stop - start)
                               .contiguous(),
                               self.scale.narrow(dim, start, stop - start)
                               .contiguous(), self.group_size, self.bits,
                               self.row0)

    @staticmethod
    def cat_columns(parts: list) -> "QuantizedTensor":
        """The inverse of :meth:`columns`: parts side by side along N."""
        gs, bits = parts[0].group_size, parts[0].bits
        if any((p.group_size, p.bits) != (gs, bits) for p in parts):
            raise ValueError("cat_columns: parts differ in group_size/bits")
        if any(p.row0 != parts[0].row0 for p in parts):
            raise ValueError("cat_columns: parts differ in row0")
        return QuantizedTensor(torch.cat([p.q for p in parts], dim=-1),
                               torch.cat([p.scale for p in parts], dim=-1),
                               gs, bits, parts[0].row0)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device),
                               self.group_size, self.bits, self.row0)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(shape={self.shape}, bits={self.bits}, "
                f"group_size={self.group_size}, row0={self.row0}, "
                f"device={self.q.device})")


_RECIPROCAL = {q: float(np.float32(1) / np.float32(q)) for q in (7.0, 127.0)}


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K, N) signed int4 values in int8 → (..., K/2, N): adjacent
    rows pack as (low nibble = even row, high nibble = odd row)."""
    lo = q[..., 0::2, :] & 0x0F
    hi = (q[..., 1::2, :] & 0x0F) << 4
    return lo | hi


def quantize(w: torch.Tensor, group_size: int = 128,
             bits: int = 8) -> QuantizedTensor:
    """Symmetric int8/int4 quantization in fp32 math, groups along the
    second-to-last dim, scales per channel along the last.

    A leaf whose second-to-last dim the group does not divide degrades to
    one whole group (OPT's 50272-row vocab table at group 128); a group
    that cannot pack row pairs (odd size) degrades int4 to int8. A stacked
    ``(L, K, N)`` leaf is quantized one layer at a time, which gives the
    same bytes with an fp32 transient of one layer only."""
    if bits not in (4, 8):
        raise ValueError(f"quantize: bits must be 4 or 8, got {bits}")
    K, N = w.shape[-2], w.shape[-1]
    gs = group_size if K % group_size == 0 else K
    if bits == 4 and gs % 2 != 0:
        bits = 8
    if w.ndim > 2:
        parts = [quantize(w[i], gs, bits) for i in range(w.shape[0])]
        return QuantizedTensor(torch.stack([p.q for p in parts]),
                               torch.stack([p.scale for p in parts]), gs, bits)
    G = K // gs
    wf = w.float().reshape(G, gs, N)
    qmax = 7.0 if bits == 4 else 127.0
    amax = wf.abs().amax(dim=-2, keepdim=True)               # (G, 1, N)
    # max(amax, 1e-8) / qmax as the JAX engine's compiled quantize computes
    # it: XLA folds the division by the constant into a product with
    # fp32(1 / qmax) (op-by-op JAX divides, an ulp apart on ~4% of scales)
    scale = amax.clamp_min(1e-8) * _RECIPROCAL[qmax]
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    q = q.reshape(K, N)
    if bits == 4:
        q = _pack_int4(q)
    return QuantizedTensor(q.contiguous(), scale[:, 0].contiguous(), gs, bits)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The dense weight in ``dtype``: each integer times its group's scale
    in fp32, rounded once to ``dtype`` (one ``torch.mul`` into a ``dtype``
    output: no fp32 copy of the integers is made first)."""
    qv = _unpack_int4(qt.q) if qt.bits == 4 else qt.q
    K, N = qv.shape[-2], qv.shape[-1]
    if not qt.aligned:
        # a row shard off its groups: each row's scale row, gathered
        g = (torch.arange(K, device=qv.device) + qt.row0) // qt.group_size
        out = torch.empty(qv.shape, dtype=dtype, device=qv.device)
        return torch.mul(qv, qt.scale.index_select(-2, g), out=out)
    G = K // qt.group_size
    grouped = qv.reshape(*qv.shape[:-2], G, qt.group_size, N)
    out = torch.empty(grouped.shape, dtype=dtype, device=qv.device)
    torch.mul(grouped, qt.scale[..., :, None, :], out=out)
    return out.reshape(qv.shape)


def dequant_rows(qt: QuantizedTensor, ids: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Gather + dequantize only the rows named by ``ids`` — the embedding
    lookup of a quantized table reads the batch's rows only. qt: 2-D
    (V, N)."""
    if qt.bits == 4:
        pr = qt.q[ids // 2]                                  # (..., N) packed
        lo = (pr << 4) >> 4
        hi = pr >> 4
        rows = torch.where((ids % 2 == 0)[..., None], lo, hi)
    else:
        rows = qt.q[ids]
    G = qt.scale.shape[-2]
    g = (ids + qt.row0) // qt.group_size if G > 1 else torch.zeros_like(ids)
    return (rows.float() * qt.scale[g]).to(dtype)


# ----------------------------------------------------------- consumption
def _dense_dot(x, w, out_dtype):
    """``x @ w`` with ``out_dtype`` results: in the operands' dtype, or,
    for a wider ``out_dtype``, both operands upcast first (exact: every
    bf16/fp16 product is an fp32 value, as with ``preferred_element_type``
    in the JAX package)."""
    if out_dtype == x.dtype:
        return x @ w
    return x.to(out_dtype) @ w.to(out_dtype)


def woq_dot(x, qt: QuantizedTensor, use_kernel: bool = False,
            out_dtype=None):
    """``x @ W`` for a quantized ``(K, N)`` weight (leading x dims free).

    ``use_kernel=True`` goes through :func:`ops.woq_matmul.woq_matmul`
    (the CUDA kernel for CUDA tensors, its plain version on the CPU), which
    takes every layout :func:`quantize` produces. Otherwise, and for a row
    shard off its groups (not :attr:`~QuantizedTensor.aligned`), the
    weight is dequantized to x's dtype at the point of use."""
    K = x.shape[-1]
    N = qt.shape[-1]
    out_dtype = out_dtype or x.dtype
    if not use_kernel or not qt.aligned:
        return _dense_dot(x, dequantize(qt, x.dtype), out_dtype)
    out = woq_matmul(x.reshape(-1, K).contiguous(), qt.q, qt.scale,
                     group_size=qt.group_size, bits=qt.bits,
                     out_dtype=out_dtype)
    return out.reshape(*x.shape[:-1], N)


def woq_dot_t(x, qt: QuantizedTensor, use_kernel: bool = False,
              out_dtype=None):
    """``x @ W.T`` for a quantized ``(V, K)`` weight — the tied-embedding
    unembedding, read in table layout. Returns (..., V) in ``out_dtype``
    (default x's; the decode head asks for fp32). On a vocabulary shard
    the rank's rows give its output columns; a single-group table's shard
    is one group of its own rows (:meth:`QuantizedTensor.rows`)."""
    K = x.shape[-1]
    V = qt.shape[-2]
    out_dtype = out_dtype or x.dtype
    if not use_kernel or not qt.aligned:
        return _dense_dot(x, dequantize(qt, x.dtype).T, out_dtype)
    out = woq_matmul_t(x.reshape(-1, K).contiguous(), qt.q, qt.scale,
                       group_size=qt.group_size, bits=qt.bits,
                       out_dtype=out_dtype)
    return out.reshape(*x.shape[:-1], V)


def matmul_any(x, w, use_kernel: bool = False):
    """``x @ w`` whether ``w`` is dense or a :class:`QuantizedTensor` —
    the one dispatch point every decode-path projection goes through."""
    if isinstance(w, QuantizedTensor):
        return woq_dot(x, w, use_kernel=use_kernel)
    return x @ w.to(x.dtype)


def row_partial(x, w, use_kernel: bool, tp: int):
    """This rank's partial of ``x @ W`` for a row-split (contraction-split)
    ``W`` (``wo``, ``w_out``), before the ``model`` all-reduce its caller
    issues: at ``tp`` > 1 a quantized ``W`` the kernel reads gives its fp32
    partial (the JAX package's shard_map: ``woq_matmul`` into fp32, an fp32
    psum, then the cast); everything else, ``tp`` 1 included, the product
    in x's dtype, as :func:`matmul_any` makes it."""
    if tp > 1 and use_kernel and isinstance(w, QuantizedTensor) \
            and w.aligned:
        return woq_dot(x, w, use_kernel=True, out_dtype=torch.float32)
    return matmul_any(x, w, use_kernel)


def tp_quant_dot(x, w, *, mesh, bits: int = 8):
    """``x @ w`` for a DENSE row-split weight with the ``model`` reduction
    spelled as the two-sided int8 all-reduce of ``comm/compressed.py``
    (``inference.tp_comm_quant``): the local partial in fp32 (both operands
    upcast: exact, as ``preferred_element_type``), ``int8_psum``, the cast
    back to x's dtype."""
    from ..comm.compressed import int8_psum

    if bits != 8:
        raise ValueError(f"tp_quant_dot supports int8 only, got {bits}")
    part = _dense_dot(x, w.to(x.dtype), torch.float32)
    return int8_psum(part, "model", mesh=mesh).to(x.dtype)


# -------------------------------------------------------------- state dicts
def _leaf_name(key: str) -> str:
    return key.rsplit(".", 1)[-1]


def _should_quantize(name: str, leaf: torch.Tensor, min_size: int) -> bool:
    if leaf.ndim < 2 or leaf.numel() < min_size:
        return False
    # norms and biases stay full precision (the reference's WOQ
    # exclusions); MoE routers too
    return not (name.startswith(("ln", "b")) or "bias" in name
                or "scale" in name or name == "router")


def quantize_leaf(key: str, leaf, group_size: int = 128, bits: int = 8,
                  min_size: int = 4096):
    """One leaf of a state dict quantized where the WOQ rules ask for it
    (a large matmul weight); any other leaf as it is."""
    if isinstance(leaf, torch.Tensor) \
            and _should_quantize(_leaf_name(key), leaf, min_size):
        return quantize(leaf, group_size, bits)
    return leaf


def quantize_params(params: Params, group_size: int = 128,
                    min_size: int = 4096, bits: int = 8) -> Params:
    """Quantize every large matmul weight of a flat state dict to int8 or
    int4; leaves that are quantized already stay as they are. Leaves are
    quantized one at a time on their own device; the caller frees the
    dense leaves by dropping its dict."""
    return {k: quantize_leaf(k, v, group_size, bits, min_size)
            for k, v in params.items()}


def dequantize_params(params: Params, dtype=torch.bfloat16) -> Params:
    """Materialize every quantized leaf — the dense paths only (prefill,
    full forward). Decode consumes the leaves quantized."""
    return {k: dequantize(v, dtype) if isinstance(v, QuantizedTensor) else v
            for k, v in params.items()}


def quantized_bytes(params: Params) -> int:
    total = 0
    for leaf in params.values():
        if isinstance(leaf, QuantizedTensor):
            total += leaf.q.numel() + leaf.scale.numel() * 4  # packed for int4
        else:
            total += leaf.numel() * leaf.element_size()
    return int(total)


def decode_weight_bytes(params: Params, skip: tuple = ("pos_embed",)) -> int:
    """Model of the weight bytes one decode step re-reads: every matmul
    weight streams fully per token (quantized leaves count their q bytes +
    scales); embedding lookups are row gathers, so positional tables are
    skipped. A tied token table is read fully by the unembedding and
    counts once; an untied model's unembedding read is its ``lm_head``,
    so there ``tok_embed`` is skipped too."""
    if "lm_head" in params:
        skip = skip + ("tok_embed",)
    total = 0
    for key, leaf in params.items():
        if _leaf_name(key) in skip:
            continue
        if isinstance(leaf, QuantizedTensor):
            total += leaf.q.numel() + leaf.scale.numel() * 4
        elif leaf.ndim >= 2:
            total += leaf.numel() * leaf.element_size()
    return int(total)
