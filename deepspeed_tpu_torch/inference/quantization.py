"""Weight-only int8/int4 quantization for inference (counterpart of
``deepspeed_tpu/inference/quantization.py``, single card).

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

Not ported here (ROADMAP.md queue 1, item 6): the tensor-parallel
branches of ``woq_dot`` / ``woq_dot_t``, ``tp_quant_dot`` and
``quantized_shardings``.
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
    ``scale``: ``(..., G, N)`` fp32 with ``G = K / group_size``."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, group_size: int,
                 bits: int = 8):
        self.q = q
        self.scale = scale
        self.group_size = group_size
        self.bits = bits

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
                               self.bits)

    def columns(self, start: int, stop: int) -> "QuantizedTensor":
        """Output columns ``[start, stop)`` (contiguous copies): the scales
        are per column, so a fused ``[wq | wk | wv]`` splits into its
        parts' own bytes."""
        return QuantizedTensor(self.q[..., start:stop].contiguous(),
                               self.scale[..., start:stop].contiguous(),
                               self.group_size, self.bits)

    @staticmethod
    def cat_columns(parts: list) -> "QuantizedTensor":
        """The inverse of :meth:`columns`: parts side by side along N."""
        gs, bits = parts[0].group_size, parts[0].bits
        if any((p.group_size, p.bits) != (gs, bits) for p in parts):
            raise ValueError("cat_columns: parts differ in group_size/bits")
        return QuantizedTensor(torch.cat([p.q for p in parts], dim=-1),
                               torch.cat([p.scale for p in parts], dim=-1),
                               gs, bits)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device),
                               self.group_size, self.bits)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(shape={self.shape}, bits={self.bits}, "
                f"group_size={self.group_size}, device={self.q.device})")


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
    qv = _unpack_int4(qt.q) if qt.bits == 4 else qt.q
    K, N = qv.shape[-2], qv.shape[-1]
    G = K // qt.group_size
    qf = qv.float().reshape(*qv.shape[:-2], G, qt.group_size, N)
    out = qf * qt.scale[..., :, None, :]
    return out.reshape(qv.shape).to(dtype)


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
    g = ids // qt.group_size if G > 1 else torch.zeros_like(ids)
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
    takes every layout :func:`quantize` produces. Otherwise the weight is
    dequantized to x's dtype at the point of use."""
    K = x.shape[-1]
    N = qt.shape[-1]
    out_dtype = out_dtype or x.dtype
    if not use_kernel:
        return _dense_dot(x, dequantize(qt, x.dtype), out_dtype)
    out = woq_matmul(x.reshape(-1, K).contiguous(), qt.q, qt.scale,
                     group_size=qt.group_size, bits=qt.bits,
                     out_dtype=out_dtype)
    return out.reshape(*x.shape[:-1], N)


def woq_dot_t(x, qt: QuantizedTensor, use_kernel: bool = False,
              out_dtype=None):
    """``x @ W.T`` for a quantized ``(V, K)`` weight — the tied-embedding
    unembedding, read in table layout. Returns (..., V) in ``out_dtype``
    (default x's; the decode head asks for fp32)."""
    K = x.shape[-1]
    V = qt.shape[-2]
    out_dtype = out_dtype or x.dtype
    if not use_kernel:
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


def quantize_params(params: Params, group_size: int = 128,
                    min_size: int = 4096, bits: int = 8) -> Params:
    """Quantize every large matmul weight of a flat state dict to int8 or
    int4; leaves that are quantized already stay as they are. Leaves are
    quantized one at a time on their own device; the caller frees the
    dense leaves by dropping its dict."""
    return {k: quantize(v, group_size, bits)
            if isinstance(v, torch.Tensor)
            and _should_quantize(_leaf_name(k), v, min_size) else v
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
