"""Prefill + single-token decode over a contiguous or a paged KV cache.

Counterpart of ``deepspeed_tpu/inference/decode.py``. The contiguous cache
is a pair of ``(L, B, KV, max_len, hd)`` tensors, heads-major as in the JAX
package, and attention over it masks the positions at or past the live
length. The paged cache (:class:`PagedKVCache`, the serving pool of
``serving/pages.py``) holds ``(L, pages, KV, page_size, hd)`` pools and a
per-slot page table; a step scatters its K/V through the table and
gathers each slot's pages back into the contiguous view before attention,
so the paged step runs the contiguous step's kernels on the same values.

Differences from the JAX package, all forced by eager PyTorch:
- the cache is written IN PLACE (``index_put_`` on the cache tensors): a
  ``KVCache`` returned by :func:`forward_with_cache` holds the same ``k`` /
  ``v`` tensors it was given, with the new length;
- the decode loop is a Python loop; the carry token and the eos flags stay
  on the device, so a step reads nothing back to the host;
- the 1-token attention goes to the CUDA kernel of
  ``ops/decode_attention.py`` instead of a Pallas one;
- a write past ``max_len`` (an idle serving slot, whose length keeps
  growing as in the JAX package) lands on the last position, as XLA's
  ``dynamic_update_slice`` clamps it (on the paged cache: on the table's
  last entry, as the JAX package clips it), and a learned-position lookup
  past the table reads its last row, as XLA's gather clamps it; live rows
  never reach either;
- the paged pools, their scales and the page table are written IN PLACE
  too, so a CUDA graph of the slot step reads them by address;
- :func:`decode_step` is :func:`decode_forward` then :func:`decode_sample`,
  so the serving engine can replay the first half as a CUDA graph
  (``serving/graph.py``) and sample eagerly after it.

Tensor parallelism spells out what GSPMD inserts in the JAX package, over
the model's ``tp_layout`` (``TPLayout``, stamped by the inference engine;
one rank without it): each rank attends at its own query and KV heads
(caches at its KV heads), all-reduces the partials of ``wo`` and ``w_out``
over the ``model`` line before their biases (a parallel residual reduces
both at once at ``tp`` > 1), looks its rows of a vocabulary-split table up
and all-reduces them, and all-gathers its columns of the logits, so every
rank samples the same token. Within a ``torch.distributed`` world every
collective is issued, over a group of one at ``tp`` 1; the rank-local
branches switch on ``tp`` > 1, so a world of one computes what one card
with no group does.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..comm import comm
from ..models.transformer import (LAYER_PREFIX, TPLayout, TransformerConfig,
                                  _activation, _apply_rope, _norm,
                                  alibi_slopes, layer_params, rope_tables)
from ..ops import decode_attention as _da
from ..utils.logging import warning_once
from .quantization import (QuantizedTensor, dequant_rows, matmul_any,
                           row_partial, tp_quant_dot, woq_dot, woq_dot_t)

BIG_NEG = -2.0 ** 30      # not -inf: an all-masked row must not turn NaN


class KVCache(NamedTuple):
    k: torch.Tensor          # (L, B, KV, max_len, hd), written in place
    v: torch.Tensor          # (L, B, KV, max_len, hd), written in place
    length: torch.Tensor     # int32 tokens cached: 0-d (all rows advance
                             # together) or (B,) per row


class PagedKVCache(NamedTuple):
    """The serving slots' page-pool KV state (``serving/pages.py``).

    ``k`` / ``v`` are pools of fixed-size pages shared by every slot, in
    the compute dtype, or int8 with ``kv_quant_bits=8``: then ``k_scale``
    / ``v_scale`` hold one fp32 scale per token and head (None in fp).
    Each slot maps its positions onto pool pages through its row of
    ``page_table``; page 0 is scratch, where idle rows and shared entries
    of an insert write. Every tensor is written in place."""

    k: torch.Tensor                   # (L, pages, KV, page_size, hd)
    v: torch.Tensor                   # (L, pages, KV, page_size, hd)
    k_scale: Optional[torch.Tensor]   # (L, pages, KV, page_size) fp32
    v_scale: Optional[torch.Tensor]   # (L, pages, KV, page_size) fp32
    page_table: torch.Tensor          # (slots, pages_per_slot) int32
    length: torch.Tensor              # (slots,) int32

    @property
    def page_size(self) -> int:
        return self.k.shape[3]


def layout_of(model) -> TPLayout:
    """The model's tensor-parallel layout: the engine's ``tp_layout``, or
    one rank with no process group."""
    lay = getattr(model, "tp_layout", None)
    return lay if lay is not None else TPLayout.of(model.cfg)


def cache_layout(cfg: TransformerConfig, batch: int, max_len: int,
                 dtype=None, *, page_size: int = 0, pages: int = 0,
                 kv_heads: Optional[int] = None) -> tuple:
    """(shape, dtype) of one K or V cache buffer, the one source of the
    shapes for ``init_cache``, the serving slots and the page pool.
    ``page_size`` 0 is the contiguous ``(L, batch, KV, max_len, hd)``;
    above 0 the pool ``(L, pages, KV, page_size, hd)``, whose page is a
    position-contiguous tile of the contiguous layout. ``kv_heads``: a
    tensor-parallel rank's (default all of the model's)."""
    kv = kv_heads or cfg.kv_heads
    if page_size > 0:
        return ((cfg.n_layer, pages, kv, page_size, cfg.head_dim),
                dtype or cfg.dtype)
    return ((cfg.n_layer, batch, kv, max_len, cfg.head_dim),
            dtype or cfg.dtype)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               *, device="cpu", kv_heads: Optional[int] = None) -> KVCache:
    shape, dtype = cache_layout(cfg, batch, max_len, dtype,
                                kv_heads=kv_heads)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def _cache_attend(q, ck, cv, length, flash_decode: bool = False, alibi=None):
    """q: (B, T, H, hd) vs one layer's cache (B, KV, max_len, hd); slots at
    or past ``length`` (0-d or (B,)) are masked, query t sitting at global
    position ``length - T + t``. ``alibi``: the (H,) slopes.
    ``flash_decode`` routes the T == 1 step to the decode-attention kernel
    when the cache length is a multiple of 128 (``prefill_tokens`` rounds
    it up so); everything else takes the dense path, with the JAX
    package's bf16 rounding points: scores in the compute dtype, then
    fp32, masked with BIG_NEG, softmax, probs cast back."""
    B, T, H, hd = q.shape
    if flash_decode and T == 1:
        if ck.shape[2] % 128 == 0:
            return _da.decode_attention(q.contiguous(), ck, cv, length,
                                        alibi_slopes=alibi)
        warning_once(f"decode: flash_decode declined for a cache of "
                     f"{ck.shape[2]} positions (not a multiple of 128); "
                     "the dense path materializes (B, H, 1, max_len) scores")
    length = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    KV, S = ck.shape[1], ck.shape[2]
    if KV != H:
        ck = ck.repeat_interleave(H // KV, dim=1)
        cv = cv.repeat_interleave(H // KV, dim=1)
    scores = torch.einsum("bthd,bhsd->bhts", q, ck).float() / math.sqrt(hd)
    steps = torch.arange(T, device=q.device)
    if length.ndim == 1:
        t_pos = length[:, None, None] - T + steps[None, :, None]   # (B,T,1)
        s_pos = torch.arange(S, device=q.device)[None, None, :]     # (1,1,S)
        if alibi is not None:
            rel = (s_pos - t_pos).float()                           # (B,T,S)
            scores = scores + alibi[None, :, None, None] * rel[:, None]
        keep = s_pos <= t_pos
        scores = torch.where(keep[:, None], scores, BIG_NEG)
    else:
        t_pos = length - T + steps[:, None]                          # (T,1)
        s_pos = torch.arange(S, device=q.device)[None, :]            # (1,S)
        if alibi is not None:
            rel = (s_pos - t_pos).float()                            # (T,S)
            scores = scores + alibi[None, :, None, None] * rel
        keep = s_pos <= t_pos
        scores = torch.where(keep[None, None], scores, BIG_NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsd->bthd", probs, cv)


def _qkv_proj(model, y, p, lay: Optional[TPLayout] = None):
    """The attention projections, as one GEMM when the engine fused them
    into ``wqkv`` = [wq | wk | wv] (and ``bqkv``), at the rank's heads."""
    cfg = model.cfg
    lay = lay or layout_of(model)
    B, T, _ = y.shape
    h, kv, hd = lay.heads, lay.kv_heads, cfg.head_dim
    use_kernel = getattr(model, "woq_kernel", False)
    if "wqkv" in p:
        qkv = matmul_any(y, p["wqkv"], use_kernel)
        if cfg.use_bias and "bqkv" in p:
            qkv = qkv + p["bqkv"].to(qkv.dtype)
        q, k, v = qkv.split([h * hd, kv * hd, kv * hd], dim=-1)
    else:
        q = model._maybe_bias(matmul_any(y, p["wq"], use_kernel), p, "bq")
        k = model._maybe_bias(matmul_any(y, p["wk"], use_kernel), p, "bk")
        v = model._maybe_bias(matmul_any(y, p["wv"], use_kernel), p, "bv")
    return (q.reshape(B, T, h, hd), k.reshape(B, T, kv, hd),
            v.reshape(B, T, kv, hd))


def _append(cache_k, cache_v, k, v, new_len):
    """Write the T new positions of every row, ``[new_len - T, new_len)``,
    into one layer's cache IN PLACE. ``new_len`` is 0-d or (B,); positions
    past the cache are clamped to its last one (only an idle serving row
    reaches them: at the speculative verify's T > 1 it writes several
    tokens to that one position of its own row, harmless garbage, while
    the engine's headroom check keeps every live row inside the cache)."""
    B, T = k.shape[:2]
    pos = (new_len.reshape(-1, 1) - T
           + torch.arange(T, device=k.device)).clamp_(max=cache_k.shape[2] - 1)
    rows = torch.arange(B, device=k.device)[:, None]
    # (B, KV, S, hd) viewed as (B, S, KV, hd): [rows, pos] picks (B, T)
    cache_k.transpose(1, 2)[rows, pos] = k.to(cache_k.dtype)
    cache_v.transpose(1, 2)[rows, pos] = v.to(cache_v.dtype)


# int8 KV: max(amax, 1e-8) / 127 as the JAX engine's compiled quantize_kv
# computes it: XLA folds the division by the constant into a product with
# fp32(1 / 127)
_KV_RECIPROCAL = float(np.float32(1) / np.float32(127))


def quantize_kv(x, axis: int = -1):
    """Symmetric int8 quantization of KV values, one fp32 scale per token
    and head over ``axis`` (hd). Returns (int8 q, fp32 scale).
    quantize(dequantize(quantize(x))) == quantize(x): the largest element
    comes back as exactly +-127, which a hydrated shared prefix relies
    on. ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=axis).clamp_min(1e-8) * _KV_RECIPROCAL
    q = torch.clamp(torch.round(xf / scale.unsqueeze(axis)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype, axis: int = -1):
    """Inverse of :func:`quantize_kv` at the point of use."""
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


def _paged_append(ck, cv, ks, vs, k, v, page_table, new_len):
    """Write T new tokens' K/V of every slot into one layer's pools IN
    PLACE. ``ck`` / ``cv``: (pages, KV, page_size, hd); ``ks`` / ``vs``:
    their (pages, KV, page_size) scales or None; ``k`` / ``v``: (B, T, KV,
    hd); ``new_len``: the (B,) post-append lengths. Row b's token j lands
    at position ``new_len[b] - T + j``, through its table row at (page,
    offset); the page index clips to the row's last entry, as the JAX
    package's does, so an idle row whose length ran past ``max_len``
    writes only where its row points: scratch page 0, where duplicate
    targets are harmless."""
    B, T = k.shape[:2]
    ps, n = ck.shape[2], page_table.shape[1]
    pos = (new_len.reshape(-1, 1) - T
           + torch.arange(T, device=k.device, dtype=new_len.dtype))
    pid = torch.gather(page_table, 1, (pos // ps).clamp(0, n - 1).long())
    off = (pos % ps).long()
    pid = pid.long()
    # (pages, KV, ps, hd) viewed as (pages, ps, KV, hd): [pid, off] picks
    # (B, T), the values' leading dims
    if ks is not None:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        ck.transpose(1, 2)[pid, off] = qk
        cv.transpose(1, 2)[pid, off] = qv
        ks.transpose(1, 2)[pid, off] = sk
        vs.transpose(1, 2)[pid, off] = sv
    else:
        ck.transpose(1, 2)[pid, off] = k.to(ck.dtype)
        cv.transpose(1, 2)[pid, off] = v.to(cv.dtype)


def _gather_pages(pool, page_table):
    """``pool``'s (KV, ...) slab of each table entry, as (B, KV, n, ...):
    ``out[b, h, j] = pool[page_table[b, j], h]``. A byte copy, moved in
    8-byte words (a page slab of 8 or more positions is a whole number of
    them), four to eight times fewer elements than the pool's dtype."""
    B, n = page_table.shape
    pages, KV = pool.shape[:2]
    words = pool.reshape(pages, KV, -1).view(torch.int64)
    heads = torch.arange(KV, device=pool.device)[None, :, None]
    g = words[page_table.long()[:, None, :], heads]     # (B, KV, n, words)
    return g.view(pool.dtype).reshape(B, KV, n, *pool.shape[2:])


def _paged_view(cp, sp, page_table, dtype):
    """One layer's pool pages gathered into the slots' contiguous view
    (B, KV, pages_per_slot * page_size, hd): fp pools give the bytes a
    contiguous cache would hold; int8 pools dequantize here (scales over
    hd), as the JAX package does: the fp32 product, rounded once to
    ``dtype``, in one pass."""
    B, n = page_table.shape
    ps, hd = cp.shape[2], cp.shape[3]
    g = _gather_pages(cp, page_table).reshape(B, -1, n * ps, hd)
    if sp is None:
        return g
    s = _gather_pages(sp, page_table).reshape(B, -1, n * ps, 1)
    return torch.mul(g, s, out=torch.empty(g.shape, dtype=dtype,
                                           device=g.device))


def _reduce(part, dtype, lay: TPLayout):
    """The ``model`` all-reduce of a row-split product's partials, cast to
    ``dtype`` (an fp32 WOQ partial is reduced in fp32)."""
    return comm.all_reduce(part, "model", mesh=lay.mesh).to(dtype)


def _tp_quant_eligible(model, p, T: int, lay: TPLayout) -> int:
    """int8 when the quantized TP collective applies to this step, else 0
    (``decode.py:266`` of the JAX package): the engine opted in
    (``tp_comm_quant``, stamped on the model), ``tp`` > 1, T == 1 (decode;
    a prefill pays its reduction once a request, and the speculative
    verify's T > 1 forward reduces at full precision, as in JAX), and a
    DENSE ``wo`` (a quantized one reduces its fp32 partial)."""
    bits = int(getattr(model, "tp_quant", 0) or 0)
    if not bits or T != 1 or lay.tp == 1:
        return 0
    if isinstance(p.get("wo"), QuantizedTensor):
        return 0
    return bits


def _mlp_hidden(model, y, p):
    """The dense MLP up to ``w_out``: the activation of the rank's FFN
    columns (the gated product for a GLU)."""
    u = model._mlp_pre(y, p)
    return u if model.cfg.is_glu else _activation(u, model.cfg.activation)


def _dense_mlp(model, y, p, lay: TPLayout, tpq: int = 0):
    """The dense MLP of a decode or prefill step: the rank's columns of
    ``w_in`` / ``w_gate``, its rows of ``w_out``, the ``model`` reduction
    (the two-sided int8 one with ``tpq``, as ``_mlp_tp_quant`` of the JAX
    package, where ``w_out`` is dense), then ``b_out``."""
    u = _mlp_hidden(model, y, p)
    if tpq and not isinstance(p.get("w_out"), QuantizedTensor):
        out = tp_quant_dot(u, p["w_out"], mesh=lay.mesh, bits=tpq)
    else:
        out = _reduce(row_partial(u, p["w_out"],
                                  getattr(model, "woq_kernel", False),
                                  lay.tp), u.dtype, lay)
    return model._maybe_bias(out, p, "b_out")


def _layer_step(model, x, p, cache_k, cache_v, length, rope=None,
                flash_decode: bool = False, alibi=None, paged=None, lay=None):
    """One transformer layer over x: (B, T, d), appending its K/V to the
    layer's cache (in place) and attending over it. ``length`` is the
    post-append length; ``rope`` the (cos, sin, rotary_dim) of the step's
    positions; ``alibi`` the rank's (H,) slopes. ``paged``: (page_table,
    k_scale, v_scale) when ``cache_k`` / ``cache_v`` are one layer's pools;
    the attention then reads the gathered view. ``lay``: the rank's
    tensor-parallel layout."""
    cfg = model.cfg
    lay = lay or layout_of(model)
    B, T, _ = x.shape
    h, hd = lay.heads, cfg.head_dim
    use_kernel = getattr(model, "woq_kernel", False)
    y = _norm(x, p["ln1_scale"], p.get("ln1_bias"), cfg.norm, cfg.norm_eps)
    q, k, v = _qkv_proj(model, y, p, lay)
    if rope is not None:
        q, k = _apply_rope(q, k, *rope)
    if paged is not None:
        table, ks, vs = paged
        _paged_append(cache_k, cache_v, ks, vs, k, v, table, length)
        cache_k = _paged_view(cache_k, ks, table, cfg.dtype)
        cache_v = _paged_view(cache_v, vs, table, cfg.dtype)
    else:
        _append(cache_k, cache_v, k, v, length)
    o = _cache_attend(q, cache_k, cache_v, length, flash_decode=flash_decode,
                      alibi=alibi)
    o_flat = o.reshape(B, T, h * hd)
    # the quantized TP collective (tp_comm_quant) reduces wo and the dense
    # MLP's w_out, each on its own, as the JAX package spells them
    tpq = _tp_quant_eligible(model, p, T, lay)
    # an MoE trunk's T = 1 step routes the batch as one group with no drop
    # (``_mlp_block_infer``); its prefill (T > 1) takes the training
    # dispatch; both reduce over the ("expert", "model") line themselves
    moe = getattr(model, "_mlp_block_infer", None) if T == 1 else None
    moe = moe or (model._mlp_block if model.routes_experts else None)
    if cfg.parallel_residual:
        y2 = y if cfg.parallel_shared_ln else _norm(
            x, p["ln2_scale"], p.get("ln2_bias"), cfg.norm, cfg.norm_eps)
        if lay.tp > 1 and moe is None and not tpq:
            # Megatron's parallel block: one reduction for both branches,
            # the biases after it
            part = row_partial(o_flat, p["wo"], use_kernel, lay.tp) \
                + row_partial(_mlp_hidden(model, y2, p), p["w_out"],
                              use_kernel, lay.tp)
            out = _reduce(part, x.dtype, lay)
            return x + model._maybe_bias(model._maybe_bias(out, p, "bo"), p,
                                         "b_out")
    if tpq:
        o = tp_quant_dot(o_flat, p["wo"], mesh=lay.mesh, bits=tpq)
    else:
        o = _reduce(row_partial(o_flat, p["wo"], use_kernel, lay.tp),
                    x.dtype, lay)
    o = model._maybe_bias(o, p, "bo")
    mlp = moe or (lambda y_, p_: (_dense_mlp(model, y_, p_, lay, tpq), None))
    if cfg.parallel_residual:
        return x + o + mlp(y2, p)[0]
    x = x + o
    y2 = _norm(x, p["ln2_scale"], p.get("ln2_bias"), cfg.norm, cfg.norm_eps)
    return x + mlp(y2, p)[0]


_alibi: dict = {}


def _alibi_slopes(n_head: int, device, lay: Optional[TPLayout] = None):
    """The rank's slice of the model's (H,) ALiBi slopes on ``device``,
    built once: a copy from host memory each step could not be captured in
    a CUDA graph. A tensor-parallel rank takes its query heads' slopes of
    the GLOBAL ramp, not the ramp of ``n_head / tp`` heads."""
    q0, heads = (lay.q0, lay.heads) if lay is not None else (0, n_head)
    key = (n_head, q0, heads, str(device))
    if key not in _alibi:
        _alibi[key] = alibi_slopes(n_head, device)[q0:q0 + heads].contiguous()
    return _alibi[key]


def _embed_rows(table, ids, dtype):
    """Row gather from a dense or an int8/int4-stored table: a quantized
    table reads the batch's rows only."""
    if isinstance(table, QuantizedTensor):
        return dequant_rows(table, ids, dtype)
    return F.embedding(ids, table).to(dtype)


def _embed_tokens(table, ids, dtype, lay: TPLayout):
    """The token embedding: at ``tp`` > 1 over a vocabulary-split table,
    the rank's rows (the others zero), all-reduced over ``model``, as
    Megatron's vocab-parallel embedding; a table kept whole (``tp`` does
    not divide the vocabulary) is looked up with no collective."""
    if not lay.vocab_split:
        return _embed_rows(table, ids, dtype)
    if lay.tp > 1:
        local = ids - lay.v0
        hit = (local >= 0) & (local < lay.v1 - lay.v0)
        rows = _embed_rows(table, torch.where(hit, local, 0), dtype)
        rows = rows.masked_fill(~hit[..., None], 0)
    else:
        rows = _embed_rows(table, ids, dtype)
    return comm.all_reduce(rows, "model", mesh=lay.mesh)


def _decode_head(model, params, x, lay: Optional[TPLayout] = None):
    """Final norm + unembedding for the decode path, with fp32 logits.

    The JAX package multiplies compute-dtype operands into fp32
    (``preferred_element_type``). Here both operands are upcast to fp32
    first, which is exact: every bf16/fp16 value is an fp32 value, so the
    products and the fp32 sum are the same. On the card that holds only
    while ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
    default): TF32 would cut the operands back to 10 mantissa bits. The
    engine refuses to start with it on.

    A quantized table goes through ``woq_dot_t`` (tied, read in ``(V, d)``
    layout) or ``woq_dot`` (untied ``lm_head``), with fp32 out. A
    vocabulary-split rank computes its columns (and adds its slice of
    ``lm_head_bias``), then all-gathers the logits along the vocabulary."""
    cfg = model.cfg
    lay = lay or layout_of(model)
    x = model._pre_head(params, x)
    w = params["tok_embed"] if cfg.tie_embeddings else params["lm_head"]
    if isinstance(w, QuantizedTensor):
        dot = woq_dot_t if cfg.tie_embeddings else woq_dot
        logits = dot(x, w, use_kernel=getattr(model, "woq_kernel", False),
                     out_dtype=torch.float32)
    else:
        w = w.to(model.cfg.dtype).float()
        logits = x.float() @ (w.T if cfg.tie_embeddings else w)
    if cfg.lm_head_bias:
        logits = logits + params["lm_head_bias"].float()
    if lay.vocab_split:
        logits = comm.all_gather(logits, "model", logits.ndim - 1,
                                 mesh=lay.mesh)
    return logits


def forward_with_cache(model, params, input_ids, cache,
                       flash_decode: bool = False,
                       last_token_head: bool = False, last_index=None,
                       materialize=None):
    """Run T tokens through all layers, appending to the cache in place.

    input_ids: (B, T): prefill (T = prompt length) and decode (T = 1)
    alike. Returns (fp32 logits (B, T, V), the cache with its new length).
    ``last_token_head=True`` computes the unembedding for the final
    position only (the generation loop's prefill); ``last_index`` (an int)
    names that position instead of T - 1 (the serving engine's
    right-padded final prefill chunk ends its real tokens before the
    chunk's end). ``materialize``: an
    optional ``params -> dense params`` function (``dequantize_params``),
    applied to the top-level leaves once and to each layer's leaves as the
    loop reaches it, so a quantized model runs dense with one layer's
    dense copy alive at a time — the values of the JAX package's
    whole-tree ``materialize``. ``cache`` may be a :class:`PagedKVCache`
    (the serving slot step): each layer then scatters through the page
    table and attends over the gathered view."""
    cfg = model.cfg
    lay = layout_of(model)
    mat = materialize if materialize is not None else (lambda p: p)
    layers = layer_params(params)
    params = mat({k: v for k, v in params.items()
                  if not k.startswith(LAYER_PREFIX)})
    B, T = input_ids.shape
    dev = input_ids.device
    new_len = cache.length + T
    positions = (cache.length.reshape(-1, 1)
                 + torch.arange(T, device=dev)).expand(B, T)
    x = _embed_tokens(params["tok_embed"], input_ids, cfg.dtype, lay)
    if cfg.pos_embedding == "learned":
        table = params["pos_embed"]
        x = x + _embed_rows(table, positions.clamp(max=table.shape[0] - 1),
                            cfg.dtype)
    if cfg.embed_norm:
        x = _norm(x, params["embed_ln_scale"], params.get("embed_ln_bias"),
                  cfg.norm, cfg.norm_eps)
    rope = alibi = None
    if cfg.pos_embedding == "rope":
        rd = cfg.rotary_dim or cfg.head_dim
        rope = (*rope_tables(positions, cfg.rope_theta, rd), rd)
    elif cfg.pos_embedding == "alibi":
        alibi = _alibi_slopes(cfg.n_head, dev, lay)
    paged = isinstance(cache, PagedKVCache)
    for i in range(cfg.n_layer):
        pg = None
        if paged:
            pg = (cache.page_table,
                  *(None if s is None else s[i]
                    for s in (cache.k_scale, cache.v_scale)))
        x = _layer_step(model, x, mat({k: w[i] for k, w in layers.items()}),
                        cache.k[i], cache.v[i], new_len, rope=rope,
                        flash_decode=flash_decode, alibi=alibi, paged=pg,
                        lay=lay)
    if last_token_head:
        x = x[:, -1:] if last_index is None else \
            x.narrow(1, int(last_index), 1)
    return _decode_head(model, params, x, lay), \
        cache._replace(length=new_len)


class GenCarry(NamedTuple):
    """Generation state between the prefill and the decode loop."""

    tok: torch.Tensor        # (B,) int64 — latest sampled token
    cache: KVCache
    rng: Any                 # torch.Generator, or one per row
    done: torch.Tensor       # (B,) bool — eos reached


def prefill_tokens(model, params, input_ids, rng, *, max_new: int, sampler,
                   eos_token_id=None, cache_dtype=None,
                   flash_decode: bool = False,
                   cache_len: Optional[int] = None,
                   materialize=None) -> GenCarry:
    """Prompt → first sampled token + primed KV cache (the TTFT phase).
    ``cache_len`` overrides the tight ``S + max_new`` allocation.
    ``materialize`` (quantized params → dense) applies HERE only: the
    prefill runs dense, the decode loop consumes ``params`` as given."""
    objective = getattr(model.cfg, "objective", "clm")
    if objective != "clm":
        raise ValueError(
            f"generation needs a causal LM head; this model's objective is "
            f"{objective!r} — use forward() instead")
    B, S = input_ids.shape
    if cache_len is None:
        cache_len = S + max_new
    elif cache_len < S + max_new:
        raise ValueError(f"cache_len={cache_len} < prompt + max_new "
                         f"= {S + max_new}")
    if flash_decode:
        # round up to a multiple of 128, the gate in _cache_attend: the
        # spare slots are masked by the live length, and every decode step
        # stays on the kernel whatever the prompt and output lengths
        cache_len = -(-cache_len // 128) * 128
    cache = init_cache(model.cfg, B, cache_len, cache_dtype or model.cfg.dtype,
                       device=input_ids.device,
                       kv_heads=layout_of(model).kv_heads)
    logits, cache = forward_with_cache(model, params, input_ids, cache,
                                       last_token_head=True,
                                       materialize=materialize)
    tok = sampler(logits[:, -1], rng)
    done = (tok == eos_token_id) if eos_token_id is not None \
        else torch.zeros(B, dtype=torch.bool, device=tok.device)
    return GenCarry(tok=tok, cache=cache, rng=rng, done=done)


def decode_forward(model, params, carry: GenCarry, *,
                   flash_decode: bool = False):
    """The device half of :func:`decode_step`: the carry token through
    every layer. Returns (fp32 logits (B, 1, V), the cache at its new
    length); the serving engine captures this half in a CUDA graph."""
    return forward_with_cache(model, params, carry.tok[:, None], carry.cache,
                              flash_decode=flash_decode)


def decode_sample(carry: GenCarry, logits, cache: KVCache, *, sampler,
                  eos_token_id=None) -> GenCarry:
    """The sampling half of :func:`decode_step`: the next token from the
    step's logits, eos forced on rows already done."""
    nxt = sampler(logits[:, 0], carry.rng)
    done = carry.done
    if eos_token_id is not None:
        nxt = torch.where(done, eos_token_id, nxt)
        done = done | (nxt == eos_token_id)
    return GenCarry(nxt, cache, carry.rng, done)


def finite_rows(logits) -> torch.Tensor:
    """The logit guard: (B,) bool, row b's (B, T, V) logits all finite."""
    return torch.isfinite(logits).flatten(1).all(dim=1)


def decode_step(model, params, carry: GenCarry, *, sampler, eos_token_id=None,
                flash_decode: bool = False) -> GenCarry:
    """ONE decode iteration: forward the carry token, sample the next —
    :func:`decode_forward`, then :func:`decode_sample`, the two halves the
    serving engine's slot step runs apart."""
    lg, cache = decode_forward(model, params, carry, flash_decode=flash_decode)
    return decode_sample(carry, lg, cache, sampler=sampler,
                         eos_token_id=eos_token_id)


def decode_tokens(model, params, carry: GenCarry, *, steps: int, sampler,
                  eos_token_id=None, flash_decode: bool = False,
                  return_carry: bool = False):
    """``steps`` more tokens after the carry's. Returns (B, steps + 1) —
    the carry token plus everything it generated — or ``(tokens, carry)``
    with ``return_carry=True``."""
    toks = []
    for _ in range(steps):
        toks.append(carry.tok)
        carry = decode_step(model, params, carry, sampler=sampler,
                            eos_token_id=eos_token_id,
                            flash_decode=flash_decode)
    tokens = torch.stack(toks + [carry.tok], dim=1)
    return (tokens, carry) if return_carry else tokens


def generate_tokens(model, params, input_ids, rng, *, max_new: int, sampler,
                    eos_token_id=None, cache_dtype=None,
                    flash_decode: bool = False,
                    cache_len: Optional[int] = None, materialize=None):
    """Prefill + decode loop: (B, S) prompt → (B, max_new) tokens."""
    carry = prefill_tokens(model, params, input_ids, rng, max_new=max_new,
                           sampler=sampler, eos_token_id=eos_token_id,
                           cache_dtype=cache_dtype, flash_decode=flash_decode,
                           cache_len=cache_len, materialize=materialize)
    return decode_tokens(model, params, carry, steps=max_new - 1,
                         sampler=sampler, eos_token_id=eos_token_id,
                         flash_decode=flash_decode)
