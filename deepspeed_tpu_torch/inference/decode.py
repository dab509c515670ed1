"""Prefill + single-token decode over a contiguous KV cache.

Counterpart of ``deepspeed_tpu/inference/decode.py`` (the contiguous path;
the paged pool comes with the serving slice). The cache is a pair of
``(L, B, KV, max_len, hd)`` tensors, heads-major as in the JAX package, and
attention over it masks the positions at or past the live length.

Differences from the JAX package, all forced by eager PyTorch:
- the cache is written IN PLACE (``index_put_`` on the cache tensors): a
  ``KVCache`` returned by :func:`forward_with_cache` holds the same ``k`` /
  ``v`` tensors it was given, with the new length;
- the decode loop is a Python loop; the carry token and the eos flags stay
  on the device, so a step reads nothing back to the host;
- the 1-token attention goes to the CUDA kernel of
  ``ops/decode_attention.py`` instead of a Pallas one.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..models.transformer import (TransformerConfig, _apply_rope, _norm,
                                  alibi_slopes, layer_params, rope_tables)
from ..ops import decode_attention as _da
from ..utils.logging import warning_once

BIG_NEG = -2.0 ** 30      # not -inf: an all-masked row must not turn NaN


class KVCache(NamedTuple):
    k: torch.Tensor          # (L, B, KV, max_len, hd), written in place
    v: torch.Tensor          # (L, B, KV, max_len, hd), written in place
    length: torch.Tensor     # int32 tokens cached: 0-d (all rows advance
                             # together) or (B,) per row


def cache_layout(cfg: TransformerConfig, batch: int, max_len: int,
                 dtype=None) -> tuple:
    """(shape, dtype) of one K or V cache buffer."""
    return ((cfg.n_layer, batch, cfg.kv_heads, max_len, cfg.head_dim),
            dtype or cfg.dtype)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               *, device="cpu") -> KVCache:
    shape, dtype = cache_layout(cfg, batch, max_len, dtype)
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


def _qkv_proj(model, y, p):
    """The attention projections, as one GEMM when the engine fused them
    into ``wqkv`` = [wq | wk | wv] (and ``bqkv``)."""
    cfg = model.cfg
    B, T, _ = y.shape
    h, kv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    if "wqkv" in p:
        qkv = y @ p["wqkv"].to(y.dtype)
        if cfg.use_bias and "bqkv" in p:
            qkv = qkv + p["bqkv"].to(qkv.dtype)
        q, k, v = qkv.split([h * hd, kv * hd, kv * hd], dim=-1)
    else:
        q = model._maybe_bias(y @ p["wq"].to(y.dtype), p, "bq")
        k = model._maybe_bias(y @ p["wk"].to(y.dtype), p, "bk")
        v = model._maybe_bias(y @ p["wv"].to(y.dtype), p, "bv")
    return (q.reshape(B, T, h, hd), k.reshape(B, T, kv, hd),
            v.reshape(B, T, kv, hd))


def _append(cache_k, cache_v, k, v, new_len):
    """Write the T new positions of every row, ``[new_len - T, new_len)``,
    into one layer's cache IN PLACE. ``new_len`` is 0-d or (B,)."""
    B, T = k.shape[:2]
    pos = new_len.reshape(-1, 1) - T + torch.arange(T, device=k.device)
    rows = torch.arange(B, device=k.device)[:, None]
    # (B, KV, S, hd) viewed as (B, S, KV, hd): [rows, pos] picks (B, T)
    cache_k.transpose(1, 2)[rows, pos] = k.to(cache_k.dtype)
    cache_v.transpose(1, 2)[rows, pos] = v.to(cache_v.dtype)


def _layer_step(model, x, p, cache_k, cache_v, length, rope=None,
                flash_decode: bool = False, alibi=None):
    """One transformer layer over x: (B, T, d), appending its K/V to the
    layer's cache (in place) and attending over it. ``length`` is the
    post-append length; ``rope`` the (cos, sin, rotary_dim) of the step's
    positions; ``alibi`` the (H,) slopes."""
    cfg = model.cfg
    B, T, _ = x.shape
    h, hd = cfg.n_head, cfg.head_dim
    y = _norm(x, p["ln1_scale"], p.get("ln1_bias"), cfg.norm, cfg.norm_eps)
    q, k, v = _qkv_proj(model, y, p)
    if rope is not None:
        q, k = _apply_rope(q, k, *rope)
    _append(cache_k, cache_v, k, v, length)
    o = _cache_attend(q, cache_k, cache_v, length, flash_decode=flash_decode,
                      alibi=alibi)
    o = model._maybe_bias(o.reshape(B, T, h * hd) @ p["wo"].to(x.dtype),
                          p, "bo")
    if cfg.parallel_residual:
        y2 = y if cfg.parallel_shared_ln else _norm(
            x, p["ln2_scale"], p.get("ln2_bias"), cfg.norm, cfg.norm_eps)
        return x + o + model._mlp_block(y2, p)
    x = x + o
    y2 = _norm(x, p["ln2_scale"], p.get("ln2_bias"), cfg.norm, cfg.norm_eps)
    return x + model._mlp_block(y2, p)


def _embed_rows(table, ids, dtype):
    return F.embedding(ids, table).to(dtype)


def _decode_head(model, params, x):
    """Final norm + unembedding for the decode path, with fp32 logits.

    The JAX package multiplies compute-dtype operands into fp32
    (``preferred_element_type``). Here both operands are upcast to fp32
    first, which is exact: every bf16/fp16 value is an fp32 value, so the
    products and the fp32 sum are the same. On the card that holds only
    while ``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's
    default): TF32 would cut the operands back to 10 mantissa bits. The
    engine refuses to start with it on."""
    cfg = model.cfg
    x = model._head_norm(params, x).float()
    w = params["tok_embed"] if cfg.tie_embeddings else params["lm_head"]
    w = w.to(model.cfg.dtype).float()
    logits = x @ (w.T if cfg.tie_embeddings else w)
    if cfg.lm_head_bias:
        logits = logits + params["lm_head_bias"].float()
    return logits


def forward_with_cache(model, params, input_ids, cache: KVCache,
                       flash_decode: bool = False,
                       last_token_head: bool = False):
    """Run T tokens through all layers, appending to the cache in place.

    input_ids: (B, T): prefill (T = prompt length) and decode (T = 1)
    alike. Returns (fp32 logits (B, T, V), the cache with its new length).
    ``last_token_head=True`` computes the unembedding for the final
    position only (the generation loop's prefill)."""
    cfg = model.cfg
    B, T = input_ids.shape
    dev = input_ids.device
    new_len = cache.length + T
    positions = (cache.length.reshape(-1, 1)
                 + torch.arange(T, device=dev)).expand(B, T)
    x = _embed_rows(params["tok_embed"], input_ids, cfg.dtype)
    if cfg.pos_embedding == "learned":
        x = x + _embed_rows(params["pos_embed"], positions, cfg.dtype)
    if cfg.embed_norm:
        x = _norm(x, params["embed_ln_scale"], params.get("embed_ln_bias"),
                  cfg.norm, cfg.norm_eps)
    rope = alibi = None
    if cfg.pos_embedding == "rope":
        rd = cfg.rotary_dim or cfg.head_dim
        rope = (*rope_tables(positions, cfg.rope_theta, rd), rd)
    elif cfg.pos_embedding == "alibi":
        alibi = alibi_slopes(cfg.n_head, dev)
    layers = layer_params(params)
    for i in range(cfg.n_layer):
        x = _layer_step(model, x, {k: w[i] for k, w in layers.items()},
                        cache.k[i], cache.v[i], new_len, rope=rope,
                        flash_decode=flash_decode, alibi=alibi)
    if last_token_head:
        x = x[:, -1:]
    return _decode_head(model, params, x), KVCache(cache.k, cache.v, new_len)


class GenCarry(NamedTuple):
    """Generation state between the prefill and the decode loop."""

    tok: torch.Tensor        # (B,) int64 — latest sampled token
    cache: KVCache
    rng: Any                 # torch.Generator, or one per row
    done: torch.Tensor       # (B,) bool — eos reached


def prefill_tokens(model, params, input_ids, rng, *, max_new: int, sampler,
                   eos_token_id=None, cache_dtype=None,
                   flash_decode: bool = False,
                   cache_len: Optional[int] = None) -> GenCarry:
    """Prompt → first sampled token + primed KV cache (the TTFT phase).
    ``cache_len`` overrides the tight ``S + max_new`` allocation."""
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
                       device=input_ids.device)
    logits, cache = forward_with_cache(model, params, input_ids, cache,
                                       last_token_head=True)
    tok = sampler(logits[:, -1], rng)
    done = (tok == eos_token_id) if eos_token_id is not None \
        else torch.zeros(B, dtype=torch.bool, device=tok.device)
    return GenCarry(tok=tok, cache=cache, rng=rng, done=done)


def decode_step(model, params, carry: GenCarry, *, sampler, eos_token_id=None,
                flash_decode: bool = False) -> GenCarry:
    """ONE decode iteration: forward the carry token, sample the next."""
    tok, cache, rng, done = carry
    lg, cache = forward_with_cache(model, params, tok[:, None], cache,
                                   flash_decode=flash_decode)
    nxt = sampler(lg[:, 0], rng)
    if eos_token_id is not None:
        nxt = torch.where(done, eos_token_id, nxt)
        done = done | (nxt == eos_token_id)
    return GenCarry(nxt, cache, rng, done)


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
                    cache_len: Optional[int] = None):
    """Prefill + decode loop: (B, S) prompt → (B, max_new) tokens."""
    carry = prefill_tokens(model, params, input_ids, rng, max_new=max_new,
                           sampler=sampler, eos_token_id=eos_token_id,
                           cache_dtype=cache_dtype, flash_decode=flash_decode,
                           cache_len=cache_len)
    return decode_tokens(model, params, carry, steps=max_new - 1,
                         sampler=sampler, eos_token_id=eos_token_id,
                         flash_decode=flash_decode)
