"""Slot-based decode state: one persistent KV cache, per-slot everything.

Counterpart of ``deepspeed_tpu/serving/slots.py``. The serving state is ONE
``(L, slots, KV, max_len, hd)`` cache, the layout ``init_cache``
allocates (:func:`~..inference.decode.cache_layout`), plus per-slot
``length`` (int32), ``tok`` (int64), ``done`` and one ``torch.Generator``
per slot. Every write goes into these tensors in place (``copy_``), so
their storage never moves and a CUDA graph captured over them stays valid
(``serving/graph.py``). An insert overwrites the slot's FULL ``max_len``
extent, as the JAX package's ``dynamic_update_slice`` does, so no stale KV
of a retired request can reach its successor.
"""

from __future__ import annotations

import torch

from ..inference.decode import GenCarry, KVCache, cache_layout

__all__ = ["init_slots", "insert_request"]


def init_slots(cfg, slots: int, max_len: int, dtype=None, *,
               device="cpu", kv_heads=None) -> GenCarry:
    """Empty slot state: every slot idle (``done``), length 0.

    A plain :class:`~..inference.decode.GenCarry` whose cache ``length`` is
    a (slots,) vector and whose ``rng`` is a list of per-slot generators,
    so the ``decode_step`` of ``generate()`` serves it as it is.
    ``kv_heads``: a tensor-parallel rank's."""
    shape, dtype = cache_layout(cfg, slots, max_len, dtype, kv_heads=kv_heads)
    cache = KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device),
                    length=torch.zeros(slots, dtype=torch.int32,
                                       device=device))
    return GenCarry(tok=torch.zeros(slots, dtype=torch.long, device=device),
                    cache=cache,
                    rng=[torch.Generator(device=device) for _ in range(slots)],
                    done=torch.ones(slots, dtype=torch.bool, device=device))


def insert_request(state: GenCarry, slot: int, pf: GenCarry) -> None:
    """Write a freshly prefilled request (a batch-1 carry over a cache of
    the same ``max_len``) into slot ``slot`` of ``state``, in place: the
    slot's whole cache extent, its length, token, done flag, and its
    generator (the request's own, which drew its first token)."""
    c = state.cache
    c.k[:, slot].copy_(pf.cache.k[:, 0])
    c.v[:, slot].copy_(pf.cache.v[:, 0])
    c.length[slot].copy_(pf.cache.length.reshape(()))
    state.tok[slot].copy_(pf.tok[0])
    state.done[slot].copy_(pf.done[0])
    state.rng[slot] = pf.rng[0]
