"""The host tier of the paged KV pool: demote on evict, restore on resume
(counterpart of ``deepspeed_tpu/serving/hostkv.py``).

With ``serving.host_pool_bytes`` the pool's eviction demotes instead of
dropping: the pool's ``on_demote`` seam hands the engine each evicted
full-block tree entry (its page and the token prefix that keys it); the
engine gathers those pages' tiles on the card at once (:func:`demote_rows`,
on the stream every later insert and replay runs on, so the bytes are
copied before a freed page can be rewritten), copies them into pinned host
memory behind a CUDA event, and puts them into this store at the end of
the step. An admission consults the store right after the radix-tree
match: the matched cold blocks are consumed and uploaded into the
request's prefill cache (:func:`restore_into_cache`), and the request then
takes the same chunk plan and insert as a tree hit. A pruned, colliding or
corrupt copy is not a match: the block is recomputed.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from ..inference.decode import dequantize_kv
from .tiering import TierStore, tiles_crc, tiles_crcs

__all__ = ["HostKVTier", "PinnedPages", "demote_rows", "restore_into_cache"]


# ------------------------------------------------------------ device side
def demote_rows(state, pages: torch.Tensor) -> dict:
    """The tiles of pool ``pages`` (a device index), page-major: ``{"k":
    (n, L, KV, ps, hd), "v": ..., and with an int8 pool "k_scale" / "v_scale"
    (n, L, KV, ps)}``, one gather each into fresh tensors, so each page's
    tile is one contiguous block and a later write of the pages cannot
    reach the copy. The JAX package gathers ``(L, n, ...)`` from a padded
    row; the port gathers only the live pages."""
    c = state.cache
    names = ("k", "v") + (("k_scale", "v_scale") if c.k_scale is not None
                          else ())
    return {name: getattr(c, name).transpose(0, 1).index_select(0, pages)
            for name in names}


def restore_into_cache(cache, tiles: dict, start: int) -> None:
    """Write restored page tiles (page-major device tensors, as
    :func:`demote_rows` gathers them) into a batch-1 prefill cache's pages
    ``[start, start + n)``, in place: the restore's counterpart of
    :func:`~.pages.hydrate_cache`. An int8 pool's tiles dequantize here, as
    the hydrate's gather does."""
    from .pages import _page_split

    ps = tiles["k"].shape[3]
    n_pages = cache.k.shape[3] // ps
    tk, tv = tiles["k"].transpose(0, 1), tiles["v"].transpose(0, 1)
    if "k_scale" in tiles:
        tk = dequantize_kv(tk, tiles["k_scale"].transpose(0, 1),
                           cache.k.dtype)
        tv = dequantize_kv(tv, tiles["v_scale"].transpose(0, 1),
                           cache.v.dtype)
    n = tk.shape[1]
    _page_split(cache.k, n_pages, ps)[:, start:start + n] = \
        tk.to(cache.k.dtype)
    _page_split(cache.v, n_pages, ps)[:, start:start + n] = \
        tv.to(cache.v.dtype)


# -------------------------------------------------------------- host side
class PinnedPages:
    """Host page slots of ``slot_bytes`` each, carved from slabs of pinned
    memory (one allocation a slab; plain memory with ``pin=False``): the
    tier's demoted pages and the disk rung's buffers. Pinning is the slow
    part of a pinned allocation, so the engine makes its slabs once, for
    its whole budget, and reuses the slots. :meth:`take` gives a uint8
    numpy array over a free slot; the slot goes back to the free list when
    the last array or tensor viewing it is gone (a ctypes array owns the
    views, and a finalizer on it returns the slot)."""

    PER_SLAB = 64       # slots a slab grows by once the free list is empty

    def __init__(self, slot_bytes: int, slots: int = 0, pin: bool = True):
        self.slot_bytes = int(slot_bytes)
        self.pin = pin
        self.free: list = []
        self._slabs: list = []
        self.slots = 0
        if slots:
            self._grow(slots)

    def _grow(self, n: int) -> None:
        slab = torch.empty(n * self.slot_bytes, dtype=torch.uint8,
                           pin_memory=self.pin)
        self._slabs.append(slab)
        base = slab.data_ptr()
        self.free.extend(base + i * self.slot_bytes for i in range(n))
        self.slots += n

    def take(self, nbytes: int = 0, zero: bool = False) -> np.ndarray:
        """A slot's first ``nbytes`` (all of it for 0) as uint8, zeroed
        with ``zero``."""
        if nbytes > self.slot_bytes:
            raise ValueError(f"{nbytes} B do not fit a {self.slot_bytes} B "
                             "page slot")
        if not self.free:
            self._grow(self.PER_SLAB)
        addr = self.free.pop()
        owner = (ctypes.c_uint8 * self.slot_bytes).from_address(addr)
        weakref.finalize(owner, self.free.append, addr)
        out = np.frombuffer(owner, dtype=np.uint8)[:nbytes or None]
        if zero:
            out[:] = 0
        return out


class HostKVTier(TierStore):
    """Bounded host-memory page store: the demotion target and restore
    source of one engine's pool. The store discipline is
    :class:`~.tiering.TierStore`'s; this rung keeps the tiles on the
    entry, and checks the CRCs of the entries a match is about to walk
    together (``_precheck``)."""

    kind = "host_tier"

    def _attach(self, key, ent: dict, tiles: dict) -> None:
        ent["tiles"] = tiles

    def _verify(self, ent: dict):
        ok = ent.pop("crc_ok", None)
        if ok is None:
            ok = tiles_crc(ent["tiles"]) == ent["crc"]
        return ent["tiles"] if ok else None

    def _precheck(self, keys: list) -> None:
        ents = [e for e in map(self.entries.get, keys) if e is not None]
        for e, crc in zip(ents, tiles_crcs([e["tiles"] for e in ents])):
            e["crc_ok"] = crc == e["crc"]

    def _unprecheck(self, keys: list) -> None:
        for e in map(self.entries.get, keys):
            if e is not None:
                e.pop("crc_ok", None)
