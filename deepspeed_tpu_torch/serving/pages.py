"""Paged KV cache: the page pool's allocator, its radix prefix tree, and
the device writes and reads of the pool.

Counterpart of ``deepspeed_tpu/serving/pages.py``. The device state is ONE
``(L, pages, KV, page_size, hd)`` pool per K and V (the shared
:func:`~..inference.decode.cache_layout`) plus a per-slot page table,
all in the slot state and all written in place, so the slot step's CUDA
graph (``graph.py``) reads them by address while the table's contents
change under it.

The host half is plain Python and numpy:

- :class:`PagePool`: a free list with per-page refcounts split into slot
  references (live requests) and one tree reference (the prefix cache).
  A page frees when both drop; tree-only pages are the eviction pool
  under pressure (LRU, leaf first).
- :class:`RadixPrefixTree`: one node per ``page_size``-token block of a
  registered prompt. An admitted prompt shares every matched block's page
  (refcount, no prefill, no copy); a partially matched tail block is the
  copy-on-write source: its page is gathered into the request's prefill
  cache (:func:`hydrate_cache`) and written to a fresh private page at
  insert, so the donor's page is never written.
- admission: a request's worst-case page need assumes no sharing, so one
  the pool can never hold sheds at submit with a typed
  :class:`~..resilience.guards.PagePoolExhausted`, and a transiently full
  pool defers the queue head until a retirement frees pages.

Pool page 0 is scratch: idle slots' table rows point there, and an insert
sends its shared entries there.

``truncate`` is speculation's rollback: a request retiring off a verify
step drops the pages past its committed extent before its release.

The KV tiers (``hostkv.py``, ``tiering.py``) plug in through two seams:
``host``, the store an admission consults right after the tree match (its
matched cold blocks are pinned, consumed at the commit point, released on
a defer, and ride on the :class:`PageAllocation` as ``restore_tiles``),
and ``on_demote``, called in an eviction pass with the evicted full-block
entries before their pages can be reused. The pool's ``clock`` stamps each
tree entry's last touch; :meth:`PagePool.demote_ahead_candidates` reads
those stamps to stage idle prefixes into the tier before pressure. Over
more than one rank, ``agree`` takes the world's least matched block count
before the commit point: each rank's tier holds its own KV heads, and one
rank's fallback must not give it another chunk plan than the others.

Left out, each with its ROADMAP.md item: ``residency`` (the fleet, item
6(c)); the ``on_evict`` / ``on_pages`` seams (observability, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..inference.decode import (GenCarry, PagedKVCache, cache_layout,
                                dequantize_kv, quantize_kv)
from ..observability.workload import extend_hash
from ..resilience.guards import PagePoolExhausted
from ..utils.roadmap import later

__all__ = ["PagePool", "RadixPrefixTree", "PageAllocation",
           "init_paged_slots", "insert_paged", "hydrate_cache",
           "PagePoolExhausted"]

_SCRATCH = 0        # reserved pool page: idle-slot / shared-entry sink


# ------------------------------------------------------------ device side
def init_paged_slots(cfg, slots: int, max_len: int, page_size: int,
                     pages: int, dtype=None, kv_quant_bits: int = 0, *,
                     device="cpu", kv_heads=None) -> GenCarry:
    """Empty paged slot state: every slot idle (``done``), its table row on
    scratch, length 0. A :class:`~..inference.decode.GenCarry` whose cache
    is a :class:`~..inference.decode.PagedKVCache`, so the slot step of
    the contiguous engine serves it as it is. ``kv_heads``: a
    tensor-parallel rank's, whose pool holds its KV heads only (a page's
    bytes fall by ``tp``); the host half (pool, radix tree, tables) is the
    same on every rank."""
    shape, dt = cache_layout(cfg, slots, max_len, dtype,
                             page_size=page_size, pages=pages,
                             kv_heads=kv_heads)
    k_scale = v_scale = None
    pool_dt = dt
    if kv_quant_bits == 8:
        pool_dt = torch.int8
        k_scale = torch.ones(shape[:-1], dtype=torch.float32, device=device)
        v_scale = torch.ones(shape[:-1], dtype=torch.float32, device=device)
    cache = PagedKVCache(
        k=torch.zeros(shape, dtype=pool_dt, device=device),
        v=torch.zeros(shape, dtype=pool_dt, device=device),
        k_scale=k_scale, v_scale=v_scale,
        page_table=torch.zeros((slots, max_len // page_size),
                               dtype=torch.int32, device=device),
        length=torch.zeros(slots, dtype=torch.int32, device=device))
    return GenCarry(tok=torch.zeros(slots, dtype=torch.long, device=device),
                    cache=cache,
                    rng=[torch.Generator(device=device) for _ in range(slots)],
                    done=torch.ones(slots, dtype=torch.bool, device=device))


def _page_split(buf, n: int, ps: int):
    """A batch-1 contiguous cache buffer (L, 1, KV, n*ps, hd) as per-page
    tiles (L, n, KV, ps, hd), a view (both layouts are position-major):
    writes through it land in the buffer."""
    L, _, KV, _, hd = buf.shape
    return buf[:, 0].reshape(L, KV, n, ps, hd).transpose(1, 2)


def insert_paged(state: GenCarry, slot: int, pf: GenCarry, page_row,
                 first_private: int) -> None:
    """Scatter a freshly prefilled request's batch-1 contiguous cache into
    its pool pages and seat its slot, in place.

    ``page_row`` is the slot's full (pages_per_slot,) table row;
    ``first_private`` the count of its leading SHARED pages, whose writes
    go to scratch: a shared page is never rewritten. Every PRIVATE page of
    the row is overwritten across its full extent, so no stale KV of an
    earlier request reaches this one. An int8 pool quantizes here, with
    the decode append's per-token, per-head scales."""
    c = state.cache
    n, ps = len(page_row), c.k.shape[3]
    tgt = torch.tensor(page_row, dtype=torch.long)
    tgt[:first_private] = _SCRATCH
    tgt = tgt.to(c.k.device)
    vk, vv = _page_split(pf.cache.k, n, ps), _page_split(pf.cache.v, n, ps)
    if c.k_scale is not None:
        qk, sk = quantize_kv(vk)
        qv, sv = quantize_kv(vv)
        c.k[:, tgt] = qk
        c.v[:, tgt] = qv
        c.k_scale[:, tgt] = sk
        c.v_scale[:, tgt] = sv
    else:
        c.k[:, tgt] = vk.to(c.k.dtype)
        c.v[:, tgt] = vv.to(c.v.dtype)
    c.length[slot].copy_(pf.cache.length.reshape(()))
    state.tok[slot].copy_(pf.tok[0])
    state.done[slot].copy_(pf.done[0])
    state.rng[slot] = pf.rng[0]


def hydrate_cache(state: GenCarry, cache, hydrate_row, count: int) -> None:
    """Fill the leading ``count`` pages of a batch-1 prefill cache from the
    pool, in place: the admission half of prefix sharing. The last of
    them may be a copy-on-write SOURCE (a donor's partially matched tail
    block): its bytes go through this cache to a fresh private page at
    insert. An int8 pool dequantizes here, so the suffix prefill runs in
    the compute dtype as an unshared request's does."""
    c = state.cache
    n, ps = len(hydrate_row), c.k.shape[3]
    idx = torch.as_tensor(np.asarray(hydrate_row)[:count],
                          dtype=torch.long).to(c.k.device)
    gk, gv = c.k[:, idx], c.v[:, idx]             # (L, count, KV, ps, hd)
    if c.k_scale is not None:
        gk = dequantize_kv(gk, c.k_scale[:, idx], cache.k.dtype)
        gv = dequantize_kv(gv, c.v_scale[:, idx], cache.v.dtype)
    _page_split(cache.k, n, ps)[:, :count] = gk.to(cache.k.dtype)
    _page_split(cache.v, n, ps)[:, :count] = gv.to(cache.v.dtype)


# -------------------------------------------------------------- host side
@dataclasses.dataclass
class PageAllocation:
    """One admitted request's page plan, from :meth:`PagePool.try_admit`,
    carried on its ``Request``.

    ``row`` is the full table row (shared ids, then private ids, then
    scratch); ``shared`` the leading shared-page count (the insert's
    ``first_private``); ``skip`` the prompt tokens the prefill lane does
    not recompute; ``hydrate_row`` / ``hydrate_pages`` the gather plan
    (``hydrate_pages`` may exceed ``shared`` by one: the copy-on-write
    source). ``restored`` counts the full blocks after the shared run that
    the KV tier serves (counted in ``skip``; their pages are ordinary
    private pages), ``restore_tiles`` their payload until the engine
    uploads it."""

    rid: int
    row: np.ndarray
    pages: int                  # live pages this request references
    shared: int                 # leading pages shared through the tree
    skip: int                   # prompt tokens served from the pool
    hydrate_row: np.ndarray
    hydrate_pages: int
    cow: bool = False           # a partially matched tail page was copied
    cow_src: Optional[int] = None   # donor page pinned until insert/abort
    registered: bool = False
    restored: int = 0
    restore_tiles: Optional[dict] = None
    restore_tokens: int = 0
    restore_bytes: int = 0


class _Node:
    """One radix-tree node: one ``page_size``-token block of a registered
    prompt and the pool page holding its KV. ``tails`` maps a trailing
    partial block (tokens) to its page: the copy-on-write sources.
    ``tstamp`` is the pool clock's time of the last touch (None without a
    clock); ``phash`` the rolling hash of the whole prefix through this
    block, the KV tier's key with its length; ``toks`` that prefix, built
    on first use (:meth:`prefix`)."""

    __slots__ = ("children", "tails", "page", "stamp", "tstamp", "parent",
                 "key", "phash", "toks")

    def __init__(self, parent=None, key=None, page: int = -1):
        self.children: dict = {}
        self.tails: dict = {}
        self.page = page
        self.stamp = 0
        self.tstamp: Optional[float] = None
        self.parent = parent
        self.key = key
        self.phash = 0 if parent is None else extend_hash(parent.phash, key)
        self.toks: Optional[tuple] = None if parent is not None else ()

    def prefix(self) -> tuple:
        """The whole token prefix through this block, one tuple kept for
        the node's life: the tier's entry holds this same object, so a
        membership check compares it by identity."""
        if self.toks is None:
            self.toks = self.parent.prefix() + self.key
        return self.toks


class RadixPrefixTree:
    """Host-side prefix index over registered prompt blocks.

    ``match`` walks an admitted prompt block by block, returning the
    shared page run and, optionally, a copy-on-write tail source;
    ``register`` adds an inserted request's blocks under its own private
    pages. Eviction is leaf-first LRU over entries the pool offers."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _Node()
        self._tick = 0
        # the pool stamps this before a walk (one clock read a match or
        # register, only when the pool has a clock)
        self.now: Optional[float] = None

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.stamp = self._tick
        if self.now is not None:
            node.tstamp = self.now

    def match(self, prompt: np.ndarray) -> tuple:
        """(shared page ids, cow (src_page, tail_len) or None)."""
        toks = np.asarray(prompt).reshape(-1)
        ps = self.page_size
        node, ids, i = self.root, [], 0
        while i + ps <= len(toks):
            child = node.children.get(tuple(toks[i:i + ps].tolist()))
            if child is None:
                break
            ids.append(child.page)
            self._touch(child)
            node, i = child, i + ps
        cow = None
        rest = tuple(toks[i:].tolist())
        for tail, page in node.tails.items():
            if len(tail) <= len(rest) and rest[:len(tail)] == tail \
                    and (cow is None or len(tail) > cow[1]):
                cow = (page, len(tail))
        return ids, cow

    def peek_blocks(self, toks: np.ndarray) -> int:
        """Leading full blocks of ``toks`` the tree holds, without touching
        an LRU stamp."""
        ps = self.page_size
        node, i, n = self.root, 0, 0
        while i + ps <= len(toks):
            child = node.children.get(tuple(toks[i:i + ps].tolist()))
            if child is None:
                break
            n += 1
            node, i = child, i + ps
        return n

    def register(self, prompt: np.ndarray, row: np.ndarray) -> list:
        """Index an inserted request's prompt: full blocks as child nodes,
        a trailing partial block as a tail entry. A block already present
        keeps its page (first writer wins; the duplicate stays private).
        Returns the page ids the tree newly references."""
        toks = np.asarray(prompt).reshape(-1)
        ps = self.page_size
        node, taken = self.root, []
        for b in range(len(toks) // ps):
            key = tuple(toks[b * ps:(b + 1) * ps].tolist())
            child = node.children.get(key)
            if child is None:
                child = node.children[key] = _Node(
                    parent=node, key=key, page=int(row[b]))
                taken.append(child.page)
            self._touch(child)
            node = child
        tail = tuple(toks[(len(toks) // ps) * ps:].tolist())
        if tail and tail not in node.tails:
            node.tails[tail] = int(row[len(toks) // ps])
            taken.append(node.tails[tail])
        return taken

    def evictable(self) -> list:
        """(stamp, kind, parent, key, page) of every leaf-evictable entry:
        tail entries and childless, tail-less nodes, oldest first."""
        out = []

        def walk(node):
            for tail, page in node.tails.items():
                out.append((node.stamp, "tail", node, tail, page))
            for key, child in node.children.items():
                if not child.children and not child.tails:
                    out.append((child.stamp, "node", node, key, child.page))
                else:
                    walk(child)

        walk(self.root)
        out.sort(key=lambda e: e[0])
        return out

    @staticmethod
    def drop(kind: str, parent: _Node, key) -> None:
        if kind == "tail":
            parent.tails.pop(key, None)
        else:
            parent.children.pop(key, None)

    @staticmethod
    def entry_tokens(node: _Node, key) -> tuple:
        """The full token prefix an entry caches: the blocks from the root
        down to ``node``, then ``key`` (a child block or a tail)."""
        child = node.children.get(key)
        if child is not None:
            return child.prefix()
        return node.prefix() + tuple(key)

    def oldest_entry_time(self) -> Optional[float]:
        """Touch time of the oldest evictable entry (None without a clock
        or an evictable entry), in one walk without a sort."""
        best = None

        def consider(n):
            nonlocal best
            if n.tstamp is not None and (best is None or n.tstamp < best):
                best = n.tstamp

        stack = [self.root]
        while stack:
            node = stack.pop()
            if node.tails:
                consider(node)
            for child in node.children.values():
                if not child.children and not child.tails:
                    consider(child)
                else:
                    stack.append(child)
        return best

    def __len__(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.tails) + len(node.children)
            stack.extend(node.children.values())
        return n


class PagePool:
    """Host allocator over the pool's page ids 1..pages-1 (page 0 is
    scratch): per page, slot references (live requests whose rows hold
    it) and one optional tree reference. A page returns to the free list
    when both drop. Every decision is host-side: no device work, no sync.
    ``clock`` (None: no reads) stamps each tree entry's last touch: the
    oldest entry's age in :meth:`snapshot`, and the idleness
    :meth:`demote_ahead_candidates` reads.
    """

    def __init__(self, pages: int, page_size: int, max_len: int,
                 registry=None, prefix_sharing: bool = True, clock=None):
        if pages < 2:
            raise ValueError(f"page pool needs >= 2 pages (one is "
                             f"reserved scratch), got {pages}")
        self.pages = pages
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        self.registry = registry
        self.clock = clock
        self.free: list[int] = list(range(pages - 1, 0, -1))  # pop() -> 1..
        self.slot_refs = np.zeros(pages, np.int64)
        self.tree_refs = np.zeros(pages, bool)
        self.tree: Optional[RadixPrefixTree] = \
            RadixPrefixTree(page_size) if prefix_sharing else None
        self._alloc: dict[int, PageAllocation] = {}   # rid -> allocation
        # bumped whenever admission prospects improve (pages freed, or new
        # prefixes registered): the scheduler's retry gate for a deferred
        # queue head
        self.generation = 0
        # the KV tier's seams (serving/hostkv.py): ``host`` is consulted
        # right after the tree match at admission; ``on_demote`` is called
        # in an eviction pass with the evicted full-block entries before
        # their pages can be reused. None: one `is not None` each
        self.host = None
        self.on_demote = None
        # over several ranks: n -> the world's least n (None: one rank)
        self.agree = None
        # cumulative accounting: ``evictions`` counts PAGES freed by
        # eviction, ``eviction_events`` the passes that freed any
        self.prefill_tokens_saved = 0
        self.prompt_tokens = 0
        self.shared_page_acquires = 0
        self.private_page_acquires = 0
        self.cow_copies = 0
        self.evictions = 0
        self.eviction_events = 0
        self.defers = 0
        self._publish()

    # the observability seams (ROADMAP.md queue 1 item 7): None, and
    # refused when set
    @property
    def on_evict(self):
        return None

    @on_evict.setter
    def on_evict(self, fn) -> None:
        if fn is not None:
            raise NotImplementedError(
                f"PagePool.on_evict is not ported yet: {later(7)}")

    @property
    def on_pages(self):
        return None

    @on_pages.setter
    def on_pages(self, fn) -> None:
        if fn is not None:
            raise NotImplementedError(
                f"PagePool.on_pages is not ported yet: {later(7)}")

    # ------------------------------------------------------------- metrics
    def _publish(self) -> None:
        if self.registry is None:
            return
        for name, v in (("Serve/page_pool_free", len(self.free)),
                        ("Serve/page_pool_used",
                         self.usable - len(self.free)),
                        ("Serve/page_pool_tree_held", self.tree_held),
                        ("Serve/page_prefix_hit_rate",
                         self.prefix_hit_rate)):
            self.registry.gauge(name).set(float(v))

    def _count(self, name: str, n: float = 1) -> None:
        if self.registry is not None:
            self.registry.counter(name).inc(n)

    @property
    def usable(self) -> int:
        return self.pages - 1

    @property
    def tree_held(self) -> int:
        """Pages retained ONLY by the prefix tree (evictable)."""
        return int(np.sum(self.tree_refs & (self.slot_refs == 0)))

    @property
    def prefix_hit_rate(self) -> float:
        total = self.shared_page_acquires + self.private_page_acquires
        return self.shared_page_acquires / total if total else 0.0

    def worst_case_pages(self, prompt_len: int, max_new: int) -> int:
        """Pages a request can need with NO sharing: the admission bound
        (shared pages can be evicted from under a queued request)."""
        return -(-(prompt_len + max_new - 1) // self.page_size)

    def check_submit(self, prompt_len: int, max_new: int) -> None:
        """Typed shed, at submit, of a request the pool can NEVER hold."""
        need = self.worst_case_pages(prompt_len, max_new)
        if need > self.usable:
            raise PagePoolExhausted(
                f"request needs up to {need} KV pages (prompt {prompt_len}"
                f" + max_new {max_new} @ page_size {self.page_size}) but "
                f"the pool holds {self.usable} — raise serving.pool_pages "
                "or shrink the request", pages_needed=need,
                pages_usable=self.usable)

    # ----------------------------------------------------------- admission
    def _evict(self, need: int) -> bool:
        """Free ``need`` pages by dropping LRU tree entries no slot uses.
        False when the tree cannot cover the shortfall."""
        if self.tree is None or need <= 0:
            return need <= 0
        freed = 0
        demote = [] if self.on_demote is not None else None
        while freed < need:
            # leaf-first passes: dropping a leaf can expose its parent, so
            # re-list until the need is met or a pass frees nothing
            progress = False
            for _stamp, kind, parent, key, page in self.tree.evictable():
                if freed >= need:
                    break
                if self.slot_refs[page] == 0 and self.tree_refs[page]:
                    if demote is not None and kind == "node":
                        # full blocks demote; partial tails stay
                        # recompute-only (block-grain keys)
                        demote.append({
                            "tokens": self.tree.entry_tokens(parent, key),
                            "page": int(page), "block": len(key)})
                    self.tree.drop(kind, parent, key)
                    self.tree_refs[page] = False
                    self.free.append(page)
                    self.evictions += 1
                    freed += 1
                    progress = True
            if not progress:
                break
        if freed:
            self.eviction_events += 1
            self._count("Serve/page_evictions", freed)
            self._count("Serve/page_eviction_events")
            if demote:
                # before the freed pages can be popped for reuse: the
                # engine enqueues the gather of their tiles here
                self.on_demote(demote)
        return freed >= need

    def demote_ahead_candidates(self, cutoff: float, limit: int,
                                skip=None) -> list:
        """Full-block tree entries last touched at or before ``cutoff``
        whose page no slot uses, oldest first, at most ``limit``, shaped as
        the ``on_demote`` payload: the demote-ahead lane's feed. Every
        block node of an idle chain qualifies (not only leaves). Read-only:
        the pages stay tree-held, and a resume keeps them as a tree hit
        (tree-held pages no slot uses are never written, so a staged copy
        cannot go stale). ``skip(tokens, key)`` filters entries already
        staged (``key``: the tier's ``(length, hash)``, cached on the node,
        so a step's walk hashes no prefix again). Needs the pool clock: an
        entry without a stamp never qualifies."""
        if self.tree is None or limit <= 0:
            return []
        cands: list = []

        def walk(node):
            for child in node.children.values():
                if (child.tstamp is not None and child.tstamp <= cutoff
                        and self.slot_refs[child.page] == 0
                        and self.tree_refs[child.page]):
                    cands.append((child.tstamp, child))
                walk(child)

        walk(self.tree.root)
        cands.sort(key=lambda c: c[0])
        out = []
        for _ts, child in cands:
            if len(out) >= limit:
                break
            toks = child.prefix()
            if skip is not None and skip(toks, (len(toks), child.phash)):
                continue
            out.append({"tokens": toks, "page": int(child.page),
                        "block": len(child.key)})
        return out

    def try_admit(self, prompt: np.ndarray, max_new: int,
                  rid: int) -> Optional[PageAllocation]:
        """Admission's page plan: match the prefix tree, take refs on the
        shared run, allocate private pages for the rest (evicting LRU
        tree-only pages under pressure). None: transiently full; the
        request stays at the queue head and retries after a release."""
        prompt = np.asarray(prompt).reshape(-1)
        P, ps, n = len(prompt), self.page_size, self.pages_per_slot
        if self.tree is not None and self.clock is not None:
            # one clock read an admission stamps every node the walk touches
            self.tree.now = self.clock()
        shared_ids, cow = (self.tree.match(prompt)
                           if self.tree is not None else ([], None))
        total_need = self.worst_case_pages(P, max_new)
        if total_need > n:
            # unreachable through the scheduler (P + max_new <= max_len):
            # a direct caller past the slot extent is a bug, not pressure
            raise ValueError(
                f"request needs {total_need} pages > pages_per_slot={n} "
                "(prompt + max_new exceeds max_len)")
        # a fully shared prompt still recomputes its last token (the first
        # output needs its logits), so skip stays below P
        shared = min(len(shared_ids), total_need)
        shared_ids = shared_ids[:shared]
        skip = shared * ps
        # the tier's restore plan: cold full blocks continuing the tree
        # match, pinned in the tier until this allocation commits
        # (consume) or defers (release)
        restore_keys: list = []
        if self.host is not None:
            restore_keys = self.host.match(prompt, start_block=shared,
                                           max_blocks=total_need - shared)
            if self.agree is not None:
                # every rank restores the run that every rank holds; the
                # rest stays restorable, and is recomputed here
                least = self.agree(len(restore_keys))
                if least < len(restore_keys):
                    self.host.release(restore_keys[least:])
                    restore_keys = restore_keys[:least]
        restored = len(restore_keys)
        skip += restored * ps
        # a restored block covers a copy-on-write tail at its position
        cow_src, cow_len = (cow if restored == 0 and cow is not None
                            and cow[1] > 0 and skip + cow[1] < P
                            else (None, 0))
        private_need = total_need - shared
        # pin the matched pages BEFORE any eviction pass: a tree-only page
        # about to be shared must not be reclaimed for this request
        for p in shared_ids:
            self.slot_refs[p] += 1
        if cow_src is not None:
            self.slot_refs[cow_src] += 1
        short = private_need - len(self.free)
        if short > 0 and not self._evict(short):
            for p in shared_ids:
                self._unref(p)
            if cow_src is not None:
                self._unref(cow_src)
            if restore_keys:
                # the cold blocks stay restorable for the retry
                self.host.release(restore_keys)
            self.defers += 1
            self._count("Serve/page_defers")
            return None
        private = [self.free.pop() for _ in range(private_need)]
        row = np.zeros(n, np.int32)
        row[:shared] = shared_ids
        row[shared:total_need] = private
        for p in private:
            self.slot_refs[p] += 1
        hyd = np.zeros(n, np.int32)
        hyd[:shared] = shared_ids
        hydrate_pages = shared
        if cow_src is not None:
            # the donor's partial tail block goes through the prefill
            # cache into this request's own page (pinned until insert)
            hyd[shared] = cow_src
            hydrate_pages = shared + 1
            skip += cow_len
            self.cow_copies += 1
            self._count("Serve/page_cow_copies")
        skip = min(skip, P - 1)
        tiles, rbytes, rtoks = None, 0, 0
        if restore_keys:
            # the commit point: the pinned copies move onto the allocation
            tiles, rbytes, rtoks = self.host.consume(restore_keys)
        alloc = PageAllocation(
            rid=rid, row=row, pages=total_need, shared=shared, skip=skip,
            hydrate_row=hyd, hydrate_pages=hydrate_pages,
            cow=cow_src is not None, cow_src=cow_src,
            restored=restored, restore_tiles=tiles,
            restore_tokens=rtoks, restore_bytes=rbytes)
        self._alloc[rid] = alloc
        self.prompt_tokens += P
        self.prefill_tokens_saved += skip
        self._count("Serve/page_prefill_tokens_saved", skip)
        self.shared_page_acquires += shared
        self.private_page_acquires += private_need
        if self.registry is not None:
            self.registry.histogram(
                "Serve/pages_per_request").observe(total_need)
        self._publish()
        return alloc

    # ---------------------------------------------------------- completion
    def on_inserted(self, rid: int, prompt: np.ndarray) -> None:
        """The request's prefill landed in the pool: register its prompt
        blocks in the tree (tree refs on its private pages) and release
        the copy-on-write source pin."""
        alloc = self._alloc.get(rid)
        if alloc is None or alloc.registered:
            return
        alloc.registered = True
        self._release_cow(alloc)
        if self.tree is not None:
            if self.clock is not None:
                self.tree.now = self.clock()
            for page in self.tree.register(np.asarray(prompt), alloc.row):
                self.tree_refs[page] = True
        self.generation += 1
        self._publish()

    def _release_cow(self, alloc: PageAllocation) -> None:
        if alloc.cow_src is not None:
            src, alloc.cow_src = alloc.cow_src, None
            self._unref(src)

    def _unref(self, page: int) -> None:
        self.slot_refs[page] -= 1
        if self.slot_refs[page] <= 0:
            self.slot_refs[page] = 0
            if not self.tree_refs[page]:
                self.free.append(page)

    def release(self, rid: int) -> None:
        """Every terminal path: drop the request's slot refs; a page with
        no tree reference returns to the free list at once."""
        alloc = self._alloc.pop(rid, None)
        if alloc is None:
            return
        self._release_cow(alloc)
        for page in alloc.row[:alloc.pages]:
            self._unref(int(page))
        self.generation += 1
        self._publish()

    def truncate(self, rid: int, new_tokens: int) -> int:
        """Rewind ``rid``'s live extent to ``new_tokens`` tokens, freeing
        the whole pages past the (kept, partly filled) tail block. The
        speculative lane calls it when a request retires off a verify step
        whose rejected drafts wrote past the committed length, before the
        ordinary release. It never rewinds below ``alloc.shared`` (tree
        pages are admission state); freed entries go through
        :meth:`_unref`, so a page the tree still holds stays resident; the
        row's freed entries point at scratch, so a stale device mirror of
        the row writes only page 0; ``generation`` bumps, so a deferred
        admission retries. Returns the pages freed (0 for a rewind within
        the tail block or an unknown ``rid``)."""
        alloc = self._alloc.get(rid)
        if alloc is None:
            return 0
        keep = -(-max(0, int(new_tokens)) // self.page_size)
        keep = min(alloc.pages, max(keep, alloc.shared))
        freed = alloc.pages - keep
        if freed <= 0:
            return 0
        for page in alloc.row[keep:alloc.pages]:
            self._unref(int(page))
        alloc.row[keep:alloc.pages] = _SCRATCH
        alloc.pages = keep
        self.generation += 1
        self._publish()
        return freed

    # -------------------------------------------------------------- readout
    def residency(self, prompt: np.ndarray) -> tuple:
        raise NotImplementedError(
            f"PagePool.residency (the fleet router's probe) is not ported "
            f"yet: {later(6, 'c')}")

    def snapshot(self) -> dict:
        """Pool occupancy, sharing and eviction pressure (the JAX
        package's keys), the oldest tree entry's age on the pool clock, and
        the KV tier's snapshot (None without a tier)."""
        used = self.usable - len(self.free)
        oldest_age = None
        if self.tree is not None and self.clock is not None:
            t = self.tree.oldest_entry_time()
            if t is not None:
                oldest_age = max(0.0, self.clock() - t)
        return {
            "pages": self.pages,
            "usable_pages": self.usable,
            "page_size": self.page_size,
            "pages_per_slot": self.pages_per_slot,
            "free_pages": len(self.free),
            "used_pages": used,
            "tree_held_pages": self.tree_held,
            "tree_entries": len(self.tree) if self.tree is not None else 0,
            # the share of the pool neither a slot nor the tree accounts
            # for (0: page granularity strands nothing)
            "fragmentation": max(0, used - self.tree_held - int(
                np.sum(self.slot_refs > 0))) / max(1, self.usable),
            "live_requests": len(self._alloc),
            "prompt_tokens": self.prompt_tokens,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "tokens_saved_fraction": (
                self.prefill_tokens_saved / self.prompt_tokens
                if self.prompt_tokens else 0.0),
            "shared_page_acquires": self.shared_page_acquires,
            "private_page_acquires": self.private_page_acquires,
            "prefix_hit_rate": self.prefix_hit_rate,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "pages_evicted": self.evictions,
            "eviction_events": self.eviction_events,
            "evictable_pages": self.tree_held,
            "oldest_tree_entry_age_s": oldest_age,
            "defers": self.defers,
            "prefix_sharing": self.tree is not None,
            "host_tier": (self.host.snapshot()
                          if self.host is not None else None),
        }
