"""The KV tiers' store discipline: ranked page stores under the paged pool
(counterpart of ``deepspeed_tpu/serving/tiering.py``).

- :class:`TierStore`: one rung, a bounded LRU store of full-block page
  payloads keyed by ``(prefix_len, token_hash)`` with the full token tuple
  kept for verification; a CRC of each payload's raw bytes decides whether
  a copy may be served (a corrupt, torn or lost copy is a counted fallback
  and the block is recomputed); the match -> consume / release handshake
  of an admission, with pins that pruning skips; the ``Serve/<kind>_*``
  metrics. Subclasses supply the payload transport only.
- :class:`~.hostkv.HostKVTier`: the host rung, tiles kept in host memory.
- :class:`NVMeKVTier`: the disk rung, one file per block written and read
  through :class:`~..ops.aio.AIOFileStore` (the native ``aio.cpp``).
- :class:`TieringEngine`: the coordinator the pool talks to when there are
  two rungs: puts land in the top store, its prune victims spill down,
  a match probes the rungs in rank order per block, and a consume gathers
  blocks from several rungs into one restore payload.

Everything here is host numpy and dicts. On the card the tiles are numpy
views of pinned torch tensors (bf16 viewed as ``int16``); the CRC covers
their raw bytes. ``zlib.crc32`` releases the GIL over a large buffer, so
:func:`tiles_crcs` checks several pages at once on a thread pool, the
engine's drain passes each put its page's CRC, a spill passes the CRC its
source entry just verified, the host rung checks an admission's
candidate blocks together before the match walks them, and the disk rung
reads them together, waits once and checks them together (the values and
the walk's outcomes are the JAX package's). A restore payload holds each
tile's list of per-block arrays, where the JAX package stacks them into
one ``(L, R, ...)`` array: the engine uploads each block from its own
pinned slot, with no host copy.
"""

from __future__ import annotations

import os
import tempfile
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np

from ..observability.workload import prefix_hashes, token_hash

__all__ = ["TierStore", "NVMeKVTier", "TieringEngine", "tiles_crc"]


def tiles_crc(tiles: dict) -> int:
    """CRC-32 over a page's raw bytes, chained in sorted tile-name order:
    equal to the CRC of the sorted-order concatenation, so the disk rung
    verifies its one flat file read against the same value."""
    h = 0
    for key in sorted(tiles):
        h = zlib.crc32(np.ascontiguousarray(tiles[key]), h)
    return h


_CRC_POOL: Optional[ThreadPoolExecutor] = None


def tiles_crcs(pages: list) -> list:
    """:func:`tiles_crc` of each page's tiles, several pages at once on a
    thread pool of up to 8 workers."""
    global _CRC_POOL
    if len(pages) < 2:
        return [tiles_crc(t) for t in pages]
    if _CRC_POOL is None:
        _CRC_POOL = ThreadPoolExecutor(min(8, os.cpu_count() or 1),
                                       thread_name_prefix="tiles_crc")
    return list(_CRC_POOL.map(tiles_crc, pages))


def _payload(ents: list) -> dict:
    """The restore payload of consumed entries: each tile's per-block
    arrays, in block order."""
    return {name: [e["tiles"][name] for e in ents]
            for name in ents[0]["tiles"]}


def _ahead(toks, page_size: int, start_block: int,
           max_blocks: Optional[int]) -> list:
    """The block keys a match walks: from ``start_block``, at most
    ``max_blocks`` of them."""
    keys = prefix_hashes(toks, page_size)[start_block:]
    return keys if max_blocks is None else keys[:max(0, max_blocks)]


def _held_run(ahead: list, stores: list) -> list:
    """Each store's share of the blocks a match may walk: the keys of
    ``ahead`` up to the first that no store holds, each given to the
    highest store that holds it (the one the walk probes first)."""
    out: list = [[] for _ in stores]
    for key in ahead:
        for got, st in zip(out, stores):
            if key in st.entries:
                got.append(key)
                break
        else:
            break
    return out


class TierStore:
    """One rung of the KV hierarchy: a bounded LRU store of full-block page
    payloads keyed by ``(prefix_len, prefix_hash)``.

    Subclasses implement the payload transport: ``_attach(key, ent,
    tiles)`` keeps a page's tiles on ``ent``; ``_verify(ent)`` gives them
    back integrity-checked, or None for a corrupt, torn or missing copy;
    ``_unfetch(ent)`` drops fetch-side staging when an admission defers;
    ``_discard(ent)`` cleans up when an entry leaves the store, keeping
    fetched tiles for the consumer. ``kind`` prefixes the metrics:
    ``Serve/<kind>_*``. ``owner`` bills a put's bytes to a tenant in
    ``owner_bytes`` (the port's engine passes None: tenants are ROADMAP.md
    queue 1 item 7)."""

    kind = "tier"

    def __init__(self, capacity_bytes: int, page_size: int,
                 registry=None, clock: Optional[Callable] = None):
        if capacity_bytes < 1:
            raise ValueError(f"{self.kind} capacity_bytes must be >= 1, "
                             f"got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.page_size = int(page_size)
        self.registry = registry
        self.clock = clock if clock is not None else (lambda: 0.0)
        self.entries: OrderedDict = OrderedDict()
        self.bytes_used = 0
        self.owner_bytes: dict = {}
        # the rung below (wired by TieringEngine): prune victims spill there
        self.spill_to: Optional["TierStore"] = None
        self.demotes = 0            # pages demoted into the tier
        self.demote_bytes = 0
        self.demote_skips = 0       # pages too large for the whole budget
        self.restores = 0           # restore operations (one an admission)
        self.restored_pages = 0
        self.restored_tokens = 0
        self.restore_bytes = 0
        self.restore_wait_s = 0.0   # summed dispatch wall of all restores
        self.hits = 0               # blocks served from the tier
        self.misses = 0             # continuation probes that found nothing
        self.prunes = 0             # entries LRU-dropped for capacity
        self.pruned_bytes = 0
        self.spills = 0             # prune victims handed to the rung below
        self.fallbacks = 0          # corrupt / mismatched copies: recompute
        self._publish()

    # ---------------------------------------------------- payload transport
    def _attach(self, key, ent: dict, tiles: dict) -> None:
        raise NotImplementedError

    def _verify(self, ent: dict):
        raise NotImplementedError

    def _unfetch(self, ent: dict) -> None:
        pass

    def _discard(self, ent: dict) -> None:
        pass

    def _precheck(self, keys: list) -> None:
        """Before a match walks ``keys``: a rung may verify the payloads of
        the entries it holds there at once (``_verify`` then reads the
        result); ``_unprecheck`` drops what the walk did not read."""

    def _unprecheck(self, keys: list) -> None:
        pass

    # ------------------------------------------------------------- metrics
    def _publish(self) -> None:
        if self.registry is None:
            return
        self.registry.set_gauges({
            f"Serve/{self.kind}_pages": float(len(self.entries)),
            f"Serve/{self.kind}_bytes": float(self.bytes_used),
            f"Serve/{self.kind}_capacity_bytes": float(self.capacity_bytes),
            f"Serve/{self.kind}_occupancy": (
                self.bytes_used / self.capacity_bytes),
            f"Serve/{self.kind}_pressure": float(self.pressure),
        })

    def _count(self, name: str, n: int = 1) -> None:
        if self.registry is not None and n:
            self.registry.counter(name).inc(n)

    def _owner_delta(self, owner, nbytes: int) -> None:
        if owner is None:
            return
        b = self.owner_bytes.get(owner, 0) + int(nbytes)
        if b <= 0:
            self.owner_bytes.pop(owner, None)
        else:
            self.owner_bytes[owner] = b

    @property
    def pressure(self) -> bool:
        """True when another typical page does not fit without a prune."""
        if not self.entries:
            return False
        mean = self.bytes_used / len(self.entries)
        return self.capacity_bytes - self.bytes_used < mean

    # ------------------------------------------------------------- demotion
    def put(self, tokens, tiles: dict, owner=None, crc=None) -> bool:
        """Store one demoted page: ``tokens`` is the full token prefix the
        tree entry cached (its identity), ``tiles`` the page's host arrays,
        ``crc`` their :func:`tiles_crc` where the caller has it. A put over
        budget prunes LRU unpinned entries; a page larger than the whole
        budget is skipped and counted. Returns whether the page was
        kept."""
        toks = tokens if isinstance(tokens, tuple) else tuple(
            int(t) for t in np.asarray(tokens).reshape(-1))
        nbytes = sum(int(v.nbytes) for v in tiles.values())
        if nbytes > self.capacity_bytes:
            self.demote_skips += 1
            self._count(f"Serve/{self.kind}_demote_skips")
            return False
        key = (len(toks), token_hash(toks))
        old = self.entries.get(key)
        if old is not None:
            if old["pinned"]:
                # an admission in flight pinned this key (its own eviction
                # pass runs between match and consume): keep it
                self.demote_skips += 1
                self._count(f"Serve/{self.kind}_demote_skips")
                return False
            self.entries.pop(key)
            self.bytes_used -= old["nbytes"]
            self._owner_delta(old.get("owner"), -old["nbytes"])
            self._discard(old)
        ent = {
            "tokens": toks, "tiles": None, "nbytes": nbytes,
            "crc": tiles_crc(tiles) if crc is None else crc,
            "t": self.clock(), "pinned": False,
            "owner": owner,
        }
        self._attach(key, ent, tiles)
        self.entries[key] = ent
        self.bytes_used += nbytes
        self._owner_delta(owner, nbytes)
        self.demotes += 1
        self.demote_bytes += nbytes
        self._count(f"Serve/{self.kind}_demotes")
        self._count(f"Serve/{self.kind}_demote_bytes", nbytes)
        self._prune()
        self._publish()
        return True

    def holds(self, tokens, key=None) -> bool:
        """Exact membership (key and tokens, no payload touch); ``key``
        skips the hash when the caller has it, a tuple of ints the
        conversion."""
        toks = tokens if isinstance(tokens, tuple) else tuple(
            int(t) for t in np.asarray(tokens).reshape(-1))
        if key is None:
            key = (len(toks), token_hash(toks))
        ent = self.entries.get(key)
        return ent is not None and (ent["tokens"] is toks
                                    or ent["tokens"] == toks)

    def _prune(self) -> None:
        """LRU-drop unpinned entries until the budget holds; with a rung
        below, each victim that still verifies spills down."""
        while self.bytes_used > self.capacity_bytes:
            victim = None
            for key, ent in self.entries.items():
                if not ent["pinned"]:
                    victim = key
                    break
            if victim is None:
                return
            ent = self.entries.pop(victim)
            self.bytes_used -= ent["nbytes"]
            self._owner_delta(ent.get("owner"), -ent["nbytes"])
            self.prunes += 1
            self.pruned_bytes += ent["nbytes"]
            self._count(f"Serve/{self.kind}_prunes")
            if self.spill_to is not None:
                tiles = self._verify(ent)
                if tiles is not None and self.spill_to.put(
                        ent["tokens"], tiles, owner=ent.get("owner"),
                        crc=ent["crc"]):
                    self.spills += 1
                    self._count(f"Serve/{self.kind}_spills")
            self._discard(ent)

    # -------------------------------------------------------------- restore
    def _tail_mismatch(self, ent: dict, toks, length: int) -> bool:
        """Exact check of the entry's own block (its last ``page_size``
        tokens) against the prompt; the earlier blocks are covered by the
        tree match and the hits before this one."""
        ps = self.page_size
        return ent["tokens"][length - ps:] != tuple(
            int(t) for t in toks[length - ps:length])

    def match_one(self, key, toks, length: int) -> str:
        """Probe one block key: ``"hit"`` pins the entry (payload verified,
        tiles staged); ``"absent"`` / ``"collision"`` are misses;
        ``"corrupt"`` drops the entry and counts a fallback."""
        ent = self.entries.get(key)
        if ent is None:
            return "absent"
        if self._tail_mismatch(ent, toks, length):
            return "collision"
        if self._verify(ent) is None:
            self.entries.pop(key, None)
            self.bytes_used -= ent["nbytes"]
            self._owner_delta(ent.get("owner"), -ent["nbytes"])
            self.fallbacks += 1
            self._count(f"Serve/{self.kind}_fallbacks")
            self._discard(ent)
            self._publish()
            return "corrupt"
        ent["pinned"] = True
        self.entries.move_to_end(key)
        return "hit"

    def peek_one(self, key, toks, length: int) -> bool:
        """Read-only residency probe of one block (no pin, no LRU touch,
        no payload check)."""
        ent = self.entries.get(key)
        return ent is not None and not self._tail_mismatch(ent, toks,
                                                           length)

    def match(self, prompt, start_block: int,
              max_blocks: Optional[int] = None) -> list:
        """The consecutive full blocks past a tree match that this rung
        holds: each verified and pinned, keys in block order; the first
        gap ends the run."""
        toks = np.asarray(prompt).reshape(-1)
        keys: list = []
        if not self.entries:
            return keys
        ahead = _ahead(toks, self.page_size, start_block, max_blocks)
        run = _held_run(ahead, [self])[0]
        self._precheck(run)
        try:
            for length, h in ahead:
                r = self.match_one((length, h), toks, length)
                if r == "hit":
                    keys.append((length, h))
                    continue
                if r == "collision" or (r == "absent"
                                        and length == ahead[0][0]):
                    self.misses += 1
                    self._count(f"Serve/{self.kind}_misses")
                break
        finally:
            self._unprecheck(run)
        return keys

    def peek_blocks(self, prompt, start_block: int) -> int:
        """How many consecutive full blocks past ``start_block`` this rung
        holds; read-only."""
        if not self.entries:
            return 0
        toks = np.asarray(prompt).reshape(-1)
        n = 0
        for b, (length, h) in enumerate(prefix_hashes(toks,
                                                      self.page_size)):
            if b < start_block:
                continue
            if not self.peek_one((length, h), toks, length):
                break
            n += 1
        return n

    def _pop(self, key) -> dict:
        """Pop one pinned match for consumption; its verified tiles ride
        out on the returned entry."""
        ent = self.entries.pop(key)
        self.bytes_used -= ent["nbytes"]
        self._owner_delta(ent.get("owner"), -ent["nbytes"])
        self.hits += 1
        self._count(f"Serve/{self.kind}_hits")
        self._discard(ent)
        return ent

    def consume(self, keys: list) -> tuple:
        """Pop one admission's pinned matches into its restore payload
        (``{name: [block tile, ...]}``, block order). Returns ``(tiles,
        nbytes, tokens)``."""
        ents = [self._pop(k) for k in keys]
        nbytes = sum(e["nbytes"] for e in ents)
        tiles = _payload(ents)
        self._publish()
        return tiles, nbytes, len(ents) * self.page_size

    def release(self, keys: list) -> None:
        """Unpin matches without consuming them (the admission deferred);
        they stay restorable for the retry."""
        for k in keys:
            ent = self.entries.get(k)
            if ent is not None:
                ent["pinned"] = False
                self._unfetch(ent)

    def on_restore(self, wall_s: float, pages: int, tokens: int,
                   nbytes: int) -> None:
        """Account one dispatched restore (the engine's host window)."""
        self.restores += 1
        self.restored_pages += pages
        self.restored_tokens += tokens
        self.restore_bytes += nbytes
        self.restore_wait_s += wall_s
        self._count(f"Serve/{self.kind}_restores")
        self._count(f"Serve/{self.kind}_restored_pages", pages)
        self._count(f"Serve/{self.kind}_restored_tokens", tokens)
        self._count(f"Serve/{self.kind}_restore_bytes", nbytes)
        if self.registry is not None:
            self.registry.histogram(
                f"Serve/{self.kind}_restore_wait_s").observe(wall_s)
        self._publish()

    # -------------------------------------------------------------- readout
    def _snapshot_extra(self) -> dict:
        return {}

    def snapshot(self) -> dict:
        self._publish()
        out = {
            "pages": len(self.entries),
            "bytes": self.bytes_used,
            "capacity_bytes": self.capacity_bytes,
            "occupancy": self.bytes_used / self.capacity_bytes,
            "pressure": self.pressure,
            "page_size": self.page_size,
            "demotes": self.demotes,
            "demote_bytes": self.demote_bytes,
            "demote_skips": self.demote_skips,
            "restores": self.restores,
            "restored_pages": self.restored_pages,
            "restored_tokens": self.restored_tokens,
            "restore_bytes": self.restore_bytes,
            "restore_wait_s": self.restore_wait_s,
            "restore_tokens_per_s": (
                self.restored_tokens / self.restore_wait_s
                if self.restore_wait_s > 0 else None),
            "hits": self.hits,
            "misses": self.misses,
            "prunes": self.prunes,
            "pruned_bytes": self.pruned_bytes,
            "spills": self.spills,
            "fallbacks": self.fallbacks,
            "owner_bytes": dict(self.owner_bytes),
        }
        out.update(self._snapshot_extra())
        return out


def _numpy_bytes(nbytes: int, zero: bool) -> np.ndarray:
    return (np.zeros if zero else np.empty)(nbytes, np.uint8)


class NVMeKVTier(TierStore):
    """The disk rung: one file per block under an
    :class:`~..ops.aio.AIOFileStore`.

    - ``put`` serializes the page's tiles into one flat buffer (sorted
      tile-name order, so the file's CRC is :func:`tiles_crc`) and submits
      an async write; ``write_behind`` bounds the writes in flight, each
      buffer kept until its ticket is waited. Dtypes and shapes stay in
      host memory.
    - ``match`` reads the files of the blocks it may walk into zeroed
      staging buffers, all submitted at once and waited once, checks
      their CRCs together (a torn file fails the CRC) and hands the tiles
      back as views; an I/O error or a CRC mismatch is a counted
      fallback.
    - each tier owns a fresh subdirectory under ``path`` (default
      ``$TMPDIR/dstpu_kv_nvme``).

    ``buffer(nbytes, zero)`` makes the write and staging buffers (uint8
    numpy arrays); the engine gives pinned, page-aligned ones, which
    ``O_DIRECT`` (``use_direct``) needs and the restore's upload reads
    asynchronously."""

    kind = "nvme_tier"

    def __init__(self, capacity_bytes: int, page_size: int,
                 path: Optional[str] = None, registry=None,
                 clock: Optional[Callable] = None, n_threads: int = 2,
                 write_behind: int = 1, use_direct: bool = False,
                 buffer: Callable = _numpy_bytes):
        from ..ops import aio as aio_mod
        root = path or os.path.join(tempfile.gettempdir(), "dstpu_kv_nvme")
        os.makedirs(root, exist_ok=True)
        self.dir = tempfile.mkdtemp(prefix="kv_", dir=root)
        self.store = aio_mod.AIOFileStore(self.dir, n_threads=n_threads,
                                          use_direct=use_direct)
        self.buffer = buffer
        self.write_behind = max(0, int(write_behind))
        self._pending: List[dict] = []   # entries with writes in flight
        self.promotions = 0              # blocks read back (disk -> host)
        self.read_bytes = 0
        self.read_wait_s = 0.0
        self.write_bytes = 0
        super().__init__(capacity_bytes, page_size, registry=registry,
                         clock=clock)

    # ---------------------------------------------------- payload transport
    @staticmethod
    def _file(key) -> str:
        return f"b{key[0]}_{key[1]:016x}.bin"

    def _attach(self, key, ent: dict, tiles: dict) -> None:
        specs, arrs, off = [], [], 0
        for name in sorted(tiles):
            a = np.ascontiguousarray(tiles[name])
            specs.append((name, a.dtype, a.shape, off, int(a.nbytes)))
            arrs.append(a)
            off += int(a.nbytes)
        buf = self.buffer(off, False)
        for (name, dt, shp, o, nb), a in zip(specs, arrs):
            buf[o:o + nb] = a.view(np.uint8).reshape(-1)
        ent["file"] = self._file(key)
        ent["specs"] = specs
        ent["buf"] = buf   # outlives the async write: the library holds
        #                    its pointer until the ticket is waited
        try:
            ent["ticket"] = self.store.submit_write(ent["file"], buf)
        except OSError:
            # the store counted it; no ticket: the read misses the file and
            # the block is recomputed
            ent.pop("buf", None)
            return
        self.write_bytes += int(buf.nbytes)
        self._count(f"Serve/{self.kind}_write_bytes", int(buf.nbytes))
        self._pending.append(ent)
        self._settle(self.write_behind)

    def _settle_ent(self, ent: dict) -> None:
        t = ent.pop("ticket", None)
        if t is not None:
            try:
                self.store.wait(t)
            except OSError:
                pass   # counted by the store; the read path verifies
        ent.pop("buf", None)

    def _settle(self, keep: int) -> None:
        while len(self._pending) > keep:
            self._settle_ent(self._pending.pop(0))

    def flush(self) -> None:
        """Wait out every write in flight."""
        self._settle(0)

    def _precheck(self, keys: list) -> None:
        """Submit the reads of the blocks of ``keys`` this rung holds, all
        at once. The walk's first ``_verify`` waits for them together and
        checks their CRCs together on the CRC threads (``_land``); the
        later ones find their result landed. The library reports a failed
        transfer at the next wait, so a failure may be pinned on another
        block of the batch: that block falls back instead, and the CRC
        still guards every byte served."""
        batch: dict = {"ents": [], "landed": False}
        for key in keys:
            ent = self.entries.get(key)
            if ent is None or ent.get("tiles") is not None \
                    or "fetch" in ent:
                continue
            if "ticket" in ent or "buf" in ent:
                self._pending = [p for p in self._pending if p is not ent]
                self._settle_ent(ent)
            if "file" not in ent:
                continue
            buf = self.buffer(ent["nbytes"], True)
            try:
                ticket = self.store.submit_read(ent["file"], buf)
            except OSError:
                ticket = None
            ent["fetch"] = {"ticket": ticket, "buf": buf, "batch": batch,
                            "io": ticket is not None, "crc_ok": False}
            batch["ents"].append(ent)

    def _unprecheck(self, keys: list) -> None:
        for ent in map(self.entries.get, keys):
            if ent is not None:
                self._drop_fetch(ent)

    def _drop_fetch(self, ent: dict) -> None:
        """Wait out a submitted read the walk did not take (the library
        holds its buffer's pointer until then)."""
        fetch = ent.pop("fetch", None)
        if fetch is not None and fetch["ticket"] is not None:
            try:
                self.store.wait(fetch["ticket"])
            except OSError:
                pass   # counted by the store

    def _land(self, batch: dict) -> None:
        """Wait a batch's reads in submission order, then check the CRCs
        of those that landed, several at once."""
        batch["landed"] = True
        good = []
        for ent in batch["ents"]:
            f = ent.get("fetch")
            if f is None or f["batch"] is not batch:
                continue   # dropped with its entry, its read waited then
            if f["ticket"] is not None:
                try:
                    self.store.wait(f["ticket"])
                except OSError:
                    f["io"] = False
                f["ticket"] = None
            if f["io"]:
                good.append(ent)
        crcs = tiles_crcs([{"": e["fetch"]["buf"]} for e in good])
        for ent, crc in zip(good, crcs):
            ent["fetch"]["crc_ok"] = crc == ent["crc"]

    def _read(self, ent: dict) -> tuple:
        """``(buf, wall, crc_ok)``: the entry's file in a fresh zeroed
        buffer (None for an I/O error), the wait's wall and whether the
        CRC held; from the batch ``_precheck`` submitted, or a read of its
        own. A batch's first read carries the whole batch's wall."""
        fetch = ent.get("fetch")
        if fetch is None:
            buf = self.buffer(ent["nbytes"], True)
            t0 = self.clock()
            try:
                self.store.sync_read(ent["file"], buf)
            except OSError:
                return None, 0.0, False
            wall = max(0.0, self.clock() - t0)
            return buf, wall, zlib.crc32(buf) == ent["crc"]
        t0 = self.clock()
        if not fetch["batch"]["landed"]:
            self._land(fetch["batch"])
        ent.pop("fetch")
        if not fetch["io"]:
            return None, 0.0, False
        return fetch["buf"], max(0.0, self.clock() - t0), fetch["crc_ok"]

    def _verify(self, ent: dict):
        tiles = ent.get("tiles")
        if tiles is not None:
            return tiles
        if "ticket" in ent or "buf" in ent:
            self._pending = [p for p in self._pending if p is not ent]
            self._settle_ent(ent)
        if "file" not in ent:
            return None
        buf, wall, crc_ok = self._read(ent)
        if buf is None or not crc_ok:
            return None
        tiles = {name: buf[off:off + nb].view(dt).reshape(shp)
                 for name, dt, shp, off, nb in ent["specs"]}
        ent["tiles"] = tiles
        self.promotions += 1
        self.read_bytes += int(ent["nbytes"])
        self.read_wait_s += wall
        self._count(f"Serve/{self.kind}_promotions")
        self._count(f"Serve/{self.kind}_read_bytes", int(ent["nbytes"]))
        return tiles

    def _unfetch(self, ent: dict) -> None:
        ent["tiles"] = None   # drop the staged read; the file remains

    def _discard(self, ent: dict) -> None:
        self._pending = [p for p in self._pending if p is not ent]
        self._settle_ent(ent)
        self._drop_fetch(ent)
        f = ent.pop("file", None)
        if f is not None:
            self.store.unlink(f)

    # ------------------------------------------------------------- metrics
    def _publish(self) -> None:
        super()._publish()
        if self.registry is not None:
            self.registry.set_gauges({
                "Serve/nvme_aio_errors": float(self.store.errors),
            })

    def _snapshot_extra(self) -> dict:
        return {
            "promotions": self.promotions,
            "read_bytes": self.read_bytes,
            "read_wait_s": self.read_wait_s,
            "read_mb_s": (self.read_bytes / self.read_wait_s / 1e6
                          if self.read_wait_s > 0 and self.read_bytes
                          else None),
            "write_bytes": self.write_bytes,
            "pending_writes": len(self._pending),
            "aio_errors": self.store.errors,
            "native_aio": True,
            "o_direct": self.store.aio.o_direct(),
        }

    def close(self) -> None:
        self.flush()
        self.store.close()


class TieringEngine:
    """The ranked-store coordinator, speaking the pool's ``host`` protocol
    (put / match / peek_blocks / consume / release / on_restore / holds /
    snapshot): puts land in the top rung, whose prune spills down; a
    match probes the rungs in rank order per block (keys ``(rank,
    store_key)``); a consume gathers mixed-rung blocks into one payload."""

    def __init__(self, stores: List[TierStore]):
        if not stores:
            raise ValueError("TieringEngine needs at least one store")
        self.stores = list(stores)
        for up, down in zip(self.stores, self.stores[1:]):
            up.spill_to = down
        self.page_size = self.stores[0].page_size

    @property
    def pressure(self) -> bool:
        return self.stores[0].pressure

    def put(self, tokens, tiles: dict, owner=None, crc=None) -> bool:
        return self.stores[0].put(tokens, tiles, owner=owner, crc=crc)

    def holds(self, tokens, key=None) -> bool:
        return any(st.holds(tokens, key=key) for st in self.stores)

    def match(self, prompt, start_block: int,
              max_blocks: Optional[int] = None) -> list:
        toks = np.asarray(prompt).reshape(-1)
        keys: list = []
        if not any(st.entries for st in self.stores):
            return keys
        ahead = _ahead(toks, self.page_size, start_block, max_blocks)
        runs = _held_run(ahead, self.stores)
        for st, run in zip(self.stores, runs):
            st._precheck(run)
        try:
            for length, h in ahead:
                hit_rank = None
                for rank, st in enumerate(self.stores):
                    if st.match_one((length, h), toks, length) == "hit":
                        hit_rank = rank
                        break
                if hit_rank is None:
                    if length == ahead[0][0]:
                        top = self.stores[0]
                        top.misses += 1
                        top._count(f"Serve/{top.kind}_misses")
                    break
                keys.append((hit_rank, (length, h)))
        finally:
            for st, run in zip(self.stores, runs):
                st._unprecheck(run)
        return keys

    def peek_blocks(self, prompt, start_block: int) -> int:
        if not any(st.entries for st in self.stores):
            return 0
        toks = np.asarray(prompt).reshape(-1)
        n = 0
        for b, (length, h) in enumerate(prefix_hashes(toks,
                                                      self.page_size)):
            if b < start_block:
                continue
            if not any(st.peek_one((length, h), toks, length)
                       for st in self.stores):
                break
            n += 1
        return n

    def consume(self, keys: list) -> tuple:
        ents = [self.stores[rank]._pop(key) for rank, key in keys]
        nbytes = sum(e["nbytes"] for e in ents)
        tiles = _payload(ents)
        for st in self.stores:
            st._publish()
        return tiles, nbytes, len(ents) * self.page_size

    def release(self, keys: list) -> None:
        for rank, key in keys:
            self.stores[rank].release([key])

    def on_restore(self, wall_s: float, pages: int, tokens: int,
                   nbytes: int) -> None:
        self.stores[0].on_restore(wall_s, pages, tokens, nbytes)

    def snapshot(self) -> dict:
        """The top rung's snapshot, each lower rung nested under its
        ``kind``."""
        out = self.stores[0].snapshot()
        for st in self.stores[1:]:
            out[st.kind] = st.snapshot()
        return out
