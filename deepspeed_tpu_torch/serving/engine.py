"""ServingEngine: continuous batching over contiguous KV slots or the
paged KV pool.

Counterpart of ``deepspeed_tpu/serving/engine.py`` (the fleet seams, the
observability hooks (``workload.on_spec`` among them) and the chaos key
are ROADMAP.md queue 1 items 6(c), 7 and 8, and their config keys raise).
The engine owns:

- a slot state (``slots.py``): ONE persistent (L, slots, KV, max_len, hd)
  KV cache plus per-slot length / tok / done and a generator per slot,
  advanced by one slot decode step whichever requests occupy it; or, with
  ``page_size`` > 0, the paged state (``pages.py``): (L, pages, KV,
  page_size, hd) pools, int8 with ``kv_quant_bits`` 8, a (slots,
  pages_per_slot) page table mirrored from the host's, and the host's
  :class:`~.pages.PagePool` with its radix prefix tree;
- a prefill lane: per-request chunked prefill, eager, one bucket-shaped
  chunk per iteration into a batch-1 cache of ``max_len``, so a long prompt
  never stalls the running requests for more than a chunk;
- an insert that copies a finished prefill into its slot in place (paged:
  scatters it into its private pages, after a shared prefix was hydrated
  into the prefill cache at admission).

On the card the forward half of the slot step is one CUDA graph
(``graph.py``), captured once after an eager warm-up step and replayed
every iteration; ``captures`` counts captures as the JAX engine's
``compiles`` counts its program builds, and stays at 1. Sampling runs
eagerly after the replay, from each slot's own generator. The paged
table is a static tensor of the state: ``_flush_table`` writes the host
table into it with ``copy_`` on the replay's stream, never rebinding it,
so the next replay reads the new rows.

With ``speculation`` (greedy only, dense cache attention: ``flash_decode``
off) the decode lane drafts up to ``max_draft`` tokens a slot from an
n-gram table over the request's own history (``_spec_plan``), runs every
slot's carry token and drafts through one fixed-shape verify forward (on
the card a second CUDA graph over the same state, ``verify_captures``
stays at 1 whatever the drafts accepted), reads the winners and the logit
guard back in one transfer, accepts on the host and commits each slot's
length, token and done flag from one uploaded (4, slots) buffer
(``_spec_verify_commit``). A step with no draft anywhere, or a slot
without the verify's headroom, takes the plain step. Greedy tokens equal
the plain lane's.

With ``host_pool_bytes`` (paged only) the pool's eviction demotes the
freed full blocks into a host tier (``hostkv.py``), with
``nvme_pool_bytes`` a disk rung under it (``tiering.py``), and an
admission restores a matched cold prefix from there instead of
recomputing it. The demote gather is enqueued on the current stream inside
the eviction pass, before any later insert or replay can rewrite the freed
pages; its device-to-host copy runs on a side stream into pinned memory
behind a CUDA event, and ``_drain_demotes`` waits on that event and puts
the pages into the tier at the end of ``step()``, off the admission path.
A restore uploads the pinned tiles on the side stream in at most two
batches (the second's upload overlaps the first's write into the prefill
cache). With ``demote_ahead_idle_s`` the end of each step also stages
idle tree-held blocks into the tier (``_demote_ahead_tick``), so a later
eviction of them frees without a copy. None of this runs inside the slot
graph: ``captures`` stays 1.

Under ``tensor_parallel`` / ``expert_parallel`` every rank runs its own
engine on the same submissions: the same scheduler, pool and page tables
(host, deterministic), its shard of the model and its KV heads on its
card, and the slot step's collectives (captured in its graph); the logits
are all-gathered before sampling, so every rank's seeded sampler draws
the same token. Deadlines and demote-ahead read each rank's own clock,
so a world above one takes neither. Each rank's tier holds its own KV
heads; an admission restores the block run that every rank matched (a
MIN all-reduce, ``PagePool.agree``), so a fallback on one rank recomputes
on all and the ranks keep one chunk plan.

A request's tokens equal a solo ``generate(prompt[None], max_new,
request_seeds=[seed], cache_len=max_len)`` with the same sampling knobs:
its generator is seeded from its request seed (never from its slot), the
slot step runs the two halves of the ``decode_step`` that ``generate()``
runs, and the chunked prefill writes what a whole prefill writes.
"""

from __future__ import annotations

import math
import time
from collections import OrderedDict
from contextlib import nullcontext
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..comm import comm
from ..inference.config import ServingConfig
from ..inference.decode import (GenCarry, KVCache, decode_forward,
                                decode_sample, finite_rows,
                                forward_with_cache, init_cache, layout_of)
from ..inference.sampling import per_request_generators, sample_logits
from ..inference.speculation import NGramTable
from ..observability.tracing import ServingStats
from ..observability.workload import token_hash
from ..resilience.guards import QueueFullError, RequestStatus
from ..utils.logging import warning_once
from ..utils.roadmap import later
from .graph import SlotGraph
from .hostkv import HostKVTier, PinnedPages, demote_rows, restore_into_cache
from .pages import PagePool, hydrate_cache, init_paged_slots, insert_paged
from .tiering import NVMeKVTier, TieringEngine, tiles_crcs
from .scheduler import Request, Scheduler
from .slots import init_slots, insert_request

# Finished requests retained for pop_result(); a long-running server that
# never collects results must not grow host memory without bound.
_MAX_RESULTS = 4096


def expand_per_request(v, n: int, default, coerce=None) -> list:
    """One scalar-or-per-request ``serve_batch`` argument expanded to
    ``n`` values; ``coerce`` (e.g. ``int``) applies to every non-None
    value."""
    if v is None:
        vals = [default] * n
    elif isinstance(v, (list, tuple, np.ndarray)):
        if len(v) != n:
            raise ValueError(f"expected {n} per-request values, "
                             f"got {len(v)}")
        vals = list(v)
    else:
        vals = [v] * n
    if coerce is not None:
        vals = [x if x is None else coerce(x) for x in vals]
    return vals


class ServingEngine:
    """submit()/step()/drain() continuous batching on an InferenceEngine.

    ``engine`` supplies params, model, dtype, device, quantization and eos;
    ``serving`` (a :class:`~..inference.config.ServingConfig` or dict,
    default ``engine.config.serving``) supplies slots / max_len /
    prefill_chunk, the sampling policy and the deadlines. Serve/* load
    metrics land in ``stats.registry``; ``clock`` fakes time in tests.
    """

    def __init__(self, engine, serving: ServingConfig | dict | None = None,
                 registry=None, clock=None, programs=None, rid_source=None):
        if programs is not None or rid_source is not None:
            raise NotImplementedError(
                "ServingEngine: the fleet seams programs / rid_source are "
                f"not ported yet: {later(6, 'c')}")
        self.engine = engine
        if serving is None:
            serving = engine.config.serving
        self.cfg = ServingConfig.from_any(serving)
        self.model = engine.model
        self.device = engine.device
        mcfg = self.model.cfg
        if mcfg.objective != "clm":
            raise ValueError(f"serving needs a causal LM head; this model's "
                             f"objective is {mcfg.objective!r}")
        if mcfg.pos_embedding == "learned" and self.cfg.max_len > mcfg.max_seq:
            raise ValueError(
                f"serving max_len={self.cfg.max_len} exceeds the model's "
                f"learned-position table (max_seq={mcfg.max_seq})")
        self._flash = engine.flash_decode
        if self._flash and self.cfg.max_len % 128 != 0:
            raise ValueError(
                f"flash_decode needs max_len to be a multiple of 128 (the "
                f"decode-attention kernel's gate), got {self.cfg.max_len} — "
                "round up or set flash_decode=False")
        self._eos = engine.config.eos_token_id
        self._sampler = partial(sample_logits,
                                temperature=self.cfg.temperature,
                                top_k=self.cfg.top_k, top_p=self.cfg.top_p,
                                greedy=self.cfg.greedy)
        # self-speculative decoding: None keeps the plain one-token step
        self._spec = None
        sp = self.cfg.speculation
        if sp is not None and sp.enabled:
            if not (self.cfg.greedy or self.cfg.temperature == 0.0):
                raise ValueError(
                    "speculation requires greedy sampling (serving.greedy "
                    "= True or temperature = 0): the parity guarantee is "
                    "argmax chaining — stochastic sampling cannot be "
                    "verified against a draft bit-exactly")
            if self._flash:
                raise ValueError(
                    "speculation requires flash_decode off: the verify "
                    "forward runs the dense cache attention (T > 1), and "
                    "greedy parity holds only when the plain step runs the "
                    "same attention")
            self._spec = sp
        # slot -> [rid, NGramTable, tokens fed]: each slot's drafter, built
        # lazily from prompt + emitted tokens, so plain-step fallbacks and
        # requeues need no hooks
        self._spec_tables: dict = {}
        self._spec_steps = 0           # verify forwards run
        self._spec_proposed = 0        # draft tokens proposed
        self._spec_accepted = 0        # draft tokens accepted
        self._spec_first_scored = 0    # slots with a non-empty draft
        self._spec_first_hits = 0      # ... whose first draft hit
        # both lanes: emitted / slot steps is the accepted tokens a step
        # (exactly 1.0 with speculation off)
        self._decode_slot_steps = 0
        self._decode_emitted = 0
        self.stats = ServingStats(registry=registry,
                                  **({"clock": clock} if clock else {}))
        self._kv_heads = layout_of(self.model).kv_heads
        self._mesh = layout_of(self.model).mesh
        self._world = self._mesh.world
        if self._world > 1 and (self.cfg.ttft_deadline_s
                                or self.cfg.total_deadline_s):
            raise NotImplementedError(
                "serving deadlines over a world of more than one rank (each "
                "rank's clock would retire other requests) are not ported: "
                f"{later(4)}")
        if self._world > 1 and self.cfg.demote_ahead_idle_s > 0:
            raise NotImplementedError(
                "demote_ahead_idle_s over a world of more than one rank "
                "(each rank's clock would stage other blocks, so the ranks' "
                f"tiers would prune apart) is not ported: {later(4)}")
        # the quantized TP collective lives on the InferenceEngine; serving
        # shows it as a gauge, as the JAX engine does
        self._tp_quant = int(engine.config.tp_comm_quant or 0)
        if self._tp_quant:
            self.stats.registry.gauge("Serve/tp_quant_bits").set(
                float(self._tp_quant))
        # the paged pool and the host's page table, mirrored into the
        # state's table when it changes (a row seated at insert, cleared
        # where the pages are released); page_size 0 builds none of it
        self._paged = self.cfg.page_size > 0
        self.pool: Optional[PagePool] = None
        self._table = None
        self._table_dirty = False
        # demote-ahead reads the pool clock's touch stamps
        self._demote_ahead = (self.cfg.demote_ahead_idle_s
                              if self.cfg.demote_ahead_idle_s > 0 else None)
        if self._paged:
            self.pool = PagePool(self.cfg.pool_pages, self.cfg.page_size,
                                 self.cfg.max_len,
                                 registry=self.stats.registry,
                                 prefix_sharing=self.cfg.prefix_sharing,
                                 clock=self.stats.clock
                                 if self._demote_ahead is not None else None)
            self._table = np.zeros(
                (self.cfg.slots, self.pool.pages_per_slot), np.int32)
        self.sched = Scheduler(self.cfg.slots, self.cfg.max_len,
                               self.cfg.prefill_chunk,
                               max_queue=self.cfg.max_queue,
                               eos_token_id=self._eos, stats=self.stats,
                               ttft_deadline_s=self.cfg.ttft_deadline_s,
                               total_deadline_s=self.cfg.total_deadline_s,
                               pages=self.pool,
                               on_release=self._clear_row)
        # finished requests awaiting pickup, BOUNDED (oldest evicted)
        self.results: OrderedDict[int, Request] = OrderedDict()
        self._max_results = _MAX_RESULTS
        # (request, chunk plan, next chunk index, batch-1 cache, generators)
        self._prefill = None
        self._draining = False
        self._any_deadlines = False
        with torch.inference_mode():
            if self._paged:
                self.state: GenCarry = init_paged_slots(
                    mcfg, self.cfg.slots, self.cfg.max_len,
                    self.cfg.page_size, self.cfg.pool_pages,
                    engine.compute_dtype, self.cfg.kv_quant_bits,
                    device=self.device, kv_heads=self._kv_heads)
            else:
                self.state = init_slots(
                    mcfg, self.cfg.slots, self.cfg.max_len,
                    engine.compute_dtype, device=self.device,
                    kv_heads=self._kv_heads)
            if self._spec is not None:
                # the verify's static inputs: each slot's drafts (zero
                # padded), and the commit's packed upload
                self._drafts = torch.zeros(
                    (self.cfg.slots, self._spec.max_draft), dtype=torch.long,
                    device=self.device)
                self._packed = torch.zeros((4, self.cfg.slots),
                                           dtype=torch.long,
                                           device=self.device)
        self._build_tiers()
        cuda = self.device.type == "cuda"
        self._graph = SlotGraph() if cuda else None
        self._verify_graph = SlotGraph() if cuda and self._spec else None

    # ------------------------------------------------------------ KV tiers
    def _build_tiers(self) -> None:
        """The host tier (and the disk rung under it) when
        ``host_pool_bytes`` is set; else nothing, and the pool's seams stay
        None."""
        self.hostkv: Optional[HostKVTier] = None
        self.nvmekv: Optional[NVMeKVTier] = None
        self.kvtier: Optional[TieringEngine] = None
        # demote gathers enqueued this step, put into the tier at its end
        self._pending_demotes: list = []
        # restores whose upload may still read their pinned tiles
        self._restores_in_flight: list = []
        self._staged_ahead: set = set()
        self.demote_wait_s = 0.0
        # the transfers' bytes and device milliseconds (CUDA events) and
        # the drains' host seconds, CRC included
        self.tier_io = {"d2h_bytes": 0, "d2h_ms": 0.0, "h2d_bytes": 0,
                        "h2d_ms": 0.0, "drain_s": 0.0}
        if not (self._paged and self.cfg.host_pool_bytes > 0):
            return
        self._pin = self.device.type == "cuda"
        self._tier_stream = torch.cuda.Stream(self.device) if self._pin \
            else None
        # a page's tiles, each at a 64-byte offset of one host slot; the
        # slots for the whole budget (and one batch in flight) pinned once
        c = self.state.cache
        names = ("k", "v") + (("k_scale", "v_scale")
                              if c.k_scale is not None else ())
        self._layout, off = {}, 0
        for name in names:
            t = getattr(c, name)
            shape = (t.shape[0],) + tuple(t.shape[2:])
            nbytes = math.prod(shape) * t.element_size()
            np_dt = np.int16 if t.dtype == torch.bfloat16 else \
                torch.empty(0, dtype=t.dtype).numpy().dtype
            self._layout[name] = (shape, t.dtype, np_dt, off, nbytes)
            off += -(-nbytes // 64) * 64
        page = sum(spec[-1] for spec in self._layout.values())
        self._pages = PinnedPages(
            off, slots=self.cfg.host_pool_bytes // page
            + self.pool.pages_per_slot, pin=self._pin)
        self.hostkv = HostKVTier(self.cfg.host_pool_bytes,
                                 self.cfg.page_size,
                                 registry=self.stats.registry,
                                 clock=self.stats.clock)
        self.pool.host = self.hostkv
        if self.cfg.nvme_pool_bytes > 0:
            self.nvmekv = NVMeKVTier(self.cfg.nvme_pool_bytes,
                                     self.cfg.page_size,
                                     path=self.cfg.nvme_path,
                                     registry=self.stats.registry,
                                     clock=self.stats.clock,
                                     n_threads=4, write_behind=4,
                                     use_direct=self._pin,
                                     buffer=self._pages.take)
            self.kvtier = TieringEngine([self.hostkv, self.nvmekv])
            self.pool.host = self.kvtier
        self.pool.on_demote = self._demote_pages
        if self._world > 1:
            self.pool.agree = self._least_over_ranks

    def _least_over_ranks(self, n: int) -> int:
        """``PagePool.agree``: the least ``n`` over the world (each rank's
        matched block count; a rank's fallback or prune may leave it
        fewer)."""
        t = torch.tensor([n], dtype=torch.int64, device=self.device)
        comm.all_reduce(t, ("expert", "model"), "min", mesh=self._mesh)
        return int(t.item())

    def _page_tiles(self) -> dict:
        """A free page slot as the page's numpy tiles (bf16 as int16)."""
        slot = self._pages.take()
        return {name: slot[off:off + nb].view(np_dt).reshape(shape)
                for name, (shape, _, np_dt, off, nb) in self._layout.items()}

    def _torch_tile(self, name: str, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).view(self._layout[name][1])

    def _demote_pages(self, entries: list) -> None:
        """``PagePool.on_demote``: enqueue the gather of the evicted
        full-block pages' tiles now, on the current stream (ahead of any
        later insert or replay that could rewrite them), and their copy to
        pinned host memory on the tier stream; ``_drain_demotes`` puts them
        into the tier at the end of the step. With demote-ahead, pages
        already staged need no copy: their eviction was the refcount drop
        (``Serve/demote_ahead_fastfrees``)."""
        todo = entries
        if self._demote_ahead is not None:
            tier, todo, fast = self.pool.host, [], 0
            for e in entries:
                key = (len(e["tokens"]), token_hash(e["tokens"]))
                self._staged_ahead.discard(key)
                if tier.holds(e["tokens"], key=key):
                    fast += 1
                else:
                    todo.append(e)
            if fast:
                self.stats.registry.counter(
                    "Serve/demote_ahead_fastfrees").inc(fast)
                self.stats.registry.set_gauges({
                    "Serve/host_tier_staged_ahead":
                        float(len(self._staged_ahead))})
        if todo:
            self._dispatch_demote_gather(todo, pressure=True)

    def _dispatch_demote_gather(self, entries: list, pressure: bool) -> None:
        """Gather ``entries``' pages in batches of ``pages_per_slot`` and
        start each batch's copy into page slots (pinned) behind an event.
        ``pressure`` tags eviction-driven batches: their host time here and
        their wait at the drain count in ``Serve/host_tier_demote_wait_s``
        (the admission path's demote cost); demote-ahead's staging does
        not."""
        t0 = self.stats.clock() if pressure else None
        n = self.pool.pages_per_slot
        cur = torch.cuda.current_stream(self.device) if self._pin else None
        for off in range(0, len(entries), n):
            batch = entries[off:off + n]
            idx = torch.tensor([e["page"] for e in batch], dtype=torch.long)
            if self._pin:
                idx = idx.pin_memory().to(self.device, non_blocking=True)
            gathered = demote_rows(self.state, idx)
            pages = [self._page_tiles() for _ in batch]
            start = end = None
            if self._pin:
                ts = self._tier_stream
                ts.wait_stream(cur)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record(ts)
            with torch.cuda.stream(ts) if self._pin else nullcontext():
                for i, tiles in enumerate(pages):
                    for k, a in tiles.items():
                        self._torch_tile(k, a).copy_(gathered[k][i],
                                                     non_blocking=self._pin)
            if self._pin:
                end.record(ts)
                for v in gathered.values():
                    v.record_stream(ts)
            self._pending_demotes.append((start, end, pages, batch,
                                          pressure))
        if pressure:
            self.demote_wait_s += max(0.0, self.stats.clock() - t0)
            self.stats.registry.set_gauges({
                "Serve/host_tier_demote_wait_s": self.demote_wait_s})

    def _demote_ahead_tick(self) -> None:
        """The background lane: tree-held full blocks idle past
        ``demote_ahead_idle_s`` (the pool clock's touch stamps) are
        gathered and staged into the tier, one ``pages_per_slot`` batch a
        step, oldest first. Staging is a copy: the pages stay tree-held,
        and a resume still takes the tree hit."""
        pool = self.pool
        if pool.tree_held == 0:
            return
        tier = pool.host
        cutoff = self.stats.clock() - self._demote_ahead
        cand = pool.demote_ahead_candidates(cutoff, pool.pages_per_slot,
                                            skip=tier.holds)
        if not cand:
            return
        self._dispatch_demote_gather(cand, pressure=False)
        for e in cand:
            self._staged_ahead.add((len(e["tokens"]),
                                    token_hash(e["tokens"])))
        self.stats.registry.counter("Serve/demote_ahead_staged").inc(
            len(cand))
        self.stats.registry.set_gauges({
            "Serve/host_tier_staged_ahead": float(len(self._staged_ahead))})

    def _drain_demotes(self) -> None:
        """Put this step's demoted pages into the tier: wait on each batch's
        copy event, check the batch's CRCs together, then one ``put`` a
        page. Runs at the end of ``step()``; pressure-tagged batches bill
        their wait to the demote-wait meter."""
        t_drain = time.perf_counter()
        pending, self._pending_demotes = self._pending_demotes, []
        pressured = False
        for start, end, pages, batch, pressure in pending:
            if end is not None:
                t0 = self.stats.clock() if pressure else None
                end.synchronize()
                if pressure:
                    self.demote_wait_s += max(0.0, self.stats.clock() - t0)
                    pressured = True
                self.tier_io["d2h_ms"] += start.elapsed_time(end)
                self.tier_io["d2h_bytes"] += sum(
                    a.nbytes for tiles in pages for a in tiles.values())
            for e, tiles, crc in zip(batch, pages, tiles_crcs(pages)):
                self.pool.host.put(e["tokens"], tiles, crc=crc)
        if pressured:
            self.stats.registry.set_gauges({
                "Serve/host_tier_demote_wait_s": self.demote_wait_s})
        self.tier_io["drain_s"] += time.perf_counter() - t_drain

    def _restore_dispatch(self, cache, alloc) -> None:
        """Write one admission's restored blocks into its prefill cache
        pages ``[shared, shared + restored)``: each block's pinned tiles
        uploaded on the tier stream in at most two batches, the current
        stream waiting on each batch's event before its write, so the
        second upload overlaps the first write. The pinned tiles stay
        referenced until the end of the step (``_settle_restores``)."""
        t0 = self.stats.clock()
        n = self.pool.pages_per_slot
        R = max(1, (n + 1) // 2)
        tiles = {k: [self._torch_tile(k, a) for a in v]
                 for k, v in alloc.restore_tiles.items()}
        spans = [(off, min(R, alloc.restored - off))
                 for off in range(0, alloc.restored, R)]
        if not self._pin:
            for off, cnt in spans:
                restore_into_cache(cache, {k: torch.stack(v[off:off + cnt])
                                           for k, v in tiles.items()},
                                   alloc.shared + off)
        else:
            cur = torch.cuda.current_stream(self.device)
            ts = self._tier_stream
            bufs = [{k: torch.empty((cnt, *v[0].shape), dtype=v[0].dtype,
                                    device=self.device)
                     for k, v in tiles.items()} for _, cnt in spans]
            ts.wait_stream(cur)
            start = torch.cuda.Event(enable_timing=True)
            events = []
            with torch.cuda.stream(ts):
                start.record(ts)
                for (off, cnt), buf in zip(spans, bufs):
                    for k, v in tiles.items():
                        for i in range(cnt):
                            buf[k][i].copy_(v[off + i], non_blocking=True)
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record(ts)
                    events.append(ev)
            for (off, _), buf, ev in zip(spans, bufs, events):
                cur.wait_event(ev)
                restore_into_cache(cache, buf, alloc.shared + off)
            self._restores_in_flight.append(
                (start, events[-1], tiles, alloc.restore_bytes))
        self.pool.host.on_restore(self.stats.clock() - t0,
                                  pages=alloc.restored,
                                  tokens=alloc.restore_tokens,
                                  nbytes=alloc.restore_bytes)
        alloc.restore_tiles = None

    def _settle_restores(self) -> None:
        """The end of the step: the uploads are done (the step's chunk read
        their cache); read their times and drop the pinned tiles."""
        for start, end, _tiles, nbytes in self._restores_in_flight:
            end.synchronize()
            self.tier_io["h2d_ms"] += start.elapsed_time(end)
            self.tier_io["h2d_bytes"] += nbytes
        self._restores_in_flight = []

    def tier_snapshot(self) -> Optional[dict]:
        """The KV tiers' readout (None without a tier): the pool's tier
        snapshot, the demote-ahead set, the admission path's demote wait,
        the transfers' bytes and device time and the drains' host time."""
        if self.hostkv is None:
            return None
        io = dict(self.tier_io)
        for way in ("d2h", "h2d"):
            ms = io[f"{way}_ms"]
            io[f"{way}_gb_s"] = io[f"{way}_bytes"] / ms / 1e6 if ms else None
        return {**self.pool.host.snapshot(),
                "staged_ahead": len(self._staged_ahead),
                "demote_wait_s": self.demote_wait_s, "io": io}

    def close(self) -> None:
        """Wait out the disk rung's writes and close its files (nothing to
        do without a disk rung)."""
        if self.nvmekv is not None:
            self.nvmekv.close()

    def prefix_residency(self, prompt) -> tuple:
        raise NotImplementedError(
            f"ServingEngine.prefix_residency (the fleet router's probe) is "
            f"not ported yet: {later(6, 'c')}")

    def export_slot(self, *args, **kwargs):
        raise NotImplementedError(
            f"ServingEngine.export_slot (disaggregated prefill) is not "
            f"ported yet: {later(6, 'c')}")

    def import_slot(self, *args, **kwargs):
        raise NotImplementedError(
            f"ServingEngine.import_slot (disaggregated prefill) is not "
            f"ported yet: {later(6, 'c')}")

    @property
    def captures(self) -> int:
        """CUDA graph captures of the slot step: 1 after the first decode
        step on the card, and no more (0 on the CPU, which never graphs)."""
        return self._graph.captures if self._graph is not None else 0

    @property
    def graph(self) -> Optional[SlotGraph]:
        return self._graph

    @property
    def verify_captures(self) -> int:
        """CUDA graph captures of the speculative verify forward: 1 after
        the first verify step on the card, whatever the drafts accepted
        later (0 on the CPU, or with speculation off)."""
        g = self._verify_graph
        return g.captures if g is not None else 0

    @property
    def verify_graph(self) -> Optional[SlotGraph]:
        return self._verify_graph

    def _flush_table(self) -> None:
        """Write the host page table into the state's, if it changed: in
        place, on the current stream, so the next replay (or eager step,
        or insert) reads it. The tensor is never rebound: the graph reads
        it by address."""
        if self._table_dirty:
            self.state.cache.page_table.copy_(torch.from_numpy(self._table))
            self._table_dirty = False

    # -------------------------------------------------------- the slot step
    def _forward_slots(self):
        """The forward half of the slot step, the work the graph captures:
        every slot's carry token through the model, its KV and length
        updated in place. Returns (fp32 logits (slots, 1, V), the (slots,)
        logit guard)."""
        st = self.state
        lg, cache = decode_forward(self.model, self.engine.params, st,
                                   flash_decode=self._flash)
        st.cache.length.copy_(cache.length)
        return lg, finite_rows(lg)

    @torch.inference_mode()
    def slot_step(self, graphed: Optional[bool] = None):
        """Advance every slot one token: the forward (the graph's replay,
        or eager), then each slot's next token sampled from its own
        generator and eos forced on done rows, written into the state.
        Returns (logits, ok). ``graphed`` None takes the graph once it is
        captured; True without a capture raises."""
        if graphed is None:
            graphed = self._graph is not None and self._graph.captured
        if graphed:
            if self._graph is None or not self._graph.captured:
                raise RuntimeError("slot_step(graphed=True): no CUDA graph "
                                   "of the slot step is captured")
            lg, ok = self._graph.replay()
        else:
            lg, ok = self._forward_slots()
        st = self.state
        nxt = decode_sample(st, lg, st.cache, sampler=self._sampler,
                            eos_token_id=self._eos)
        st.tok.copy_(nxt.tok)
        st.done.copy_(nxt.done)
        return lg, ok

    def _warm_then_capture(self, g: SlotGraph, eager, forward):
        """The first call of a graphed lane: ``eager()`` on a side stream
        (it creates every workspace the kernels cache), then the capture
        of ``forward``, in the other graph's pool where one exists.
        Returns ``eager()``'s result."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = eager()
        cur.wait_stream(side)
        other = self._verify_graph if g is self._graph else self._graph
        g.capture(forward, pool=other.pool if other is not None else None)
        return out

    def _decode(self):
        """One decode iteration; on the card the first one is the eager
        warm-up on a side stream, followed by the capture. Then ONE fused
        host read-back of tok, done and the logit guard together."""
        g = self._graph
        if g is not None and not g.captured:
            _, ok = self._warm_then_capture(
                g, lambda: self.slot_step(graphed=False),
                self._forward_slots)
        else:
            _, ok = self.slot_step()
        st = self.state
        packed = torch.stack([st.tok, st.done.long(), ok.long()]).cpu()
        toks, dones, oks = packed.numpy()
        return toks, dones.astype(bool), oks.astype(bool)

    # ---------------------------------------------------- self-speculation
    def _forward_verify(self):
        """The fixed-shape verify forward, the work the verify graph
        captures: every slot's carry token and its (zero-padded) drafts
        through ``forward_with_cache`` as one (slots, max_draft + 1) call,
        the lengths advanced by max_draft + 1 in place. Returns (fp32
        logits (slots, max_draft + 1, V), one (slots, max_draft + 2) int64
        read-back: the argmax winners, then the row's logit guard). The
        argmax of the fp32 logits is the greedy sampler, so winner j is the
        token the plain step samples after committing positions < j."""
        st = self.state
        ids = torch.cat([st.tok[:, None], self._drafts], dim=1)
        lg, cache = forward_with_cache(self.model, self.engine.params, ids,
                                       st.cache)
        st.cache.length.copy_(cache.length)
        return lg, torch.cat([lg.argmax(dim=-1),
                              finite_rows(lg)[:, None].long()], dim=1)

    @torch.inference_mode()
    def verify_step(self, drafts, graphed: Optional[bool] = None):
        """Upload ``drafts`` ((slots, max_draft) ints) into the static
        draft buffer and run the verify forward: the graph's replay, or
        eager. Returns (logits, winners and guard) as
        :meth:`_forward_verify`. ``graphed`` None takes the graph once it
        is captured; True without a capture raises."""
        self._drafts.copy_(torch.as_tensor(np.asarray(drafts),
                                           dtype=torch.long))
        g = self._verify_graph
        if graphed is None:
            graphed = g is not None and g.captured
        if graphed:
            if g is None or not g.captured:
                raise RuntimeError("verify_step(graphed=True): no CUDA "
                                   "graph of the verify forward is captured")
            return g.replay()
        return self._forward_verify()

    def _spec_plan(self):
        """This step's drafts from the per-slot n-gram tables, or None for
        the plain step (host-side only). None when (a) a running slot
        lacks the verify's headroom (``live + max_draft + 1 <= max_len``:
        both cache layouts clamp a write past the end) or (b) no slot
        drafted anything (a verify with no draft is a plain step at
        max_draft + 1 times the work). The tables follow ``prompt +
        tokens`` by a watermark, so plain steps and requeues need no
        hooks. Returns (drafts (slots, max_draft) int64, lengths)."""
        spec = self._spec
        K = spec.max_draft
        running = self.sched.running
        tables = self._spec_tables
        for slot in list(tables):
            req = running.get(slot)
            if req is None or tables[slot][0] != req.rid:
                del tables[slot]
        drafts = np.zeros((self.cfg.slots, K), np.int64)
        lens = np.zeros(self.cfg.slots, np.int64)
        any_draft = False
        for slot, req in running.items():
            P = len(req.prompt)
            total = P + len(req.tokens)
            if total - 1 + K + 1 > self.cfg.max_len:
                return None
            ent = tables.get(slot)
            if ent is None:
                tab = NGramTable(spec.ngram)
                tab.extend(np.asarray(req.prompt).reshape(-1).tolist())
                tab.extend(req.tokens)
                tables[slot] = [req.rid, tab, total]
            else:
                tab = ent[1]
                if ent[2] < total:
                    tab.extend(req.tokens[ent[2] - P:])
                    ent[2] = total
            cap = min(K, req.max_new - len(req.tokens) - 1)
            if cap <= 0:
                continue
            d = tables[slot][1].draft(cap)
            if d:
                drafts[slot, :len(d)] = d
                lens[slot] = len(d)
                any_draft = True
        return (drafts, lens) if any_draft else None

    def _spec_verify_commit(self, plan):
        """The speculative lane's device work: the verify forward (on the
        card the first one eager on a side stream, then the capture; later
        ones replays), ONE host read-back of the winners and the logit
        guard, the acceptance chain on the host, then the commit: one
        (4, slots) upload (active, new length, new token, new done) and an
        in-place ``where`` on the state's length, tok and done, on the same
        stream. Inactive rows (idle slots, non-finite rows) keep the
        verify's values, as plain steps advance idle rows. Returns
        (emitted, bad, tallies) for :meth:`_spec_resolve`."""
        drafts, lens = plan
        g = self._verify_graph
        if g is not None and not g.captured:
            _, packed_out = self._warm_then_capture(
                g, lambda: self.verify_step(drafts, graphed=False),
                self._forward_verify)
        else:
            _, packed_out = self.verify_step(drafts)
        back = packed_out.cpu().numpy()
        m, vok = back[:, :-1], back[:, -1].astype(bool)
        eos = self._eos
        B = self.cfg.slots
        packed = np.zeros((4, B), np.int64)
        active, new_len, new_tok, new_done = packed
        emitted: dict = {}
        bad: list = []
        proposed = accepted = first_scored = first_hits = 0
        for slot, req in self.sched.running.items():
            if not bool(vok[slot]):
                bad.append(slot)
                continue
            dlen = int(lens[slot])
            toks = [int(m[slot, 0])]
            j = 0
            # draft j survives iff it equals winner j - 1 (then winner j is
            # the next plain token); stop at the first miss or at eos
            while j < dlen and (eos is None or toks[-1] != eos) \
                    and int(drafts[slot, j]) == toks[-1]:
                toks.append(int(m[slot, j + 1]))
                j += 1
            proposed += dlen
            accepted += j
            if dlen:
                first_scored += 1
                if int(drafts[slot, 0]) == toks[0]:
                    first_hits += 1
            live = len(req.prompt) + len(req.tokens) - 1
            active[slot] = 1
            new_len[slot] = live + len(toks)
            new_tok[slot] = toks[-1]
            new_done[slot] = eos is not None and toks[-1] == eos
            emitted[slot] = toks
        st = self.state
        with torch.inference_mode():
            self._packed.copy_(torch.from_numpy(packed))
            on = self._packed[0].bool()
            length = st.cache.length
            length.copy_(torch.where(on, self._packed[1].to(length.dtype),
                                     length))
            st.tok.copy_(torch.where(on, self._packed[2], st.tok))
            st.done.copy_(torch.where(on, self._packed[3].bool(), st.done))
        return emitted, bad, (proposed, accepted, first_scored, first_hits)

    def _spec_resolve(self, spec_out) -> list:
        """The scheduler and metrics half of the speculative lane: retire
        the non-finite rows first (before their garbage is appended),
        commit every other slot's tokens (a paged retirement truncates its
        pages inside ``on_spec_step``), and count the step."""
        emitted, bad, (proposed, accepted, first_scored, first_hits) = \
            spec_out
        finished: list = []
        if bad:
            finished += self.sched.retire_nonfinite(bad)
            for slot in bad:
                self._spec_tables.pop(slot, None)
        n_emitted = sum(len(t) for t in emitted.values())
        self._decode_slot_steps += len(emitted) + len(bad)
        self._decode_emitted += n_emitted
        finished += self.sched.on_spec_step(emitted)
        self._spec_steps += 1
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        self._spec_first_scored += first_scored
        self._spec_first_hits += first_hits
        r = self.stats.registry
        r.counter("Serve/spec_steps").inc()
        r.counter("Serve/spec_draft_tokens").inc(proposed)
        r.counter("Serve/spec_accepted_tokens").inc(accepted)
        r.counter("Serve/spec_emitted_tokens").inc(n_emitted)
        return finished

    def spec_snapshot(self) -> Optional[dict]:
        """The live speculation readout (None with the lane off): the
        accepted tokens a step over both lanes (a plain step counts 1
        token a slot), the acceptance rates, and the raw tallies."""
        if self._spec is None:
            return None
        steps = self._decode_slot_steps
        return {
            "ngram": self._spec.ngram,
            "max_draft": self._spec.max_draft,
            "verify_steps": self._spec_steps,
            "proposed_tokens": self._spec_proposed,
            "accepted_tokens": self._spec_accepted,
            "slot_steps": steps,
            "emitted_tokens": self._decode_emitted,
            "accepted_tokens_per_step":
                (self._decode_emitted / steps) if steps else None,
            "accept_rate":
                (self._spec_accepted / self._spec_proposed)
                if self._spec_proposed else None,
            "first_accept_rate":
                (self._spec_first_hits / self._spec_first_scored)
                if self._spec_first_scored else None,
        }

    # --------------------------------------------------------------- intake
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               seed: int = 0, ttft_deadline_s: Optional[float] = None,
               total_deadline_s: Optional[float] = None) -> int:
        """Queue one request; returns its request id. Its tokens sample
        from a generator seeded from ``seed``: equal, up to eos
        truncation, to ``engine.generate(prompt[None], max_new,
        request_seeds=[seed], cache_len=<serving max_len>)`` with the same
        sampling knobs.

        ``ttft_deadline_s`` / ``total_deadline_s`` override the config
        defaults for this request (0 disables). Raises
        :class:`~..resilience.guards.QueueFullError` (status ``SHED``)
        when the queue is at ``max_queue`` or the engine is draining."""
        if self._draining:
            self.stats.on_shed(self.sched.queue_depth)
            raise QueueFullError("serving engine is draining; request shed",
                                 queue_depth=self.sched.queue_depth,
                                 max_queue=self.cfg.max_queue)
        max_new = int(max_new_tokens or self.engine.config.max_out_tokens)
        if self._world > 1 and (ttft_deadline_s or total_deadline_s):
            raise NotImplementedError(
                "serving deadlines over a world of more than one rank are "
                f"not ported: {later(4)}")
        req = self.sched.submit(prompt, max_new, seed,
                                ttft_deadline_s=ttft_deadline_s,
                                total_deadline_s=total_deadline_s)
        if req.deadline_ttft is not None or req.deadline_total is not None:
            self._any_deadlines = True
        return req.rid

    def requeue(self, req: Request) -> Request:
        """Take ``req`` back to re-run from its prefill (typed
        ``REQUEUED`` transition through the scheduler), keeping its
        absolute deadlines. Bypasses ``max_queue`` and the drain gate: a
        requeued request is already-admitted work, not new intake."""
        self.sched.requeue(req)
        if req.deadline_ttft is not None or req.deadline_total is not None:
            self._any_deadlines = True
        return req

    def cancel(self, rid: int) -> Optional[Request]:
        """Cancel a request wherever it lives — queue, prefill lane, or
        decode slot. Returns the request (status ``CANCELLED``, also
        placed in ``results``) or None if it already finished / is
        unknown."""
        if self._prefill is not None and self._prefill[0].rid == rid:
            req = self._prefill[0]
            self._prefill = None
            self.sched.abort(req, RequestStatus.CANCELLED,
                             "cancelled during prefill")
        else:
            req = self.sched.cancel(rid)
        if req is not None:
            self._store_result(req)
        return req

    # -------------------------------------------------------------- serving
    @torch.inference_mode()
    def step(self) -> list[Request]:
        """One serving iteration: deadline sweep + <= 1 prefill chunk + 1
        decode step over the occupied slots. Returns the requests that
        finished this iteration — normally (status ``OK``) or through a
        guard (``TIMEOUT`` / ``NONFINITE``); all are also kept in
        ``results``."""
        finished: list[Request] = []
        ran_chunk = ran_decode = False
        # deadline sweep FIRST: an expired queued request never spends a
        # prefill chunk, an expired running one frees its slot for this
        # very iteration's admission
        if self._any_deadlines:
            finished += self._expire_deadlines()
        if self._paged:
            # rows cleared since the last flush (last iteration's
            # retirements, a cancel, this sweep's deadlines) reach the
            # device BEFORE their pages can be reused by this admission or
            # written by this decode step
            self._flush_table()
        if self._prefill is None:
            req = self.sched.pop_next()
            if req is not None:
                cache = init_cache(self.model.cfg, 1, self.cfg.max_len,
                                   self.engine.compute_dtype,
                                   device=self.device,
                                   kv_heads=self._kv_heads)
                alloc = req.page_alloc
                if alloc is not None and alloc.hydrate_pages > 0:
                    # prefix sharing: the shared pages (and a copy-on-write
                    # source) into the prefill cache once; the chunk plan
                    # then recomputes only the suffix
                    hydrate_cache(self.state, cache, alloc.hydrate_row,
                                  alloc.hydrate_pages)
                if alloc is not None and alloc.restored:
                    # the KV tier's cold blocks after the shared run; the
                    # suffix chunks run behind the upload
                    self._restore_dispatch(cache, alloc)
                self._prefill = (req, self.sched.plan(req), 0, cache,
                                 per_request_generators([req.seed],
                                                        self.device))
        if self._prefill is not None:
            finished += self._prefill_advance()
            ran_chunk = True
        if self.sched.running:
            # decode lane: every occupied slot advances one token or, with
            # speculation and a draft somewhere, up to max_draft + 1
            # through the verify forward
            plan = self._spec_plan() if self._spec is not None else None
            if plan is not None:
                finished += self._spec_resolve(self._spec_verify_commit(plan))
            else:
                n_slots = len(self.sched.running)
                toks, dones, oks = self._decode()
                if not oks.all():
                    # retire ONLY the poisoned rows, before on_step can
                    # append their garbage tokens
                    bad = [s for s in np.nonzero(~oks)[0]
                           if int(s) in self.sched.running]
                    finished += self.sched.retire_nonfinite(bad)
                self._decode_slot_steps += n_slots
                self._decode_emitted += len(self.sched.running)
                finished += self.sched.on_step(toks, dones)
            ran_decode = True
        if self._demote_ahead is not None:
            # stage idle tree-held pages before pressure; they drain below
            self._demote_ahead_tick()
        if self._pending_demotes:
            # off the admission path: this step's demotes land in the tier
            self._drain_demotes()
        if self._restores_in_flight:
            self._settle_restores()
        self.stats.on_iteration(self.sched.queue_depth, self.sched.occupancy,
                                self.cfg.slots, ran_chunk, ran_decode)
        for req in finished:
            self._store_result(req)
        return finished

    def _clear_row(self, req: Request) -> None:
        """The scheduler released ``req``'s pages: its slot's table row
        goes back to scratch at once, so no later flush can send a row
        whose pages another request now owns. Only if the slot is EMPTY:
        a request requeued after its slot was refilled must not clear the
        successor's row."""
        if req.slot >= 0 and self.sched.running.get(req.slot) is None:
            self._table[req.slot] = 0
            self._table_dirty = True

    def _store_result(self, req: Request) -> None:
        self.results[req.rid] = req
        if len(self.results) > self._max_results:
            self.results.popitem(last=False)
            self.stats.on_results_evicted()
            warning_once(
                f"serving results store hit its cap ({self._max_results}); "
                "evicting oldest finished requests — collect results via "
                "step()'s return value or pop_result() (further evictions "
                "count in Serve/results_evicted)")

    def _expire_deadlines(self) -> list[Request]:
        """One deadline sweep over queue + slots + the prefill lane."""
        now = self.stats.clock()
        expired = self.sched.expire_deadlines(now)
        if self._prefill is not None:
            req = self._prefill[0]
            if (req.deadline_ttft is not None and now >= req.deadline_ttft) \
                    or (req.deadline_total is not None
                        and now >= req.deadline_total):
                self._prefill = None
                expired.append(self.sched.abort(
                    req, RequestStatus.TIMEOUT,
                    "deadline expired during prefill"))
        return expired

    def _prefill_advance(self) -> list[Request]:
        """One chunk of the in-flight prefill; the final chunk samples the
        first token from the last real position with the request's own
        generator and seats the request in a slot."""
        req, plan, idx, cache, gens = self._prefill
        ch = plan[idx]
        ids = torch.as_tensor(ch.ids[None], dtype=torch.long,
                              device=self.device)
        cache = KVCache(cache.k, cache.v,
                        torch.tensor(ch.start, dtype=torch.int32,
                                     device=self.device))
        logits, cache = forward_with_cache(
            self.model, self.engine.params, ids, cache, last_token_head=True,
            last_index=ch.last_index if ch.final else None,
            materialize=self.engine.materialize)
        if not ch.final:
            self._prefill = (req, plan, idx + 1, cache, gens)
            return []
        self._prefill = None
        tok = self._sampler(logits[:, -1], gens)
        done = (tok == self._eos) if self._eos is not None \
            else torch.zeros_like(tok, dtype=torch.bool)
        first_tok, first_done = (int(v) for v in torch.stack(
            [tok[0], done[0].long()]).cpu())
        if req.max_new == 1 or first_done:
            return [self.sched.complete_at_prefill(req, first_tok)]
        slot = self.sched.place(req, first_tok)
        length = torch.full((), ch.true_len, dtype=torch.int32,
                            device=self.device)
        pf = GenCarry(tok, KVCache(cache.k, cache.v, length), gens, done)
        if self._paged:
            alloc = req.page_alloc
            self._table[slot] = alloc.row
            self._table_dirty = True
            self._flush_table()
            insert_paged(self.state, slot, pf, alloc.row, alloc.shared)
            # the prompt's blocks are in the pool: index them for sharing
            # and release the copy-on-write source's pin
            self.pool.on_inserted(req.rid, req.prompt)
        else:
            insert_request(self.state, slot, pf)
        return []

    def begin_drain(self) -> None:
        """Stop ADMITTING new submits (they shed with
        :class:`QueueFullError`, status ``SHED``) while queued and running
        requests are served to completion."""
        self._draining = True

    def end_drain(self) -> None:
        """Reopen intake after a drain."""
        self._draining = False

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self, max_iterations: int = 1_000_000) -> dict[int, Request]:
        """Graceful shutdown: enter drain mode, run until queue and slots
        are empty, return ``results``. Intake stays closed afterwards —
        call :meth:`end_drain` to reopen."""
        self.begin_drain()
        it = 0
        while not self.sched.idle or self._prefill is not None:
            self.step()
            it += 1
            if it > max_iterations:
                raise RuntimeError(
                    f"serving failed to drain in {max_iterations} "
                    "iterations — scheduler wedged?")
        return self.results

    def pop_result(self, rid: int) -> Optional[Request]:
        """Collect (and release) a finished request; None if not finished
        or already collected."""
        return self.results.pop(rid, None)

    def serve_batch(self, prompts, max_new_tokens=None, seeds=None) -> list:
        """Submit a list of (ragged) prompts, run until each finished, and
        return each request's tokens as an int32 array, in submission
        order. ``max_new_tokens`` and ``seeds`` may be scalars or
        per-request lists. Results are popped, so repeated calls on one
        engine don't accumulate host state."""
        n = len(prompts)
        mn = expand_per_request(max_new_tokens, n, None, int)
        sd = expand_per_request(seeds, n, 0, int)
        rids = [self.submit(p, mn[i], seed=sd[i])
                for i, p in enumerate(prompts)]
        want = set(rids)
        got: dict[int, Request] = {}
        it = 0
        while len(got) < n:
            for req in self.step():
                if req.rid in want:
                    got[req.rid] = req
                    self.results.pop(req.rid, None)
            it += 1
            if it > 1_000_000:
                raise RuntimeError("serve_batch failed to finish — "
                                   "scheduler wedged?")
        return [np.asarray(got[r].tokens, np.int32) for r in rids]

    def metrics_snapshot(self) -> dict:
        out = {"captures": self.captures, **self.stats.snapshot()}
        spec = self.spec_snapshot()
        if spec is not None:
            out["speculation"] = spec
            out["verify_captures"] = self.verify_captures
        if self._tp_quant:
            out["tp_quant_bits"] = self._tp_quant
        if self._paged:
            out["pages"] = self.pool.snapshot()
        tiers = self.tier_snapshot()
        if tiers is not None:
            out["tiers"] = tiers
        return out
