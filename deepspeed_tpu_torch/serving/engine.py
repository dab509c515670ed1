"""ServingEngine: continuous batching over contiguous KV slots or the
paged KV pool.

Counterpart of ``deepspeed_tpu/serving/engine.py`` (speculation, the fleet
and the observability hooks are ROADMAP.md queue 1 items 5, 6 and 7, and
their config keys raise). The engine owns:

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

Under ``tensor_parallel`` / ``expert_parallel`` every rank runs its own
engine on the same submissions: the same scheduler, pool and page tables
(host, deterministic), its shard of the model and its KV heads on its
card, and the slot step's collectives (captured in its graph); the logits
are all-gathered before sampling, so every rank's seeded sampler draws
the same token. Deadlines read each rank's own clock, so a world above
one takes none.

A request's tokens equal a solo ``generate(prompt[None], max_new,
request_seeds=[seed], cache_len=max_len)`` with the same sampling knobs:
its generator is seeded from its request seed (never from its slot), the
slot step runs the two halves of the ``decode_step`` that ``generate()``
runs, and the chunked prefill writes what a whole prefill writes.
"""

from __future__ import annotations

from collections import OrderedDict
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..inference.config import ServingConfig
from ..inference.decode import (GenCarry, KVCache, decode_forward,
                                decode_sample, finite_rows,
                                forward_with_cache, init_cache, layout_of)
from ..inference.sampling import per_request_generators, sample_logits
from ..observability.tracing import ServingStats
from ..resilience.guards import QueueFullError, RequestStatus
from ..utils.logging import warning_once
from ..utils.roadmap import later
from .graph import SlotGraph
from .pages import PagePool, hydrate_cache, init_paged_slots, insert_paged
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
                f"not ported yet: {later(6)}")
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
        self.stats = ServingStats(registry=registry,
                                  **({"clock": clock} if clock else {}))
        self._kv_heads = layout_of(self.model).kv_heads
        self._world = layout_of(self.model).mesh.world
        if self._world > 1 and (self.cfg.ttft_deadline_s
                                or self.cfg.total_deadline_s):
            raise NotImplementedError(
                "serving deadlines over a world of more than one rank (each "
                "rank's clock would retire other requests) are not ported: "
                f"{later(4)}")
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
        if self._paged:
            self.pool = PagePool(self.cfg.pool_pages, self.cfg.page_size,
                                 self.cfg.max_len,
                                 registry=self.stats.registry,
                                 prefix_sharing=self.cfg.prefix_sharing)
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
        self._graph = SlotGraph() if self.device.type == "cuda" else None

    @property
    def captures(self) -> int:
        """CUDA graph captures of the slot step: 1 after the first decode
        step on the card, and no more (0 on the CPU, which never graphs)."""
        return self._graph.captures if self._graph is not None else 0

    @property
    def graph(self) -> Optional[SlotGraph]:
        return self._graph

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

    def _decode(self):
        """One decode iteration; on the card the first one is the eager
        warm-up on a side stream, followed by the capture. Then ONE fused
        host read-back of tok, done and the logit guard together."""
        g = self._graph
        if g is not None and not g.captured:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                _, ok = self.slot_step(graphed=False)
            torch.cuda.current_stream(self.device).wait_stream(side)
            g.capture(self._forward_slots)
        else:
            _, ok = self.slot_step()
        st = self.state
        packed = torch.stack([st.tok, st.done.long(), ok.long()]).cpu()
        toks, dones, oks = packed.numpy()
        return toks, dones.astype(bool), oks.astype(bool)

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
                self._prefill = (req, self.sched.plan(req), 0, cache,
                                 per_request_generators([req.seed],
                                                        self.device))
        if self._prefill is not None:
            finished += self._prefill_advance()
            ran_chunk = True
        if self.sched.running:
            toks, dones, oks = self._decode()
            if not oks.all():
                # retire ONLY the poisoned rows, before on_step can append
                # their garbage tokens
                bad = [s for s in np.nonzero(~oks)[0]
                       if int(s) in self.sched.running]
                finished += self.sched.retire_nonfinite(bad)
            finished += self.sched.on_step(toks, dones)
            ran_decode = True
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
        if self._tp_quant:
            out["tp_quant_bits"] = self._tp_quant
        if self._paged:
            out["pages"] = self.pool.snapshot()
        return out
