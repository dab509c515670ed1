"""Host-side continuous-batching scheduler: queue, slots, chunk plans.

Counterpart of ``deepspeed_tpu/serving/scheduler.py`` with its page and
speculation branches, without its span ones (ROADMAP.md queue 1 item 7):
plain Python over numpy and floats, so it makes the same plans
and the same admission and retirement order as the JAX package's, and
runs under a fake clock with no device.

Policy, per serving iteration (see ``ServingEngine.step``):

1. admission — if a slot is free, no prefill is in flight, and the queue
   is non-empty, the head request starts prefilling (on the paged pool:
   if the pool can cover its worst-case pages now; else it waits at the
   head);
2. chunked prefill — at most ONE prompt chunk runs per iteration, so a
   long prompt never stalls running requests' TPOT for more than a chunk;
3. decode — every occupied slot advances one token (with speculation, up
   to ``max_draft + 1`` through one verify step: :meth:`Scheduler.on_spec_step`);
4. retirement — rows that hit eos or their max_new free their slot
   immediately; the slot is reusable the very next iteration.

Chunk plans are shape-bucketed: every chunk is either exactly
``prefill_chunk`` tokens or a power-of-two bucket below it.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..observability.tracing import ServingStats
from ..resilience.guards import QueueFullError, RequestStatus
from .pages import PageAllocation, PagePool

_MIN_BUCKET = 8   # smallest residual-chunk bucket; below this, right-pad


@dataclasses.dataclass
class ChunkPlan:
    """One prefill chunk: run ``ids`` (already bucket-sized) with the cache
    length rewound to ``start``; ``final`` chunks also sample the first
    token from position ``last_index`` and set the cache to ``true_len``.

    Two bucketing tricks keep shapes bounded WITHOUT corrupting the cache:
    - overlap: a residual of r tokens re-runs the last ``size`` >= r prompt
      tokens (recomputing a suffix writes the same KV, so rewinding
      ``start`` is free) — used whenever the prompt is long enough;
    - right-pad: short prompts pad up to the bucket; the pad's garbage KV
      lands at positions >= ``true_len``, which the attention mask already
      ignores and the first decode steps progressively overwrite.
    """

    start: int                    # cache position this chunk writes from
    ids: np.ndarray               # (size,) int32 token ids (padded if needed)
    final: bool = False
    last_index: int = 0           # position of the last REAL token in ids
    true_len: int = 0             # prompt length the cache ends at

    @property
    def size(self) -> int:
        return len(self.ids)


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def plan_chunks(prompt: np.ndarray, chunk: int, skip: int = 0) -> list:
    """Split one prompt into bucket-shaped prefill chunks.

    Full ``chunk``-size chunks cover the head of the prompt; the residual
    runs as the smallest power-of-two bucket >= max(residual, 8), via
    overlap when the prompt affords it, else right-padding.

    ``skip`` (prefix sharing, ``pages.py``) drops the first ``skip``
    tokens, whose KV is hydrated from shared pool pages. The chunks stay
    in the same bucket set, and the final overlap bucket may rewind into
    the hydrated region, rewriting the same KV."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    P = len(prompt)
    if P < 1:
        raise ValueError("empty prompt")
    if not 0 <= skip < P:
        raise ValueError(f"skip={skip} outside [0, {P})")
    Q = P - skip                         # tokens actually recomputed
    k = (Q - 1) // chunk                 # full chunks before the residual
    r = Q - k * chunk                    # residual, in (0, chunk]
    plans = [ChunkPlan(start=skip + i * chunk,
                       ids=prompt[skip + i * chunk:skip + (i + 1) * chunk])
             for i in range(k)]
    b = max(_MIN_BUCKET, _pow2_ceil(r))
    if P >= b:        # overlap: recompute the last b prompt tokens
        plans.append(ChunkPlan(start=P - b, ids=prompt[P - b:], final=True,
                               last_index=b - 1, true_len=P))
    else:             # short prompt: right-pad to the bucket
        ids = np.concatenate([prompt, np.zeros(b - P, np.int32)])
        plans.append(ChunkPlan(start=0, ids=ids, final=True,
                               last_index=P - 1, true_len=P))
    return plans


@dataclasses.dataclass
class Request:
    """One served request, host-side.

    ``status`` is the outcome (:class:`RequestStatus`); ``deadline_ttft`` /
    ``deadline_total`` are ABSOLUTE times on the stats clock (submit time +
    the budgets), None when no deadline applies."""

    rid: int
    prompt: np.ndarray
    max_new: int
    seed: int
    attempts: int = 0                     # times ``requeue`` took it back
    submit_t: float = 0.0
    admit_t: Optional[float] = None       # left the queue (prefill starts)
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    slot: int = -1
    tokens: list = dataclasses.field(default_factory=list)
    status: RequestStatus = RequestStatus.OK
    error: str = ""
    deadline_ttft: Optional[float] = None
    deadline_total: Optional[float] = None
    requeue_t: Optional[float] = None     # when ``requeue`` took it back
    page_alloc: Optional[PageAllocation] = None   # the paged pool's plan

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def finished(self) -> bool:
        return self.finish_t is not None

    @property
    def ok(self) -> bool:
        return self.finished and self.status is RequestStatus.OK


class Scheduler:
    """Queue + slot bookkeeping; all decisions, no device code.

    The engine asks ``pop_next()`` for the next request to prefill, then
    ``place()``s it into a slot (or ``complete_at_prefill()`` if its first
    token already finished it), and reports every decode step through
    ``on_step`` — which appends tokens, retires rows at eos / max_new, and
    frees their slots. FIFO admission; retirement order is whatever the
    tokens dictate. ``pages``: the paged pool (:class:`~.pages.PagePool`);
    admission then takes the request's pages and every terminal path
    releases them. None: contiguous slots. ``on_release(req)`` is called
    wherever a request's pages are released, so the engine clears its
    slot's table row at that moment.
    """

    def __init__(self, slots: int, max_len: int, prefill_chunk: int,
                 max_queue: int = 0, eos_token_id: Optional[int] = None,
                 stats: Optional[ServingStats] = None,
                 ttft_deadline_s: float = 0.0,
                 total_deadline_s: float = 0.0,
                 pages: Optional[PagePool] = None,
                 on_release: Optional[Callable[[Request], None]] = None):
        self.slots = slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.max_queue = max_queue
        self.eos_token_id = eos_token_id
        self.pages = pages
        self.on_release = on_release
        self._defer_key = None   # (rid, pool generation) of a failed admit
        self.stats = stats if stats is not None else ServingStats()
        self.ttft_deadline_s = float(ttft_deadline_s)
        self.total_deadline_s = float(total_deadline_s)
        self.queue: deque[Request] = deque()
        self.free: list[int] = list(range(slots))
        self.running: dict[int, Request] = {}
        self._next_rid = 0

    # -------------------------------------------------------------- intake
    def submit(self, prompt, max_new: int, seed: int = 0,
               ttft_deadline_s: Optional[float] = None,
               total_deadline_s: Optional[float] = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if len(prompt) + max_new > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds the "
                f"slot capacity max_len={self.max_len} — raise "
                f"serving.max_len or trim the request")
        if self.max_queue and len(self.queue) >= self.max_queue:
            self.stats.on_shed(len(self.queue))
            raise QueueFullError(
                f"serving queue full ({self.max_queue}); apply backpressure",
                queue_depth=len(self.queue), max_queue=self.max_queue)
        if self.pages is not None:
            # typed PagePoolExhausted (status SHED) for a request the pool
            # can NEVER hold; a transient shortage defers in pop_next
            try:
                self.pages.check_submit(len(prompt), int(max_new))
            except QueueFullError:
                self.stats.on_shed(len(self.queue))
                raise
        req = Request(rid=self._next_rid, prompt=prompt, max_new=int(max_new),
                      seed=int(seed))
        self._next_rid += 1
        self.queue.append(req)
        req.submit_t = self.stats.on_submit(len(self.queue))
        ttft = self.ttft_deadline_s if ttft_deadline_s is None \
            else float(ttft_deadline_s)
        total = self.total_deadline_s if total_deadline_s is None \
            else float(total_deadline_s)
        if ttft > 0:
            req.deadline_ttft = req.submit_t + ttft
        if total > 0:
            req.deadline_total = req.submit_t + total
        return req

    # ----------------------------------------------------------- admission
    def pop_next(self) -> Optional[Request]:
        """Head-of-queue request to start prefilling, if a slot is free
        and, on the paged pool, if the pool can cover its worst-case pages
        now (a transient shortage leaves it at the head until a release
        frees pages, so the pool never runs dry mid-decode). The engine
        keeps at most one prefill in flight."""
        if not self.queue or not self.free:
            return None
        if self.pages is not None:
            head = self.queue[0]
            # retry only once admission prospects changed: a failed
            # try_admit re-runs the tree match and the eviction walk
            key = (head.rid, self.pages.generation)
            if key == self._defer_key:
                return None
            alloc = self.pages.try_admit(head.prompt, head.max_new,
                                         head.rid)
            if alloc is None:
                self._defer_key = key
                return None
            self._defer_key = None
            head.page_alloc = alloc
        req = self.queue.popleft()
        admit_t = self.stats.on_admit(len(self.queue), submit_t=req.submit_t)
        req.admit_t = admit_t
        if req.requeue_t is not None:
            self.stats.on_requeue_delay(admit_t - req.requeue_t)
        return req

    def plan(self, req: Request) -> list:
        skip = req.page_alloc.skip if req.page_alloc is not None else 0
        return plan_chunks(req.prompt, self.prefill_chunk, skip=skip)

    def _release_pages(self, req: Request) -> None:
        """Every terminal path comes here: drop the request's page refs
        (shared pages stay for later sharing through their tree ref;
        private pages free at once)."""
        if self.pages is not None and req.page_alloc is not None:
            self.pages.release(req.rid)
            if self.on_release is not None:
                self.on_release(req)

    def place(self, req: Request, first_tok: int) -> int:
        """Prefill finished: record the first token, occupy a slot."""
        req.first_token_t = self.stats.on_first_token(req.submit_t)
        req.tokens.append(int(first_tok))
        slot = self.free.pop(0)
        req.slot = slot
        self.running[slot] = req
        return slot

    def requeue(self, req: Request) -> Request:
        """Take a request back into the queue to re-run from its prefill
        (status ``REQUEUED``, ``attempts`` bumped): tokens, slot and
        stamps reset, ``submit_t`` and the absolute deadlines kept, so a
        requeue grants no extra wall time. Its generator is seeded from
        the request seed again, so the rerun draws what a fresh submission
        would. Oldest first: it goes to the head of the queue."""
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"requeued request {req.rid} (prompt {len(req.prompt)} + "
                f"max_new {req.max_new}) exceeds max_len={self.max_len}")
        self._release_pages(req)
        req.page_alloc = None
        req.status = RequestStatus.REQUEUED
        req.attempts += 1
        req.tokens = []
        req.slot = -1
        req.first_token_t = None
        req.finish_t = None
        req.admit_t = None
        req.error = ""
        req.requeue_t = self.stats.clock()
        self.queue.appendleft(req)
        self.stats.on_requeue(len(self.queue))
        return req

    def complete_at_prefill(self, req: Request, first_tok: int) -> Request:
        """max_new == 1, or the first token was eos: done without ever
        occupying a slot."""
        req.first_token_t = self.stats.on_first_token(req.submit_t)
        req.tokens.append(int(first_tok))
        req.finish_t = self.stats.on_retire(len(req.tokens),
                                            req.first_token_t)
        self._release_pages(req)
        return req

    # -------------------------------------------------------------- decode
    def on_step(self, toks: np.ndarray, dones: np.ndarray) -> list:
        """Account one slot decode step: per-slot next tokens + done flags
        (device read-back). Returns the requests retired this step."""
        finished = []
        for slot in sorted(self.running):
            req = self.running[slot]
            req.tokens.append(int(toks[slot]))
            if bool(dones[slot]) or len(req.tokens) >= req.max_new:
                req.status = RequestStatus.OK
                req.finish_t = self.stats.on_retire(len(req.tokens),
                                                    req.first_token_t)
                del self.running[slot]
                self.free.append(slot)
                self._release_pages(req)
                finished.append(req)
        return finished

    def on_spec_step(self, emitted: dict) -> list:
        """Account one speculative verify step: ``emitted`` maps slot to
        the tokens the step committed for it (the carry token's
        verification and every accepted draft, at least one, cut at the
        first eos by the engine). A request retires on the predicate of
        :meth:`on_step` applied to its last committed token, so on the
        step the plain lane would have reached that token.

        A paged retirement first rolls its pages back to the committed KV
        extent (``prompt + tokens - 1``: the last token is the next carry,
        its KV never written) through :meth:`~.pages.PagePool.truncate`,
        then releases them as usual; the release's ``on_release`` hook
        points the slot's table row at scratch and marks the engine's
        table dirty."""
        finished = []
        for slot in sorted(emitted):
            req = self.running.get(slot)
            toks = emitted[slot]
            if req is None or not toks:
                continue
            req.tokens.extend(int(t) for t in toks)
            hit_eos = self.eos_token_id is not None \
                and int(req.tokens[-1]) == self.eos_token_id
            if hit_eos or len(req.tokens) >= req.max_new:
                req.status = RequestStatus.OK
                req.finish_t = self.stats.on_retire(len(req.tokens),
                                                    req.first_token_t)
                del self.running[slot]
                self.free.append(slot)
                if self.pages is not None:
                    self.pages.truncate(
                        req.rid, len(req.prompt) + len(req.tokens) - 1)
                self._release_pages(req)
                finished.append(req)
        return finished

    # ------------------------------------------------------------- guards
    def abort(self, req: Request, status: RequestStatus,
              error: str = "") -> Request:
        """Terminate ``req`` with a non-OK status: free its slot if it
        holds one, record the typed outcome, count it in Serve/*. The
        engine uses this for requests it holds itself (the in-flight
        prefill); queue/slot residents go through :meth:`cancel` /
        :meth:`expire_deadlines`."""
        if req.slot >= 0 and self.running.get(req.slot) is req:
            del self.running[req.slot]
            self.free.append(req.slot)
        req.status = status
        req.error = error
        req.finish_t = self.stats.on_abort(status)
        self._release_pages(req)
        return req

    def cancel(self, rid: int) -> Optional[Request]:
        """Cancel a queued or running request by id; returns it (status
        ``CANCELLED``) or None if this scheduler doesn't hold it (already
        finished, unknown, or held by the engine's prefill lane)."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self.stats.registry.gauge("Serve/queue_depth").set(
                    len(self.queue))
                return self.abort(req, RequestStatus.CANCELLED,
                                  "cancelled while queued")
        for req in list(self.running.values()):
            if req.rid == rid:
                return self.abort(req, RequestStatus.CANCELLED,
                                  "cancelled while decoding")
        return None

    def expire_deadlines(self, now: float) -> list:
        """Retire every request whose deadline passed: queued requests
        against BOTH deadlines (a request that cannot make TTFT from the
        queue is dead weight), running requests against the total-wall
        one (their first token already landed). Returns the expired
        requests, status ``TIMEOUT``."""
        expired = []
        for req in [r for r in self.queue
                    if (r.deadline_ttft is not None and now >= r.deadline_ttft)
                    or (r.deadline_total is not None
                        and now >= r.deadline_total)]:
            self.queue.remove(req)
            which = "ttft" if (req.deadline_ttft is not None
                              and now >= req.deadline_ttft) else "total"
            expired.append(self.abort(req, RequestStatus.TIMEOUT,
                                      f"{which} deadline expired in queue"))
        if expired:
            self.stats.registry.gauge("Serve/queue_depth").set(len(self.queue))
        for req in list(self.running.values()):
            if req.deadline_total is not None and now >= req.deadline_total:
                expired.append(self.abort(req, RequestStatus.TIMEOUT,
                                          "total deadline expired"))
        return expired

    def retire_nonfinite(self, bad_slots) -> list:
        """The per-row logit guard tripped: retire exactly the poisoned
        slots' requests with ``NONFINITE``. Called BEFORE ``on_step``
        accounting, so the poisoned row's garbage token of this step is
        never appended; every other slot's bookkeeping is untouched."""
        out = []
        for slot in bad_slots:
            req = self.running.get(int(slot))
            if req is not None:
                out.append(self.abort(
                    req, RequestStatus.NONFINITE,
                    f"non-finite logits in slot {int(slot)}"))
        return out

    # ------------------------------------------------------------- readout
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def occupancy(self) -> int:
        return len(self.running)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.running
