"""``ServingStats``: the serving engine's load accounting (counterpart of
``deepspeed_tpu/observability/tracing.py:147``; the per-``generate()``
request tracer is ROADMAP.md queue 1 item 7).

Every time is read from an injectable clock, so the scheduler's accounting
runs under a fake clock in tests, with no device.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from .metrics import MetricsRegistry


class ServingStats:
    """Scheduler-side serving accounting: queue depth, slot occupancy, admission/retirement counters, per-request TTFT
    and TPOT *under load* (a request's first token waits behind whatever
    the scheduler interleaved before it), and aggregate goodput — completed
    tokens per second across all requests, the number static batching
    leaves on the table. Everything lands in ``Serve/*`` names of a
    :class:`~.metrics.MetricsRegistry`.

    ``clock`` is injectable (fake-clock scheduler tests drive admission /
    retirement order without a device).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.clock = clock
        self._t0: Optional[float] = None     # first admission: goodput window
        self.completed_tokens = 0
        # time-weighted occupancy: (last sample time, fraction held since)
        # — Serve/slot_occupancy is point-in-time, the average is not
        self._occ_prev: Optional[tuple] = None
        self._occ_time = 0.0
        self._occ_weighted = 0.0
        self._last_submit_t: Optional[float] = None

    def reset(self) -> None:
        """Clear every Serve/* series and restart the goodput window
        (between a warm-up pass and a measured one)."""
        self.registry.reset()
        self._t0 = None
        self.completed_tokens = 0
        self._occ_prev = None
        self._occ_time = 0.0
        self._occ_weighted = 0.0
        self._last_submit_t = None

    # ---------------------------------------------------- request lifecycle
    def on_submit(self, queue_depth: int) -> float:
        t = self.clock()
        r = self.registry
        r.counter("Serve/submitted").inc()
        # sampled at SUBMIT time (not only on admission): a flooded queue
        # between admissions must not read a stale depth on scrape
        r.gauge("Serve/queue_depth").set(queue_depth)
        if self._last_submit_t is not None:
            # the arrival process, as the JAX package records it
            r.histogram("Serve/interarrival_s").observe(
                t - self._last_submit_t)
        self._last_submit_t = t
        return t

    def on_admit(self, queue_depth: int,
                 submit_t: Optional[float] = None) -> float:
        t = self.clock()
        if self._t0 is None:
            self._t0 = t
        r = self.registry
        r.counter("Serve/admitted").inc()
        r.gauge("Serve/queue_depth").set(queue_depth)
        if submit_t is not None:
            # admission wait: how long the request sat in the queue
            # before the scheduler picked it
            r.histogram("Serve/queue_wait_s").observe(t - submit_t)
        return t

    def on_first_token(self, submit_t: float) -> float:
        t = self.clock()
        self.registry.histogram("Serve/ttft_s").observe(t - submit_t)
        return t

    def on_retire(self, n_tokens: int, first_token_t: float) -> float:
        """A request finished with ``n_tokens`` generated."""
        t = self.clock()
        r = self.registry
        r.counter("Serve/retired").inc()
        r.counter("Serve/completed_tokens").inc(n_tokens)
        self.completed_tokens += n_tokens
        if n_tokens > 1:
            r.histogram("Serve/tpot_s").observe(
                (t - first_token_t) / (n_tokens - 1))
        if self._t0 is not None and t > self._t0:
            r.gauge("Serve/goodput_tps").set(
                self.completed_tokens / (t - self._t0))
        return t

    # ------------------------------------------------------ guard outcomes
    def on_shed(self, queue_depth: int) -> None:
        """A submit was rejected (queue full / draining) — the SHED path."""
        self.registry.counter("Serve/shed").inc()
        self.registry.gauge("Serve/queue_depth").set(queue_depth)

    def on_abort(self, status) -> float:
        """A request terminated with a non-OK :class:`RequestStatus`
        (TIMEOUT / CANCELLED / NONFINITE): per-status counter, no goodput
        credit (aborted tokens are not completed work)."""
        t = self.clock()
        name = getattr(status, "value", str(status))
        self.registry.counter(f"Serve/{name}").inc()
        self.registry.counter("Serve/aborted").inc()
        return t

    def on_requeue(self, queue_depth: int) -> None:
        """``requeue`` took a request back into the queue (status
        ``REQUEUED``, attempts bumped)."""
        r = self.registry
        r.counter("Serve/requeued").inc()
        r.gauge("Serve/queue_depth").set(queue_depth)

    def on_requeue_delay(self, delay_s: float) -> None:
        """A REQUEUED request was re-admitted ``delay_s`` after its
        requeue: its own histogram, so the delay stays separable from
        TTFT."""
        self.registry.histogram("Serve/requeue_delay_s").observe(delay_s)

    def on_results_evicted(self) -> None:
        """The bounded results store dropped its oldest finished request
        (nobody collected it)."""
        self.registry.counter("Serve/results_evicted").inc()

    # ------------------------------------------------------- per-iteration
    def on_iteration(self, queue_depth: int, occupied: int, slots: int,
                     prefill_chunk: bool, decode_ran: bool = False) -> None:
        r = self.registry
        r.counter("Serve/iterations").inc()
        if prefill_chunk:
            r.counter("Serve/prefill_chunks").inc()
        if decode_ran:
            # decode_steps x slots is the slot-step work the batch paid
            r.counter("Serve/decode_steps").inc()
        r.gauge("Serve/queue_depth").set(queue_depth)
        frac = occupied / max(1, slots)
        r.gauge("Serve/slot_occupancy").set(frac)
        # time-weighted average on the injectable clock: the PREVIOUS
        # sample's fraction held over the interval that just elapsed
        # (left-continuous integral)
        t = self.clock()
        if self._occ_prev is not None:
            t0, f0 = self._occ_prev
            dt = t - t0
            if dt > 0:
                self._occ_time += dt
                self._occ_weighted += f0 * dt
                r.gauge("Serve/slot_occupancy_avg").set(
                    self._occ_weighted / self._occ_time)
        self._occ_prev = (t, frac)

    def snapshot(self) -> dict:
        snap = self.registry.snapshot()
        c, g, h = snap["counters"], snap["gauges"], snap["histograms"]
        return {
            "submitted": int(c.get("Serve/submitted", 0)),
            "admitted": int(c.get("Serve/admitted", 0)),
            "retired": int(c.get("Serve/retired", 0)),
            "completed_tokens": int(c.get("Serve/completed_tokens", 0)),
            "iterations": int(c.get("Serve/iterations", 0)),
            "prefill_chunks": int(c.get("Serve/prefill_chunks", 0)),
            "decode_steps": int(c.get("Serve/decode_steps", 0)),
            # guard outcomes: sheds, per-status aborts, results-store
            # evictions
            "shed": int(c.get("Serve/shed", 0)),
            "aborted": int(c.get("Serve/aborted", 0)),
            "timeout": int(c.get("Serve/timeout", 0)),
            "cancelled": int(c.get("Serve/cancelled", 0)),
            "nonfinite": int(c.get("Serve/nonfinite", 0)),
            "results_evicted": int(c.get("Serve/results_evicted", 0)),
            "requeued": int(c.get("Serve/requeued", 0)),
            "queue_depth": g.get("Serve/queue_depth"),
            "slot_occupancy": g.get("Serve/slot_occupancy"),
            "slot_occupancy_avg": g.get("Serve/slot_occupancy_avg"),
            "goodput_tps": g.get("Serve/goodput_tps"),
            "ttft_s": h.get("Serve/ttft_s", {}),
            "tpot_s": h.get("Serve/tpot_s", {}),
            "queue_wait_s": h.get("Serve/queue_wait_s", {}),
            "interarrival_s": h.get("Serve/interarrival_s", {}),
            "requeue_delay_s": h.get("Serve/requeue_delay_s", {}),
        }
