"""Typed outcomes callers can branch on (counterpart of
``deepspeed_tpu/resilience/guards.py``): the serving request statuses and
sheds, the training sentinel's halt and the checkpoint integrity error."""

from __future__ import annotations

import enum


class RequestStatus(enum.Enum):
    """Outcome of a served request (``Request.status``).

    ``OK``        — finished normally (eos or max_new reached);
    ``NONFINITE`` — the per-row logit guard saw NaN/Inf in this request's
                    logits and retired it (other slots are untouched);
    ``TIMEOUT``   — a TTFT or total-wall deadline expired;
    ``CANCELLED`` — ``cancel(rid)`` retired it;
    ``SHED``      — rejected at admission (queue full / draining), the
                    status carried by :class:`QueueFullError`;
    ``REQUEUED``  — not terminal: ``requeue`` took the request back into
                    the queue (``Request.attempts`` counts the moves); it
                    finishes later with one of the statuses above.
    """

    OK = "ok"
    NONFINITE = "nonfinite"
    TIMEOUT = "timeout"
    CANCELLED = "cancelled"
    SHED = "shed"
    REQUEUED = "requeued"


class QueueFullError(RuntimeError):
    """``submit()`` rejected a request: the queue is at capacity or the
    engine is draining. Callers back off on ``.status`` / ``.queue_depth``
    rather than on the message."""

    status = RequestStatus.SHED

    def __init__(self, message: str, queue_depth: int | None = None,
                 max_queue: int | None = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.max_queue = max_queue


class PagePoolExhausted(QueueFullError):
    """``submit()`` rejected a request the paged KV pool can never hold:
    its worst-case page count (``ceil((prompt + max_new - 1) /
    page_size)``, with no prefix sharing assumed, since shared pages can
    be evicted from under a queued request) exceeds the pool's usable
    pages. Status ``SHED``, like every admission refusal; a TRANSIENTLY
    full pool never raises: the request waits at the queue head until a
    retirement frees pages."""

    def __init__(self, message: str, pages_needed: int | None = None,
                 pages_usable: int | None = None):
        super().__init__(message)
        self.pages_needed = pages_needed
        self.pages_usable = pages_usable


class NonFiniteLossError(RuntimeError):
    """The training-side sentinel: raised after K consecutive bad optimizer
    steps (fp16 overflow skips, or a non-finite loss at a report boundary)
    so a collapsed run halts instead of burning the rest of its budget.
    Carries the streak and the last loss for the post-mortem."""

    def __init__(self, message: str, streak: int = 0,
                 last_loss: float | None = None):
        super().__init__(message)
        self.streak = streak
        self.last_loss = last_loss


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint tag failed manifest verification (missing commit
    marker, size or checksum mismatch) and no fallback was possible, or the
    caller pinned that tag, where a silent fallback would be worse than
    failing."""

    def __init__(self, message: str, tag: str | None = None,
                 reason: str | None = None):
        super().__init__(message)
        self.tag = tag
        self.reason = reason
