"""Process-death fault injection for the checkpoint and training path
(counterpart of the environment-gated half of
``deepspeed_tpu/resilience/chaos.py``).

:func:`kill_point` dies with ``os._exit`` at a named point of the
checkpoint commit; :func:`preempt_step` names the train step at which
:func:`deliver_preemption` raises SIGTERM, a simulated scheduler
preemption. Both are inert unless their environment variable is set: a
library call site costs one dict lookup. Every firing writes an unbuffered
stderr line, so a test asserts both the reaction and that the fault fired.
"""

from __future__ import annotations

import os
import sys

# DSTPU_CHAOS_KILL="<point>" or "<point>:<k>": os._exit(137) at the k-th
# (0-based, default 0) hit of that named kill point.
KILL_ENV = "DSTPU_CHAOS_KILL"
# DSTPU_CHAOS_PREEMPT="<step>": SIGTERM this process at train step <step>.
PREEMPT_ENV = "DSTPU_CHAOS_PREEMPT"

# Named kill points of the checkpoint commit (runtime/checkpoint/engine.py).
# AFTER_STATE: the tag's files are durable but its manifest (the commit
# marker) and the 'latest' flip never happen, so a load resumes from the
# previous verified tag.
KILL_AFTER_STATE_WRITE = "ckpt:after-state-write"
KILL_BEFORE_LATEST_FLIP = "ckpt:before-latest-flip"

_kill_hits: dict[str, int] = {}


def kill_point(name: str) -> None:
    """Die HERE (``os._exit(137)``: no atexit, no finally, the shape of a
    SIGKILL or OOM death) if ``DSTPU_CHAOS_KILL`` names this point.

    Format: ``"point"`` (die on the first hit) or ``"point:k"`` (die on the
    k-th hit, 0-based), so a test can let save #1 commit and kill save #2
    mid-commit."""
    spec = os.environ.get(KILL_ENV)
    if not spec:
        return
    # point names contain ':' themselves: the hit index is only the LAST
    # segment, and only when it is numeric
    point, sep, k = spec.rpartition(":")
    if not sep or not k.isdigit():
        point, k = spec, ""
    if point != name:
        return
    hit = _kill_hits.get(name, 0)
    _kill_hits[name] = hit + 1
    if hit != (int(k) if k else 0):
        return
    sys.stderr.write(f"[chaos] kill_point {name!r} hit {hit}: os._exit(137)\n")
    sys.stderr.flush()
    os._exit(137)


def preempt_step():
    """The train step at which chaos delivers SIGTERM to this process, or
    None. The engine reads it once at construction."""
    spec = os.environ.get(PREEMPT_ENV)
    if not spec:
        return None
    return int(spec)


def deliver_preemption() -> None:
    """Raise SIGTERM in this process: the PreemptionGuard (or the default
    handler) takes it from here, as under a real scheduler."""
    import signal

    sys.stderr.write("[chaos] delivering simulated SIGTERM preemption\n")
    sys.stderr.flush()
    os.kill(os.getpid(), signal.SIGTERM)
