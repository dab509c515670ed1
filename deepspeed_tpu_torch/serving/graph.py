"""The slot decode step's forward as one CUDA graph.

The JAX serving engine runs ONE compiled decode-step program whichever
requests occupy the slots, and counts its builds (``compiles``) to show
that none happens after warm-up. Its counterpart here: the forward half of
the slot step (``forward_with_cache`` over the slots' carry tokens, the
length update, the logit guard) captured once into a CUDA graph over the
slot state's static tensors and replayed every iteration, with a capture
counter that must stay at 1. Sampling stays outside the graph: per-slot
generators are swapped at insert time, which a graph cannot follow.

Under tensor / expert parallelism the captured forward holds the step's
NCCL collectives. Their communicators come up at the eager warm-up step,
which issues every one of them on the same groups before the capture (NCCL
cannot create one inside a capture). The capture runs in
``thread_local`` error mode, so ProcessGroupNCCL's watchdog thread may
still query the events of earlier collectives while this thread captures,
and with Python's cyclic garbage collector paused: a collection inside the
capture could destroy an unreachable engine's CUDA graph, an operation a
capturing stream does not permit.

With speculation on, the verify forward (``max_draft + 1`` tokens a slot:
the carry token and the drafts, read from a static draft buffer) is a
second ``SlotGraph`` over the same slot state, captured once after its own
eager warm-up and sharing the slot step's memory pool: the two graphs never
run at once, and each one's outputs are read before the other replays.

No fallback: a failed capture or replay raises; the CPU never graphs.
"""

from __future__ import annotations

import gc

import torch

from ..comm import comm
from ..ops import registry


class SlotGraph:
    """``forward() -> outputs`` captured once, replayed on demand.

    ``forward`` must read and write only tensors whose storage never moves
    (the slot state's); its outputs live in the graph's memory pool and are
    rewritten by every replay. Capture after one eager call of the same
    work, so that every workspace the kernels cache per device
    (``ops/registry.py``'s ``Workspace``) exists before capture: their
    tickets return to zero after each call, so a replay needs no memset.
    The graph keeps every workspace cached at capture alive: a later call
    that grows one replaces it in the cache, and the graph must not write
    into freed memory."""

    def __init__(self):
        self._graph = None
        self._out = None
        self._keep = ()
        self.captures = 0
        self.replays = 0
        # the registered kernel wrappers' launches recorded in the capture,
        # those that launched: a replay runs them without calling the
        # wrappers, whose counters only tick at capture
        self.captured_launches: dict = {}
        # the collectives recorded in the capture, by kind (comm.issued)
        self.captured_collectives: dict = {}

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def capture(self, forward, pool=None) -> None:
        """Capture ``forward()``; an error in it raises, and nothing is
        kept. ``pool``: another graph's memory pool (``SlotGraph.pool``) to
        allocate from, or None for a private one."""
        before = registry.launch_counts()
        issued = dict(comm.issued)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = forward()
        finally:
            if collecting:
                gc.enable()
        self._graph, self._out = graph, out
        self._keep = registry.workspace_buffers()
        after = registry.launch_counts()
        self.captured_launches = {k: n - before.get(k, 0)
                                  for k, n in after.items()
                                  if n != before.get(k, 0)}
        self.captured_collectives = {k: n - issued[k]
                                     for k, n in comm.issued.items()
                                     if n != issued[k]}
        self.captures += 1

    @property
    def pool(self):
        """The captured graph's memory pool handle (None before capture)."""
        return self._graph.pool() if self._graph is not None else None

    def replay(self):
        """Run the captured work once; returns the capture's outputs,
        which hold this replay's values."""
        self._graph.replay()
        self.replays += 1
        return self._out
