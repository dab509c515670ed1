"""What the kernel wrappers keep across calls, in one registry each: their
launch counters and their cached device workspaces.

A CUDA graph captured over a wrapper's launches replays them without
calling the wrapper, and reads the wrapper's workspace by address.
``serving/graph.py`` reads both registries around a capture: the counters'
deltas are the launches every replay makes, and :func:`workspace_buffers`
names every buffer the capture may have bound, which the graph keeps alive
while it may replay. A wrapper registered here is covered without any
change to the graph.
"""

from __future__ import annotations

import torch

_counted: list = []
_workspaces: list = []


def counted(fn):
    """Register a kernel wrapper whose ``launches`` counts its kernel's
    launches: the wrapper adds one where it launches, and nowhere else."""
    fn.launches = 0
    _counted.append(fn)
    return fn


def launch_counts() -> dict:
    """``{wrapper name: launches}`` of every registered wrapper."""
    return {fn.__name__: fn.launches for fn in _counted}


class Workspace:
    """A split kernel's fp32 partials and zeroed int32 tickets, cached per
    device and grown when a call needs more. Each call leaves the tickets
    zero; calls on one device run in stream order. A call that grows a
    buffer replaces it here, so a graph that captured the old one must hold
    it itself (:func:`workspace_buffers`)."""

    def __init__(self):
        self._by_device: dict = {}
        _workspaces.append(self)

    def __call__(self, device, floats: int, tickets: int):
        ws, tk = self._by_device.get(device.index, (None, None))
        if ws is None or ws.numel() < floats:
            ws = torch.empty(max(floats, 1), dtype=torch.float32,
                             device=device)
        if tk is None or tk.numel() < tickets:
            tk = torch.zeros(max(tickets, 1), dtype=torch.int32,
                             device=device)
        self._by_device[device.index] = (ws, tk)
        return ws, tk


def workspace_buffers() -> tuple:
    """Every workspace buffer cached now, on every device."""
    return tuple(t for w in _workspaces for pair in w._by_device.values()
                 for t in pair)
