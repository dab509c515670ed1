"""Where the port's unported features are queued: ROADMAP.md, queue 1.

Every ``NotImplementedError`` of the port names its item through
:func:`later`, so the number and the title change in one place when the
queue is renumbered (``tests/test_torch_package.py`` checks each against
ROADMAP.md).
"""

from __future__ import annotations

# item number -> the start of its bold title in ROADMAP.md, queue 1
ITEMS = {
    1: "sparse attention",
    2: "multi-rank ZeRO and checkpoints",
    3: "ServingEngine",
    4: "MoE",
    5: "tensor and expert parallelism",
    6: "speculation",
    7: "KV tiers, fleet and host native code",
    8: "observability",
    9: "off the main path",
}


def later(item: int) -> str:
    """``"ROADMAP.md queue 1, item N (title)"`` for an error message."""
    return f"ROADMAP.md queue 1, item {item} ({ITEMS[item]})"
