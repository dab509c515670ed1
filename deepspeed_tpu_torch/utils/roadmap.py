"""Where the port's unported features are queued: ROADMAP.md, queue 1.

Every ``NotImplementedError`` of the port names its item through
:func:`later`, so the number and the title change in one place when the
queue is renumbered (``tests/test_torch_package.py`` checks each against
ROADMAP.md).
"""

from __future__ import annotations

# item number -> the start of its bold title in ROADMAP.md, queue 1; items
# 1-5 are ported (no call raises them), and keep their numbers and titles
ITEMS = {
    1: "multi-rank ZeRO",
    2: "ServingEngine",
    3: "MoE",
    4: "tensor and expert parallelism",
    5: "speculation",
    6: "KV tiers, fleet and host native code",
    7: "observability",
    8: "off the main path",
}


def later(item: int) -> str:
    """``"ROADMAP.md queue 1, item N (title)"`` for an error message."""
    return f"ROADMAP.md queue 1, item {item} ({ITEMS[item]})"
