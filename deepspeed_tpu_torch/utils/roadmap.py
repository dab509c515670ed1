"""Where the port's unported features are queued: ROADMAP.md, queue 1.

Every ``NotImplementedError`` of the port names its item through
:func:`later`, so the number and the title change in one place when the
queue is renumbered (``tests/test_torch_package.py`` checks each against
ROADMAP.md). An item split into parts names the part too: ``later(6,
"c")``.
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


# (item, part) -> the start of the part's bold title in ROADMAP.md; item 6's
# part (a), the KV tiers, is ported
PARTS = {
    (6, "b"): "ZeRO-Offload",
    (6, "c"): "the fleet",
}


def later(item, part: str = "") -> str:
    """``"ROADMAP.md queue 1, item N (title)"`` for an error message, and
    ``", part N(p) (title)"`` after it for a part of a split item. ``item``
    may be an ``(item, part)`` pair, as the config tables hold it."""
    if isinstance(item, tuple):
        item, part = item
    out = f"ROADMAP.md queue 1, item {item} ({ITEMS[item]})"
    if part:
        out += f", part {item}({part}) ({PARTS[item, part]})"
    return out
