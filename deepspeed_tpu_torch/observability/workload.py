"""The prefix hashes that key the KV tiers (counterpart of the two hash
functions of ``deepspeed_tpu/observability/workload.py``; the workload
model itself is ROADMAP.md queue 1 item 7).

A block-aligned prefix of a prompt is keyed by ``(length, hash)``, the
hash a polynomial rolling hash over the tokens. The constants and the
arithmetic are the JAX package's, so both packages key the same prefix
with the same integer.
"""

from __future__ import annotations

import numpy as np

__all__ = ["prefix_hashes", "token_hash", "extend_hash"]

_HASH_P = 1_000_003
_HASH_M = (1 << 61) - 1


def prefix_hashes(tokens, block: int) -> list:
    """Rolling hash of every ``block``-aligned prefix of ``tokens``:
    ``[(length, hash), ...]`` for lengths ``block, 2*block, ...`` in one
    pass, each entry extending the previous hash."""
    out = []
    h = 0
    for i, t in enumerate(np.asarray(tokens).reshape(-1).tolist()):
        h = (h * _HASH_P + (int(t) + 1)) % _HASH_M
        if (i + 1) % block == 0:
            out.append((i + 1, h))
    return out


def token_hash(tokens) -> int:
    """The same rolling hash over a whole token sequence."""
    h = 0
    for t in np.asarray(tokens).reshape(-1).tolist():
        h = (h * _HASH_P + (int(t) + 1)) % _HASH_M
    return h


def extend_hash(h: int, tokens) -> int:
    """The rolling hash ``h`` of a prefix extended by ``tokens``:
    ``extend_hash(token_hash(a), b) == token_hash(a + b)``."""
    for t in tokens:
        h = (h * _HASH_P + (int(t) + 1)) % _HASH_M
    return h
