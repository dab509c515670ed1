"""Self-speculative (prompt-lookup) drafting: the n-gram drafter.

Counterpart of ``deepspeed_tpu/inference/speculation.py``, kept as the
port's own copy (plain Python and numpy). The "draft model" is an n-gram
table over a request's OWN token history (prompt + everything emitted so
far), so no extra weights are resident and acceptance is pure profit on
repetitive traffic. The serving engine (``serving/engine.py``) drafts up to
``max_draft`` tokens a slot, verifies every slot's carry token and drafts
in one fixed-shape ``max_draft + 1``-token forward (a second CUDA graph on
the card, ``serving/graph.py``), accepts on the host and commits the
accepted extent; under greedy sampling the served tokens equal plain
decode's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

__all__ = ["SpeculationConfig", "NGramTable", "acceptance_stats"]


@dataclass
class SpeculationConfig:
    """The ``serving.speculation`` block.

    ``ngram`` is the context length of the lookup table; ``max_draft`` the
    per-step draft ceiling, so the verify forward is a fixed
    ``max_draft + 1``-token program. Speculation needs greedy sampling
    (the parity guarantee is argmax chaining); the serving engine enforces
    that at construction."""

    enabled: bool = True
    ngram: int = 3
    max_draft: int = 4

    def __post_init__(self):
        if self.ngram < 1:
            raise ValueError(f"speculation.ngram must be >= 1, got {self.ngram}")
        if self.max_draft < 1:
            raise ValueError(
                f"speculation.max_draft must be >= 1, got {self.max_draft}")

    @classmethod
    def from_any(cls, obj) -> "SpeculationConfig":
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, dict):
            unknown = set(obj) - set(cls.__dataclass_fields__)
            if unknown:
                raise ValueError(
                    f"unknown speculation config keys: {sorted(unknown)}")
            return cls(**obj)
        raise TypeError(f"cannot build SpeculationConfig from {type(obj)!r}")


class NGramTable:
    """Most-recent-occurrence n-gram lookup over one token stream.

    ``extend`` feeds tokens in order; each full ``ngram``-length context
    maps to the token that followed it, last write wins. ``predict`` looks
    up the current trailing context; ``draft`` chains predictions (each
    predicted token fed back as context) until the table has no entry or
    ``k`` tokens are drafted."""

    __slots__ = ("ngram", "_table", "_ctx")

    def __init__(self, ngram: int):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.ngram = int(ngram)
        self._table: dict = {}
        self._ctx: tuple = ()

    def __len__(self) -> int:
        return len(self._table)

    def extend(self, tokens: Sequence[int]) -> None:
        ctx, n = self._ctx, self.ngram
        for t in tokens:
            t = int(t)
            if len(ctx) == n:
                self._table[ctx] = t
            ctx = (ctx + (t,))[-n:]
        self._ctx = ctx

    def predict(self) -> Optional[int]:
        if len(self._ctx) != self.ngram:
            return None
        return self._table.get(self._ctx)

    def draft(self, k: int) -> list:
        """Chain up to ``k`` predictions from the trailing context; stop at
        the first context with no entry. A pure read: neither the table
        nor the trailing context moves."""
        if len(self._ctx) != self.ngram or k <= 0:
            return []
        out = []
        ctx = self._ctx
        for _ in range(k):
            pred = self._table.get(ctx)
            if pred is None:
                break
            out.append(pred)
            ctx = (ctx + (pred,))[-self.ngram:]
        return out


def acceptance_stats(tokens, ngram: int) -> Optional[dict]:
    """Score a finished token stream as if the drafter had run over it: at
    each position past the first ``ngram`` tokens, would the table (built
    from the stream so far) have predicted the actual next token?

    None when the stream is too short to score, else ``scored`` (positions
    scored), ``predicted`` (positions with a prediction), ``hits``
    (predictions that matched), ``rate`` = hits / scored (no prediction
    counts as a miss) and ``hit_rate`` = hits / predicted (what the live
    drafter's first-draft accept rate converges to)."""
    toks = np.asarray(tokens).reshape(-1).tolist()
    n = len(toks)
    if n <= ngram:
        return None
    tab = NGramTable(ngram)
    tab.extend(toks[:ngram])
    hits = predicted = 0
    for t in toks[ngram:]:
        pred = tab.predict()
        if pred is not None:
            predicted += 1
            if pred == int(t):
                hits += 1
        tab.extend((int(t),))
    scored = n - ngram
    return {
        "scored": scored,
        "predicted": predicted,
        "hits": hits,
        "rate": hits / scored,
        "hit_rate": (hits / predicted) if predicted else None,
    }
