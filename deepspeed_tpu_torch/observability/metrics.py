"""Counters, gauges and histograms with rolling reservoirs: the part of
``deepspeed_tpu/observability/metrics.py`` that ``ServingStats`` records
into. Host-side Python over plain floats: recording never touches a device
tensor, so it adds no host-device synchronisation. The sinks and the
monitor fan-out are ROADMAP.md queue 1 item 7.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable, Optional

# Percentiles every histogram reports (nearest-rank over the rolling window).
DEFAULT_PERCENTILES = (50, 90, 99)


class Reservoir:
    """Rolling window of the most recent ``size`` observations.

    A plain ring buffer, not Vitter sampling: serving percentiles should
    reflect *recent* traffic (a latency regression must show up in p99 now,
    not diluted by the whole process history), and the window is small
    enough that keeping every recent sample exactly is cheaper than being
    clever."""

    def __init__(self, size: int = 1024):
        if size <= 0:
            raise ValueError(f"reservoir size must be positive, got {size}")
        self.size = int(size)
        self._buf: list[float] = []
        self._idx = 0          # next write slot once the buffer is full
        # sort cache, invalidated on add(): readers take several
        # percentiles of one window. Guarded by the owning Histogram's lock.
        self._sorted: Optional[list[float]] = None

    def add(self, value: float) -> None:
        v = float(value)
        if len(self._buf) < self.size:
            self._buf.append(v)
        else:
            self._buf[self._idx] = v
            self._idx = (self._idx + 1) % self.size
        self._sorted = None

    def _sorted_buf(self) -> list[float]:
        if self._sorted is None:
            self._sorted = sorted(self._buf)
        return self._sorted

    def __len__(self) -> int:
        return len(self._buf)

    def values(self) -> list[float]:
        return list(self._buf)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the window (q in [0, 100])."""
        if not self._buf:
            return math.nan
        s = self._sorted_buf()
        rank = max(1, math.ceil(q / 100.0 * len(s)))
        return s[min(rank, len(s)) - 1]

    def percentiles(self, qs: Iterable[float] = DEFAULT_PERCENTILES) -> dict:
        if not self._buf:
            return {f"p{_fmt_q(q)}": math.nan for q in qs}
        s = self._sorted_buf()
        out = {}
        for q in qs:
            rank = max(1, math.ceil(q / 100.0 * len(s)))
            out[f"p{_fmt_q(q)}"] = s[min(rank, len(s)) - 1]
        return out


def _fmt_q(q: float) -> str:
    return str(int(q)) if float(q).is_integer() else str(q).replace(".", "_")


class Counter:
    """Monotonic accumulator (requests served, tokens generated, bytes)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: Optional[threading.RLock] = None):
        self.name = name
        self.value = 0.0
        self._lock = lock if lock is not None else threading.RLock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:   # += is a read-modify-write, not atomic
            self.value += n


class Gauge:
    """Last-write-wins scalar (queue depth, occupancy, goodput)."""

    __slots__ = ("name", "value", "updated", "_lock")

    def __init__(self, name: str, lock: Optional[threading.RLock] = None):
        self.name = name
        self.value = math.nan
        self.updated = False
        self._lock = lock if lock is not None else threading.RLock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)
            self.updated = True


class Histogram:
    """Distribution summary: count/sum/last + rolling-window percentiles."""

    def __init__(self, name: str, reservoir_size: int = 1024,
                 percentiles: tuple = DEFAULT_PERCENTILES,
                 lock: Optional[threading.RLock] = None):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.last = math.nan
        self.percentiles = tuple(percentiles)
        self.reservoir = Reservoir(reservoir_size)
        self._lock = lock if lock is not None else threading.RLock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:   # count/sum/reservoir must move together
            self.count += 1
            self.sum += v
            self.last = v
            self.reservoir.add(v)

    def summary(self) -> dict:
        with self._lock:
            out = {"count": self.count,
                   "mean": (self.sum / self.count) if self.count else math.nan,
                   "last": self.last}
            out.update(self.reservoir.percentiles(self.percentiles))
            return out


class MetricsRegistry:
    """Named counters/gauges/histograms behind one shared lock.

    The registry's RLock is handed to every instrument it creates, so
    mutators (``inc``/``set``/``observe``) and ``snapshot`` serialize
    against each other (reentrant because ``snapshot`` holds the lock while
    calling ``Histogram.summary``)."""

    def __init__(self, default_reservoir: int = 1024):
        self._lock = threading.RLock()
        self._default_reservoir = int(default_reservoir)
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # ------------------------------------------------------------ accessors
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, lock=self._lock)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, lock=self._lock)
            return g

    def histogram(self, name: str, reservoir_size: Optional[int] = None,
                  percentiles: tuple = DEFAULT_PERCENTILES) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    name, reservoir_size or self._default_reservoir,
                    percentiles, lock=self._lock)
            return h

    def set_gauges(self, values: dict[str, float]) -> None:
        for k, v in values.items():
            self.gauge(k).set(v)

    # -------------------------------------------------------------- readout
    def snapshot(self) -> dict:
        """Nested machine-readable view of everything recorded so far."""
        with self._lock:
            return {
                "counters": {n: c.value for n, c in self._counters.items()},
                "gauges": {n: g.value for n, g in self._gauges.items()
                           if g.updated},
                "histograms": {n: h.summary()
                               for n, h in self._histograms.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
