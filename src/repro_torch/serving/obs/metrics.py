"""Metrics registry: counters, gauges, histograms with explicit buckets
(``repro.serving.obs.metrics``).

One registry instance lives on a :class:`~repro_torch.serving.obs.Tracer`
and is the single accumulation point for serving statistics — the
``MetricsStreamer`` reads its counters instead of re-deriving them from
scattered engine fields, and the JSONL export serialises ``to_dict()``
verbatim.  Everything here is plain Python arithmetic on ``__slots__``
objects so the hot-path cost of an ``observe()`` is one bisect plus three
adds.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LATENCY_BUCKETS", "QUEUE_DEPTH_BUCKETS", "BATCH_OCCUPANCY_BUCKETS",
    "DEPTH_BUCKETS",
]

# explicit bucket edges (upper bounds, seconds / counts).  A value lands in
# the first bucket whose edge is >= value; values past the last edge go to
# the overflow bucket.
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 2.0)
QUEUE_DEPTH_BUCKETS: Tuple[float, ...] = (0, 1, 2, 4, 8, 16, 32, 64, 128)
BATCH_OCCUPANCY_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32)
DEPTH_BUCKETS: Tuple[float, ...] = (0, 1, 2, 3, 4, 6, 8)


class Counter:
    """Monotonic count (requests admitted, rejected, windows closed...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, v: int = 1) -> None:
        self.value += v

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-observed level (queue depth, live cache entries...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram; ``counts[-1]`` is the overflow bucket."""

    __slots__ = ("name", "buckets", "counts", "n", "total")

    def __init__(self, name: str, buckets: Sequence[float]):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name!r}: buckets must be a "
                             f"non-empty sorted sequence, got {buckets!r}")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.n = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.n += 1
        self.total += v

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def to_dict(self) -> dict:
        return {"type": "histogram", "buckets": list(self.buckets),
                "counts": list(self.counts), "n": self.n,
                "sum": self.total}


class MetricsRegistry:
    """Named metric instruments, created on first use.

    ``serving_default()`` pre-creates the standard serving instruments so
    hot paths can cache direct references instead of doing dict lookups.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def counter(self, name: str) -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name)
        return m

    def gauge(self, name: str) -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Gauge(name)
        return m

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(
                name, buckets if buckets is not None else LATENCY_BUCKETS)
        return m

    def names(self):
        return sorted(self._metrics)

    def to_dict(self) -> dict:
        return {name: m.to_dict()
                for name, m in sorted(self._metrics.items())}

    @classmethod
    def serving_default(cls) -> "MetricsRegistry":
        reg = cls()
        # "capped" counts every degraded-not-dropped outcome (admission
        # depth caps + intake shed-optional), mirroring MetricsStreamer
        for c in ("requests_admitted", "requests_rejected",
                  "requests_capped", "requests_missed",
                  "windows_closed", "dispatches", "topoffs", "pullins"):
            reg.counter(c)
        reg.gauge("queue_depth")
        reg.histogram("latency", LATENCY_BUCKETS)
        reg.histogram("queue_wait", LATENCY_BUCKETS)
        reg.histogram("queue_depth_sampled", QUEUE_DEPTH_BUCKETS)
        reg.histogram("batch_occupancy", BATCH_OCCUPANCY_BUCKETS)
        reg.histogram("depth_served", DEPTH_BUCKETS)
        return reg
