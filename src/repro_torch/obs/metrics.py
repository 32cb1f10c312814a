"""Unified metrics registry: counters, gauges, percentile histograms.

The repo's observable surfaces grew counters ad hoc — bare attributes on
stores, hand-assembled ``summary()`` dicts, per-benchmark percentile math.
The registry is the one sink they can all feed: get-or-create named
instruments, observe values, and read back a ``repro.stats``-style typed
snapshot whose key set cannot drift from the instrument names.

Thread-safe (the prefetch worker counts promotions while a request thread
counts loads); cheap enough for per-request paths (one dict lookup + one
locked add per observation).  ``percentile`` here is the ONE index
convention every plane reports with — ``core.trace`` re-exports it, so the
sim's summaries, the serverless sink, and these histograms agree.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Sequence

from repro_torch.stats import Snapshot


def percentile(xs: Sequence[float], q: float) -> float:
    """The ONE percentile index convention every plane reports with:
    sorted values, index ``min(n - 1, int(n * q))``, 0.0 on empty input.
    ``core.cluster.summarize`` and the serverless ``MetricsSink`` both
    route through here (via ``core.trace``), so fig8/fig16 percentiles
    cannot drift apart (tests/test_serverless.py pins the convention)."""
    xs = sorted(xs)
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, int(len(xs) * q))]


class Counter:
    """Monotone named count."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins named value."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded-reservoir percentile histogram.

    Keeps every observation up to `max_samples`, then drops the OLDEST —
    percentiles describe the recent window of a long-lived process and the
    buffer cannot grow without bound.  Count/sum are exact regardless."""

    __slots__ = ("name", "_samples", "_cursor", "max_samples", "count",
                 "sum", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 max_samples: int = 4096):
        self.name = name
        self.max_samples = max_samples
        self._samples: list[float] = []
        self._cursor = 0  # ring write position once full
        self.count = 0
        self.sum = 0.0
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            else:
                self._samples[self._cursor] = v
                self._cursor = (self._cursor + 1) % self.max_samples

    def percentile(self, q: float) -> float:
        with self._lock:
            return percentile(self._samples, q)

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> dict[str, float]:
        with self._lock:
            xs = sorted(self._samples)
        n = len(xs)

        def pick(q: float) -> float:
            return xs[min(n - 1, int(n * q))] if n else 0.0

        return {"count": self.count, "sum": self.sum, "mean": self.mean(),
                "p50": pick(0.50), "p95": pick(0.95), "p99": pick(0.99),
                "max": xs[-1] if n else 0.0}


@dataclass(frozen=True)
class MetricsStats(Snapshot):
    """Typed registry snapshot (repro.stats convention): instrument name ->
    value (counters/gauges) or summary dict (histograms)."""

    counters: dict = None  # type: ignore[assignment]
    gauges: dict = None  # type: ignore[assignment]
    histograms: dict = None  # type: ignore[assignment]


class MetricsRegistry:
    """Get-or-create named instruments + one typed snapshot of them all."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name, self._lock)
        return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, self._lock)
        return g

    def histogram(self, name: str, *, max_samples: int = 4096) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, self._lock,
                                                       max_samples)
        return h

    def absorb(self, counts: dict, *, prefix: str = "") -> None:
        """Fold a legacy counter dict (``fault_summary()``, ``summary()``)
        into named counters — the migration path off scattered dicts."""
        for k, v in counts.items():
            if isinstance(v, dict):
                self.absorb(v, prefix=f"{prefix}{k}.")
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                self.counter(f"{prefix}{k}").inc(int(v))

    def snapshot(self) -> MetricsStats:
        with self._lock:
            counters = {n: c.value for n, c in sorted(self._counters.items())}
            gauges = {n: g.value for n, g in sorted(self._gauges.items())}
            hists = list(sorted(self._histograms.items()))
        return MetricsStats(
            counters=counters, gauges=gauges,
            histograms={n: h.summary() for n, h in hists})
