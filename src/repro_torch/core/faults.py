"""Deterministic fault injection — the chaos plane (DESIGN.md §15).

One seeded, replayable `FaultInjector` that BOTH planes consult at named
fault points, so a failure schedule is an input like a workload trace, not
a monkeypatch:

  * ``store.read``      persistent-store read of one tensor blob: mode
                        "error" raises a transient read failure (retryable);
                        mode "corrupt" flips bytes in the stored blob so the
                        crc32 verify-on-promote path detects it (persistent:
                        retries keep failing until the blob is quarantined);
  * ``h2d.chunk``       one chunk of the host→device pipeline: mode "error"
                        fails the `device_put` (retried up to the transfer's
                        bounded budget); mode "stall" sleeps ``delay_s``
                        before the put (absorbed by the transfer timeout);
  * ``prefetch.worker`` the prefetch worker dies at the top of a promotion
                        iteration (the supervisor restarts it, the in-flight
                        job fails over joiners to the inline path);
  * ``engine.crash`` /  fleet-level node death and rejoin — consulted by the
    ``engine.recover``  gateways' `inject_failure` schedules for the ledger.

Determinism contract: a spec names the OCCURRENCE INDICES at which it
fires — "the 3rd store read", "the first read of fingerprint X" — never a
probability against a wall clock.  Occurrences are counted per point
(and per (point, key) for keyed specs), so replaying the same schedule
against the same workload fires the same faults; keyed specs are
additionally robust to benign thread interleaving (whichever thread issues
the first read of tensor X, exactly that read fails).

The injector keeps the chaos LEDGER: `injected` counts per point and `log`
records (point, occurrence, key, mode) tuples, which fig17 balances against
the consumers' handled/quarantined/failed-over counters — every injected
fault must be visible in metrics, none swallowed.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.obs import BoundedLog

#: The named fault points the planes consult (see module docstring).
FAULT_POINTS = ("store.read", "h2d.chunk", "prefetch.worker",
                "engine.crash", "engine.recover")


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire at the given occurrence indices of `point`.

    ``at`` is a tuple of 0-based occurrence indices.  With ``key`` set, the
    indices count occurrences of (point, key) — e.g. "the first read of
    THIS fingerprint" — instead of the point's global counter.  ``mode``
    selects the point-specific failure flavour; ``delay_s`` is the stall
    duration for ``h2d.chunk``/"stall".
    """

    point: str
    at: tuple[int, ...]
    mode: str = "error"
    key: Optional[str] = None
    delay_s: float = 0.0

    def __post_init__(self):
        assert self.point in FAULT_POINTS, self.point


@dataclass
class FaultInjector:
    """Seeded, deterministic fault scheduler + injection ledger.

    Consumers call ``fire(point, key)`` at each fault point; a matching
    spec is returned (the consumer raises/sleeps accordingly) and recorded
    in the ledger, else None.  `fire` is cheap enough for hot paths
    (two dict increments and a small spec scan per call) and consumers
    hold their own locks around it, so the per-point counters never race
    within one engine.
    """

    specs: Sequence[FaultSpec] = ()
    seed: int = 0  # recorded for provenance; schedules are index-based

    def __post_init__(self):
        self._by_point: dict[str, list[FaultSpec]] = defaultdict(list)
        for spec in self.specs:
            self._by_point[spec.point].append(spec)
        self._counts: Counter = Counter()  # point -> occurrences seen
        self._key_counts: Counter = Counter()  # (point, key) -> occurrences
        self.injected: Counter = Counter()  # point -> faults fired
        # (point, idx, key, mode) ring: bounded + drop-counted (DESIGN.md
        # §18 shared helper; the old inline `del log[:2048]` trim is gone)
        self.log: BoundedLog = BoundedLog(4096)
        # flight-recorder hook (DESIGN.md §18): the engine that owns this
        # injector points it at `tracer.record_fault`, so every injection
        # auto-dumps the span timeline that led into it.  Survives `arm()`
        # — re-arming replaces the schedule, not the observability wiring.
        self.observer: Optional[Callable[[str, int, str, str], None]] = \
            getattr(self, "observer", None)

    def fire(self, point: str, key: Optional[str] = None
             ) -> Optional[FaultSpec]:
        """Advance the point's occurrence counters; return the spec to
        inject at this occurrence (consumer acts on its mode), or None."""
        n = self._counts[point]
        self._counts[point] += 1
        nk = None
        if key is not None:
            nk = self._key_counts[(point, key)]
            self._key_counts[(point, key)] += 1
        for spec in self._by_point.get(point, ()):
            if spec.key is not None:
                if spec.key != key or nk is None or nk not in spec.at:
                    continue
                idx = nk
            elif n in spec.at:
                idx = n
            else:
                continue
            self.injected[point] += 1
            self.log.append((point, idx, key or "", spec.mode))
            if self.observer is not None:
                self.observer(point, idx, key or "", spec.mode)
            return spec
        return None

    def arm(self, specs: Sequence[FaultSpec]):
        """Replace the schedule and reset every counter and ledger — a
        fresh replay with the injector already plumbed into its consumers.
        The real plane needs this: keyed ``store.read`` specs name tensor
        FINGERPRINTS, which only exist after a warm-up materialization, so
        engines are built with an empty injector and armed just before the
        chaos replay (serve.py --chaos, fig17's real-plane smoke)."""
        self.specs = tuple(specs)
        self.__post_init__()

    def record(self, point: str, key: Optional[str] = None,
               mode: str = "scheduled"):
        """Ledger an externally-scheduled fault (fleet crash/recover events
        are driven by the gateway's event queue, not by `fire` polling) so
        the injected==handled balance covers them too."""
        self.injected[point] += 1
        self.log.append((point, self._counts[point], key or "", mode))
        if self.observer is not None:
            self.observer(point, self._counts[point], key or "", mode)
        self._counts[point] += 1

    def injected_total(self) -> int:
        return sum(self.injected.values())

    def ledger(self) -> dict[str, int]:
        """Per-point injected counts (a plain dict for metrics/JSON)."""
        return {point: int(n) for point, n in sorted(self.injected.items())}
