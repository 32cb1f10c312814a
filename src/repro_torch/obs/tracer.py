"""Clock-injected span tracer + flight recorder (DESIGN.md §18).

One tracer serves both planes because the CLOCK is the caller's, not the
tracer's:

  * the real data plane wraps work in ``with tracer.span(...)`` and the
    tracer stamps ``time.perf_counter`` walls (or any injected callable);
  * the modeled/sim plane calls ``tracer.emit(name, begin, end)`` with
    explicit virtual trace-clock timestamps — durations it PRICED, never
    measured — so replays at a fixed seed produce bit-identical traces.

Near-zero overhead when disabled: ``NULL_TRACER`` is a stateless singleton
whose methods return cached constants, so the hot decode path pays one
attribute load and a branch (``if tracer.enabled:``) and allocates nothing.

Thread-safe: emits append to a bounded ring under one lock (the prefetch
worker and a loading request trace concurrently).  The event buffer is a
``BoundedLog`` — a long-lived engine cannot grow an unbounded trace, and
truncation is counted, not silent.

The flight recorder is the crash-dump half: a tracer constructed with
``flight=FlightRecorder()`` snapshots its newest events whenever
``record_fault`` fires — every injected fault and ``Engine.crash`` calls
it — so the timeline LEADING INTO a failure survives even after the engine
swaps its state away.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Callable, NamedTuple, Optional

from repro_torch.obs.ring import BoundedLog


class SpanEvent(NamedTuple):
    """One trace event.  ``end is None`` marks an instant; otherwise a
    complete span over [begin, end] on the emitting plane's clock."""

    name: str
    track: str
    begin: float
    end: Optional[float]
    cat: str = "phase"
    args: Optional[dict] = None

    @property
    def duration(self) -> float:
        return 0.0 if self.end is None else self.end - self.begin


class FlightRecorder:
    """Bounded crash-dump store: the last `last_n` trace events at each
    fault, keeping the newest `max_dumps` dumps."""

    def __init__(self, last_n: int = 256, max_dumps: int = 8):
        self.last_n = last_n
        self.dumps: BoundedLog = BoundedLog(max_dumps)

    def dump(self, tracer: "Tracer", reason: str, ts: Optional[float] = None
             ) -> dict:
        snap = {"reason": reason, "ts": ts,
                "events": tracer.tail(self.last_n)}
        self.dumps.append(snap)
        return snap


class Tracer:
    """Thread-safe span/instant collector over an injected clock.

    ``clock`` is any zero-arg float callable (defaults to
    ``time.perf_counter``); the modeled plane never calls it — it emits
    explicit virtual timestamps — so a sim tracer works with the default.
    """

    enabled = True

    def __init__(self, *, clock: Callable[[], float] = _time.perf_counter,
                 max_events: int = 65536,
                 flight: Optional[FlightRecorder] = None):
        self.clock = clock
        self.flight = flight
        self._events: BoundedLog = BoundedLog(max_events)
        self._lock = threading.Lock()

    # ------------------------------------------------------------- emission
    def emit(self, name: str, begin: float, end: float, *,
             track: str = "main", cat: str = "phase",
             args: Optional[dict] = None) -> None:
        """Record a complete span with explicit timestamps (the modeled
        plane's path, and the real plane's when it already measured)."""
        ev = SpanEvent(name, track, begin, end, cat, args)
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, ts: Optional[float] = None, *,
                track: str = "main", cat: str = "instant",
                args: Optional[dict] = None) -> None:
        if ts is None:
            ts = self.clock()
        ev = SpanEvent(name, track, ts, None, cat, args)
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, *, track: str = "main", cat: str = "phase",
             args: Optional[dict] = None) -> "_LiveSpan":
        """Context manager measuring [enter, exit] on the injected clock."""
        return _LiveSpan(self, name, track, cat, args)

    def record_fault(self, reason: str, ts: Optional[float] = None, *,
                     track: str = "faults",
                     args: Optional[dict] = None) -> None:
        """Ledger a fault instant AND auto-dump the flight recorder: the
        last N events — the timeline that led here — survive the crash."""
        self.instant(reason, ts, track=track, cat="fault", args=args)
        if self.flight is not None:
            self.flight.dump(self, reason, ts)

    # ------------------------------------------------------------- reading
    def events(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._events)

    def tail(self, n: int) -> list[SpanEvent]:
        with self._lock:
            return self._events.tail(n)

    @property
    def dropped_events(self) -> int:
        return self._events.dropped_events

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


class _LiveSpan:
    """An open span: stamps the clock at enter/exit and emits on exit."""

    __slots__ = ("_tracer", "_name", "_track", "_cat", "_args", "_begin")

    def __init__(self, tracer: Tracer, name: str, track: str, cat: str,
                 args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._track = track
        self._cat = cat
        self._args = args
        self._begin = 0.0

    def __enter__(self) -> "_LiveSpan":
        self._begin = self._tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer.emit(self._name, self._begin, self._tracer.clock(),
                          track=self._track, cat=self._cat, args=self._args)
        return False


class _NullSpan:
    """The one disabled-mode span: enter/exit are no-ops, the instance is
    a module singleton, so ``with tracer.span(...)`` allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _NullTracer:
    """Disabled tracer: every method returns a cached constant.  Hot paths
    guard span construction with ``if tracer.enabled:`` — one attribute
    load and a branch, no allocation — and even unguarded calls return
    singletons."""

    __slots__ = ()

    enabled = False
    flight = None

    def emit(self, name, begin, end, *, track="main", cat="phase",
             args=None) -> None:
        return None

    def instant(self, name, ts=None, *, track="main", cat="instant",
                args=None) -> None:
        return None

    def span(self, name, *, track="main", cat="phase", args=None) -> _NullSpan:
        return _NULL_SPAN

    def record_fault(self, reason, ts=None, *, track="faults",
                     args=None) -> None:
        return None

    def events(self) -> list:
        return []

    def tail(self, n) -> list:
        return []

    @property
    def dropped_events(self) -> int:
        return 0

    def clear(self) -> None:
        return None


#: The shared disabled tracer: providers default their ``tracer`` attribute
#: to this, so instrumentation sites never need a None check.
NULL_TRACER = _NullTracer()
