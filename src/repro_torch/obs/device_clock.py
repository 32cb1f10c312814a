"""Spans whose end is when the device finished, on the tracer's clock
(port-only: the reference's arrays are done when its host spans end).

CUDA work is asynchronous: a host span around a launch ends when the
launch returns, not when the card has run it.  `DeviceClock.emit` closes
a span on the host as usual and records a timing event on the device's
current stream after the span's work; the span goes to the tracer only
when the event is resolved, with ``args["done"]``: the `perf_counter`
second at which the device reached the event.  Recording is not a sync,
so an emitting decode loop stays legal under
``torch.cuda.set_sync_debug_mode("error")``.

Events are resolved only where the host already waits (`Instance.finish`
after the Gateway's settle, `Engine.close`, `Engine.crash`): one anchor
event is recorded and synchronized, `perf_counter` is stamped, and each
pending event's time is the stamp less its elapsed time to the anchor.
Every resolution re-anchors, so no drift between the two clocks builds
up.  The stamp is taken after the anchor's sync returns, so a ``done`` is
late by that wake-up, never early.  On a CPU engine ``done`` is the span's
host end.

The tracer's own module is a copy of the reference's, so this module is
imported directly, not through `repro_torch.obs`.  Every span of the port
that the reference does not emit is named in `PORT_SPANS`.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Any, Callable, Optional

import torch

#: The spans only the port emits, all on the engine's track with the
#: request's ``rid`` in their args; ``done`` on those that end on the device.
PORT_SPANS = ("request", "load.plan", "instance.start", "instance.finish",
              "prefill.forward", "prefill.kv",
              "decode.eager", "decode.capture", "decode.replay")


def _cuda_event(device: torch.device) -> Callable[[], Any]:
    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return record


class DeviceClock:
    """An engine's pending device-ended spans.

    `record`: a callable that records a timing event on the device's
    current stream and returns it (``elapsed_time(later)`` in ms,
    ``synchronize()``); by default a `torch.cuda.Event` on a CUDA device and
    none on the CPU, where spans are emitted at once with ``done`` their
    host end.  Tests inject a double."""

    def __init__(self, tracer, device, record: Optional[Callable[[], Any]] = None):
        self.tracer = tracer
        device = torch.device(device)
        self._record = record if record is not None else (
            _cuda_event(device) if device.type == "cuda" else None)
        self._pending: list[tuple] = []
        self._lock = threading.Lock()

    def emit(self, name: str, begin: float, *, track: str, args: dict,
             cat: str = "engine") -> None:
        """Close span `name` opened at `begin` (host `perf_counter`): mark
        the device's progress now and hold the span until `resolve`."""
        if self._record is None:
            end = _time.perf_counter()
            self.tracer.emit(name, begin, end, track=track, cat=cat,
                             args={**args, "done": end})
            return
        ev = self._record()
        end = _time.perf_counter()
        with self._lock:
            self._pending.append((name, track, cat, begin, end, args, ev))

    def resolve(self) -> None:
        """Put every pending span on the tracer with its ``done``: waits for
        the device to reach the newest of them."""
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        anchor = self._record()
        anchor.synchronize()
        t = _time.perf_counter()
        for name, track, cat, begin, end, args, ev in pending:
            done = t - ev.elapsed_time(anchor) / 1e3
            self.tracer.emit(name, begin, end, track=track, cat=cat,
                             args={**args, "done": done})
