"""Chrome/Perfetto trace-event JSON exporter (DESIGN.md §18).

Serializes a tracer's events into the Trace Event Format both
``chrome://tracing`` and https://ui.perfetto.dev load: complete events
(``ph: "X"``) for spans, instants (``ph: "i"``) for point events, with one
named thread lane per tracer track (request tracks, engine tracks, the
fault lane).  Timestamps are microseconds on whatever clock the emitting
plane used — virtual trace seconds for the sim, perf_counter walls for the
real plane — rounded to 0.001 us so a replay at a fixed seed serializes
BIT-IDENTICALLY (tests/test_obs.py pins this).
"""
from __future__ import annotations

import json
from typing import Iterable, Sequence

from repro_torch.obs.tracer import SpanEvent


def _us(seconds: float) -> float:
    us = round(seconds * 1e6, 3)
    # -0.0 serializes as "-0.0": normalize so determinism survives signed
    # zeros from subtractive clock math
    return us + 0.0 if us != 0 else 0.0


def chrome_trace(events: Iterable[SpanEvent], *, pid: int = 1) -> dict:
    """Events -> a Trace Event Format dict (``{"traceEvents": [...]}``).

    Tracks map to tids in first-seen order, each announced with a
    ``thread_name`` metadata record so the Perfetto UI shows the track
    names (``req:3``, ``eng:engine0``, ``faults``) instead of numbers.
    """
    tids: dict[str, int] = {}
    out: list[dict] = []
    for ev in events:
        tid = tids.get(ev.track)
        if tid is None:
            tid = tids[ev.track] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": ev.track}})
        rec = {"name": ev.name, "cat": ev.cat, "pid": pid, "tid": tid,
               "ts": _us(ev.begin)}
        if ev.end is None:
            rec["ph"] = "i"
            rec["s"] = "t"  # thread-scoped instant
        else:
            rec["ph"] = "X"
            rec["dur"] = _us(ev.end - ev.begin)
        if ev.args:
            rec["args"] = dict(ev.args)
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def chrome_trace_json(events: Sequence[SpanEvent], *, pid: int = 1) -> str:
    """Deterministic serialization: sorted keys, no whitespace jitter."""
    return json.dumps(chrome_trace(events, pid=pid), sort_keys=True,
                      separators=(",", ":"))


def write_chrome_trace(events: Sequence[SpanEvent], path: str, *,
                       pid: int = 1) -> str:
    with open(path, "w") as f:
        f.write(chrome_trace_json(events, pid=pid))
    return path
