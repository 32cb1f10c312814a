"""The program's own spans in the traced run's window, and the arithmetic
of the per-layer metrics that read them.

The port's serving path emits, on its engine's track (``eng:<id>``) and
the host clock, one ``request`` span a request with the request's ``rid``
(its index in the Gateway's sink) and, inside it, spans that carry the same
``rid``: ``prefill.forward`` and ``prefill.kv`` under the reference's
``prefill`` span, and one ``decode.eager``, ``decode.capture`` or
``decode.replay`` a decode step.  Those that end on the device carry
``done``: the `perf_counter` second at which the card finished their work.

The window's requests are those whose ``request`` span begins between the
window's start and end.  A program without these spans (an older one) has
no ``request`` span on an engine track: every reading is then None.
"""
from __future__ import annotations

import sys
from pathlib import Path

FRESH = ("decode.eager", "decode.capture")
DECODE = FRESH + ("decode.replay",)
PREFILL_CHILDREN = ("prefill.forward", "prefill.kv")


def window_spans(ctx) -> list:
    """The traced run's spans: ``ctx.spans`` where the run's `Context`
    carries them; else the events of the `Tracer` that `cell.run` holds,
    read from its frame (nothing outside a run)."""
    spans = getattr(ctx, "spans", None)
    if spans is not None:
        return spans
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_code
        if code.co_name == "run" and Path(code.co_filename).parts[-2:] == ("pbench", "cell.py"):
            tracer = frame.f_locals.get("tracer")
            return tracer.events() if tracer is not None else []
        frame = frame.f_back
    return []


def window_requests(spans, start: float, end: float) -> list[tuple]:
    """(request span, its spans carrying its rid, the ``prefill`` spans it
    contains on its track) per request of the window, in rid order."""
    reqs = {e.args["rid"]: e for e in spans
            if e.name == "request" and e.track.startswith("eng:") and e.end is not None
            and e.args and start <= e.begin <= end}
    own: dict = {rid: [] for rid in reqs}
    for e in spans:
        if e.name != "request" and e.args and e.args.get("rid") in own and e.end is not None:
            req = reqs[e.args["rid"]]
            if e.track == req.track:
                own[e.args["rid"]].append(e)
    hosts = [e for e in spans if e.name == "prefill" and e.end is not None]
    out = []
    for rid in sorted(reqs):
        req = reqs[rid]
        prefills = [e for e in hosts if e.track == req.track
                    and req.begin <= e.begin and e.end <= req.end]
        out.append((req, sorted(own[rid], key=lambda e: e.begin), prefills))
    return out


def _prefill_done(own) -> float | None:
    done = [e.args["done"] for e in own if e.name in PREFILL_CHILDREN]
    return max(done) if done else None


def fresh_key_share(spans, start: float, end: float) -> float | None:
    """Share of the window's decode time spent in eager steps and captures,
    in %.  A step's time is its ``done`` less the one before it (the
    request's prefill completion before its first step): Σ over
    ``decode.eager`` and ``decode.capture`` over Σ over every step."""
    fresh = total = 0.0
    for _, own, _ in window_requests(spans, start, end):
        prev = _prefill_done(own)
        if prev is None:
            continue
        for e in own:
            if e.name not in DECODE:
                continue
            dt = e.args["done"] - prev
            prev = e.args["done"]
            total += dt
            if e.name in FRESH:
                fresh += dt
    return 100.0 * fresh / total if total > 0 else None


def prefill_host_share(spans, start: float, end: float) -> float | None:
    """Share of the window's prefills the host spent dispatching, in %:
    Σ of the ``prefill`` span's host duration over Σ of its completion less
    its begin.  The completion is the later of its host end and its
    children's latest ``done`` (the device may finish the last kernel a few
    microseconds before the host returns).  100 % means the device waited
    on the host until the prefill's last kernel."""
    host = whole = 0.0
    for _, own, prefills in window_requests(spans, start, end):
        done = _prefill_done(own)
        if done is None or len(prefills) != 1:
            continue
        (p,) = prefills
        host += p.end - p.begin
        whole += max(p.end, done) - p.begin
    return 100.0 * host / whole if whole > 0 else None
