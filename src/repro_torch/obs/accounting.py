"""Span accounting + cost-model cross-checks (DESIGN.md §18).

The keystone correctness hook of the obs plane: every request emits one
``request`` span whose duration is its REPORTED TTFT and one child span per
phase it was billed for.  ``request_accounting`` re-derives TTFT from the
children and reports the gap — if someone adds a new phase into the TTFT
sum without emitting its span (the queue_s/profile_s fold-in bug once fixed
by hand), ``unattributed_frac`` goes non-zero and the CI gate
(``scripts/check_bench.py``) fails the entry.

``cost_model_ratios`` is the second detector: phase spans carry the cost
plane's PREDICTION in ``args["pred"]`` where one exists, and the aggregate
measured/predicted ratio per phase is logged into the bench entry — a phase
whose ratio drifts or goes non-finite is doing silently-unpriced work.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

from repro_torch.obs.tracer import SpanEvent, Tracer

#: The paper's TTFT phase vocabulary, shared by both planes (TTFTRecord /
#: RequestResult).  ``merge`` is the sim plane's compaction sub-phase of
#: Load; decode is traced but excluded from TTFT, like everywhere else.
TTFT_PHASES = ("queue", "init", "load", "merge", "profile", "prefill")

REQUEST_TRACK_PREFIX = "req:"


def trace_request(tracer: Tracer, *, rid, model_id: str, arrival: float,
                  ttft: float, phases: Sequence[tuple[str, float]],
                  decode_s: float = 0.0, cold: Optional[bool] = None,
                  engine: str = "", preds: Optional[dict] = None) -> None:
    """Emit one request's span family on its own track.

    The parent ``request`` span covers [arrival, arrival + REPORTED ttft];
    children are laid head-to-tail from the caller's per-phase durations.
    The parent is deliberately NOT derived from the children — the whole
    point is that the two can disagree (``request_accounting`` measures by
    how much).  ``preds`` maps phase name -> the cost model's predicted
    seconds, attached as span args for ``cost_model_ratios``.
    """
    track = f"{REQUEST_TRACK_PREFIX}{rid}"
    tracer.emit("request", arrival, arrival + ttft, track=track,
                cat="request",
                args={"model": model_id, "cold": cold, "engine": engine})
    t = arrival
    for name, dur in phases:
        args = None
        if preds is not None and name in preds:
            args = {"pred": preds[name]}
        tracer.emit(name, t, t + dur, track=track, cat="phase", args=args)
        t += dur
    if decode_s > 0.0:
        tracer.emit("decode", t, t + decode_s, track=track, cat="decode")


def request_accounting(events: Iterable[SpanEvent], *,
                       epsilon_frac: float = 0.02) -> dict:
    """Check the span-accounting identity over a trace.

    For every ``req:*`` track: TTFT is the ``request`` span's duration,
    attributed time is the sum of its ``phase`` children (decode excluded).
    Returns aggregate totals plus ``unattributed_frac`` — the fraction of
    reported TTFT no phase span claims — and the per-phase second totals.
    """
    ttft_total = 0.0
    attributed_total = 0.0
    unattributed = 0.0
    n_requests = 0
    violations = 0
    phase_seconds: dict[str, float] = {}
    per_track: dict[str, dict] = {}
    for ev in events:
        if not ev.track.startswith(REQUEST_TRACK_PREFIX) or ev.end is None:
            continue
        slot = per_track.setdefault(ev.track, {"ttft": 0.0, "attr": 0.0})
        if ev.cat == "request":
            slot["ttft"] += ev.duration
        elif ev.cat == "phase":
            slot["attr"] += ev.duration
            phase_seconds[ev.name] = (phase_seconds.get(ev.name, 0.0)
                                      + ev.duration)
    for slot in per_track.values():
        n_requests += 1
        ttft_total += slot["ttft"]
        attributed_total += slot["attr"]
        gap = abs(slot["ttft"] - slot["attr"])
        unattributed += gap
        # per-request identity at a resolution floor: tiny TTFTs compare
        # against an absolute microsecond epsilon, not a fraction of ~0
        if gap > max(epsilon_frac * slot["ttft"], 1e-6):
            violations += 1
    frac = unattributed / ttft_total if ttft_total > 0 else 0.0
    return {
        "n_requests": n_requests,
        "ttft_total": ttft_total,
        "attributed_total": attributed_total,
        "unattributed_frac": frac,
        "violations": violations,
        "phase_seconds": phase_seconds,
    }


def cost_model_ratios(events: Iterable[SpanEvent], *,
                      floor: float = 1e-9) -> dict[str, float]:
    """Aggregate measured/predicted ratio per phase, over every phase span
    that carries a cost-model prediction (``args["pred"]``).

    Finite by construction: the denominator is floored at `floor` seconds
    (a prediction of exactly zero with zero measured time reads 1.0 — the
    phases agree).  A non-finite ratio in a bench entry is therefore
    always an instrumentation bug, which is why check_bench hard-fails it.
    """
    measured: dict[str, float] = {}
    predicted: dict[str, float] = {}
    for ev in events:
        if ev.end is None or not ev.args or "pred" not in ev.args:
            continue
        measured[ev.name] = measured.get(ev.name, 0.0) + ev.duration
        predicted[ev.name] = predicted.get(ev.name, 0.0) + float(
            ev.args["pred"])
    out: dict[str, float] = {}
    for name in sorted(measured):
        m, p = measured[name], predicted[name]
        ratio = 1.0 if (m <= floor and p <= floor) else m / max(p, floor)
        assert math.isfinite(ratio), f"non-finite {name} ratio {m}/{p}"
        out[name] = ratio
    return out


def obs_stats(tracer: Tracer, *, epsilon_frac: float = 0.02) -> dict:
    """The bench entry's ``obs`` section: span accounting + cost-model
    cross-check + tracer health, as one stable-keyed dict (the typed
    ``ObsStats`` snapshot in ``repro.stats``)."""
    from repro_torch.stats import ObsStats

    events = tracer.events()
    acct = request_accounting(events, epsilon_frac=epsilon_frac)
    return ObsStats(
        n_requests=acct["n_requests"],
        ttft_total=acct["ttft_total"],
        attributed_total=acct["attributed_total"],
        unattributed_frac=acct["unattributed_frac"],
        violations=acct["violations"],
        phase_seconds=acct["phase_seconds"],
        span_cost_ratio=cost_model_ratios(events),
        trace_events=len(events),
        dropped_events=tracer.dropped_events,
    ).as_dict()
