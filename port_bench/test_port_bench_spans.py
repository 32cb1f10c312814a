"""The readers of the program's spans (`pbench/spans.py`): their arithmetic
on hand-built `SpanEvent`s, the cases with nothing to read, and a traced
run of each cell on the CPU, where every prefill is the host's alone and
every decode step eager."""
import dataclasses
import time
from pathlib import Path

import pytest

from repro_torch.obs import SpanEvent

from pbench import cell, spans
from pbench.serve import Window

ROOT = Path(__file__).resolve().parents[1]
ENG = "eng:e"


def span(name, begin, end, track=ENG, **args):
    return SpanEvent(name, track, begin, end, "engine", args or None)


def request(rid, begin, end, prefill, kids, steps):
    """A request's spans: the engine-track `request`, its host `prefill`
    (begin, end), the children's `done`s and (name, done) per decode step."""
    out = [span("request", begin, end, rid=rid, model="m", cold=True),
           span("prefill", *prefill, model="m")]
    out += [span(n, prefill[0], prefill[1], rid=rid, model="m", done=d)
            for n, d in zip(("prefill.forward", "prefill.kv"), kids)]
    t = prefill[1]
    for name, done in steps:
        out.append(span(name, t, t + 0.001, rid=rid, model="m", done=done))
        t += 0.001
    return out


EVENTS = (
    request(0, 10.0, 10.5, (10.10, 10.14), (10.15, 10.16),
            [("decode.eager", 10.20), ("decode.capture", 10.26), ("decode.replay", 10.28),
             ("decode.replay", 10.30)])
    # the device finished before the host returned: the completion is the host's end
    + request(1, 11.0, 11.3, (11.00, 11.05), (11.03, 11.04),
              [("decode.replay", 11.07), ("decode.replay", 11.09)])
    # begins after the window: not read
    + request(2, 12.5, 13.0, (12.5, 12.6), (12.7, 12.8), [("decode.eager", 13.0)])
    # the Gateway's trace-clock family of request 0: never mixed in
    + [span("request", 10.2, 10.9, track="req:0", model="m", cold=True, engine="e"),
       span("prefill", 10.3, 10.9, track="req:0")]
    # a load's spans carry no rid of their own, or a rid on another track
    + [span("load", 10.01, 10.09, model="m"), span("load.plan", 10.0, 10.01, rid=0, model="m")]
)


@pytest.fixture
def ctx():
    win = Window(start=10.0, end=12.0)
    c = cell.Context(cfgs={}, traffic={}, window=win, model_bytes={})
    c.spans = EVENTS
    return c


def test_fresh_key_share(ctx):
    fresh = 0.04 + 0.06
    total = fresh + 0.02 + 0.02 + 0.03 + 0.02
    assert cell.reader("metrics", "decode.fresh_key_share")(ctx) == pytest.approx(
        100 * fresh / total)
    assert cell.reader("metrics", "decode.fresh_key_share.cold")(ctx) == pytest.approx(
        100 * fresh / total)


def test_prefill_host_share(ctx):
    host = 0.04 + 0.05
    whole = (10.16 - 10.10) + (11.05 - 11.00)
    for name in ("prefill.host_share", "prefill.host_share.cold"):
        assert cell.reader("metrics", name)(ctx) == pytest.approx(100 * host / whole)


def test_window_requests_select_by_begin_and_track(ctx):
    reqs = spans.window_requests(EVENTS, 10.0, 12.0)
    assert [r.args["rid"] for r, _, _ in reqs] == [0, 1]
    req, own, prefills = reqs[0]
    assert [e.name for e in own][:3] == ["load.plan", "prefill.forward", "prefill.kv"]
    assert [p.track for p in prefills] == [ENG]


@pytest.mark.parametrize("name", ["decode.fresh_key_share", "prefill.host_share"])
def test_nothing_to_read(ctx, name):
    read = cell.reader("metrics", name)
    ctx.spans = []
    assert read(ctx) is None
    # an older program: the reference's spans alone, no `request` span
    ctx.spans = [e for e in EVENTS if e.name in ("prefill", "load")]
    assert read(ctx) is None
    ctx.spans = EVENTS
    ctx.window = Window(start=20.0, end=21.0)
    assert read(ctx) is None
    # outside a run, and without the spans on the context
    del ctx.spans
    ctx.window = Window(start=10.0, end=12.0)
    assert read(ctx) is None


@pytest.mark.parametrize("workload,names", [
    ("dense-trio.switch", ("decode.fresh_key_share.cold", "prefill.host_share.cold")),
    ("moe-duo.chat", ("prefill.host_share",)),
])
def test_a_traced_run_on_the_cpu_reads_the_spans(workload, names):
    """`cell.run` holds the tracer; a CPU engine has no graphs, and each
    `done` is its span's host end."""
    out = cell.run(ROOT, workload, 2**31 + 303, 0.0, True, t_start=time.perf_counter(),
                   device="cpu", shrink=lambda c: dataclasses.replace(c.smoke(), dtype="float32"),
                   log=lambda m: None,
                   traffic={"limits": {"max_logit_gap": 1e-3, "min_tokens_compared": 1},
                            "check_requests": 1, "slice_requests": 2, "decode_steps": 3})
    assert out["correct"], out["checks"]
    for name in names:
        assert out["metrics"][name]["value"] == pytest.approx(100.0), name
