"""The port's own spans in its serving path, on the CPU.

A Gateway over a CPU engine whose `StepGraphs` captures through
`RecordingCapture` (the double `serving/step_graph.py` documents), so its
decode steps go eager, capture, replay as on the card.  Held here: one
engine-track ``request`` span a `GatewayRecord`, with the record's `rid`;
every span of a request inside it; the decode steps named by the step
`StepGraphs` ran; ``done`` never before a span's begin; nothing created or
counted with tracing off; and `DeviceClock`'s resolution through a double
of its timing events.
"""
import dataclasses
import time

import pytest

pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.trace import Request  # noqa: E402
from repro_torch.models.tensors import spec_records  # noqa: E402
from repro_torch.obs import FlightRecorder, Tracer  # noqa: E402
from repro_torch.obs import device_clock  # noqa: E402
from repro_torch.obs.device_clock import PORT_SPANS, DeviceClock  # noqa: E402
from repro_torch.serverless.gateway import Gateway, GatewayRecord  # noqa: E402
from repro_torch.serving.engine import DataLoadStats, Engine  # noqa: E402
from repro_torch.serving.step_graph import StepGraphs  # noqa: E402

from torch_port_helpers import RecordingCapture  # noqa: E402

GEN = 4
# a then b evicts part of a (a pool of one model): a's third request loads
# the missed tensors and re-assembles its tree; a's second keeps it
TRACE = [(0.0, "a"), (100.0, "a"), (200.0, "b"), (300.0, "a")]
FRESH = ["decode.eager", "decode.capture"] + ["decode.replay"] * (GEN - 2)
KEPT = ["decode.replay"] * GEN
SEQUENCES = [FRESH, KEPT, FRESH, FRESH]


def cfg(layers):
    return dataclasses.replace(get_config("llama3.2-1b").smoke(), num_layers=layers,
                               vocab_size=512, dtype="float32")


def run(tracer=None, trace=TRACE):
    sizes = {m: sum(r.nbytes for r in spec_records(m, cfg(2))) for m in ("a", "b")}
    eng = Engine(sizes["a"] + sizes["b"] // 2, device="cpu", tracer=tracer)
    for m in ("a", "b"):
        eng.register(m, cfg(2))
    eng.step_graphs = StepGraphs(RecordingCapture())
    gw = Gateway(eng, keep_alive="zero", prompt_len=16, gen_tokens=GEN, num_pages=64)
    gw.run_trace([Request(time=t, model_id=m, dataset="x", prompt_tokens=16,
                          output_tokens=GEN, batch_size=1) for t, m in trace])
    eng.close()
    return eng, gw


@pytest.fixture(scope="module")
def traced():
    tracer = Tracer()
    eng, gw = run(tracer)
    return eng, gw, tracer.events()


def requests(events):
    return {e.args["rid"]: e for e in events if e.name == "request"}


def test_one_request_span_per_record(traced):
    eng, gw, events = traced
    recs = gw.sink.records
    assert len(recs) == len(TRACE)
    reqs = requests(events)
    assert sorted(reqs) == list(range(len(recs)))
    assert len([e for e in events if e.name == "request"]) == len(recs)
    for rid, rec in enumerate(recs):
        assert isinstance(rec, GatewayRecord) and rec.rid == rid
        assert isinstance(rec.load_stats, DataLoadStats)
        req = reqs[rid]
        assert req.track == f"eng:{eng.engine_id}" and req.cat == "request"
        assert req.args == {"rid": rid, "model": rec.model_id, "cold": rec.cold}
    # the per-request load ledger is the engine's load of that request
    assert [r.load_stats.bytes_h2d > 0 for r in recs] == [True, False, True, True]


def test_every_span_nests_in_its_request_and_port_spans_carry_its_rid(traced):
    eng, _, events = traced
    reqs = sorted(requests(events).values(), key=lambda e: e.begin)
    for ev in events:
        if ev.name == "request" or ev.track != f"eng:{eng.engine_id}":
            continue
        holders = [r for r in reqs if r.begin <= ev.begin and ev.end <= r.end]
        assert len(holders) == 1, ev
        if ev.name in PORT_SPANS:
            assert ev.args["rid"] == holders[0].args["rid"], ev
            assert ev.args["model"] == holders[0].args["model"], ev
    for req in reqs:
        names = [e.name for e in events if e.name in PORT_SPANS and e.name != "request"
                 and e.args["rid"] == req.args["rid"]]
        assert sorted(set(names)) == sorted(
            {"load.plan", "instance.start", "prefill.forward", "prefill.kv",
             "instance.finish"} | set(SEQUENCES[req.args["rid"]]))


def test_decode_steps_named_by_the_step_they_ran(traced):
    _, _, events = traced
    for rid, want in enumerate(SEQUENCES):
        steps = sorted((e for e in events if e.name.startswith("decode.")
                        and e.args["rid"] == rid), key=lambda e: e.begin)
        assert [e.name for e in steps] == want, rid


def test_done_at_or_after_begin_and_the_prefill_children(traced):
    _, _, events = traced
    timed = [e for e in events if e.args and "done" in e.args]
    assert {e.name for e in timed} == {"prefill.forward", "prefill.kv", "decode.eager",
                                       "decode.capture", "decode.replay"}
    for e in timed:
        assert e.args["done"] >= e.begin, e
    for p in (e for e in events if e.name == "prefill"):
        kids = [e for e in timed if e.name.startswith("prefill.")
                and p.begin <= e.begin and e.end <= p.end]
        assert [k.name for k in sorted(kids, key=lambda e: e.begin)] == ["prefill.forward",
                                                                        "prefill.kv"]


def test_untraced_creates_nothing_and_counts_the_same(traced, monkeypatch):
    calls = []

    def spy(name):
        real = getattr(DeviceClock, name)

        def called(self, *args, **kw):
            calls.append(name)
            return real(self, *args, **kw)
        return called

    for name in ("emit", "resolve"):
        monkeypatch.setattr(DeviceClock, name, spy(name))
    eng, _ = run(None)
    assert calls == []
    g, gt = eng.step_graphs, traced[0].step_graphs
    assert ((g.eager_steps, g.captures, g.replays)
            == (gt.eager_steps, gt.captures, gt.replays) == (3, 3, 3 * (GEN - 1) + GEN))


class FakeClock:
    """`DeviceClock`'s host clock, driven by the test: it stands still
    until a wait moves it, and a wait wakes `wake` seconds after the event
    it waited for.  Its times are dyadic, so sums and differences of them
    are exact."""

    wake = 2.0 ** -12

    def __init__(self, now: float = 1.0):
        self.now = now

    def perf_counter(self) -> float:
        return self.now

    def wait_until(self, t: float):
        self.now = max(self.now, t) + self.wake


class FakeEvent:
    """A timing event's double on a device whose clock runs `lag` seconds
    behind the host's: the host clock `DeviceClock` reads (a `FakeClock`
    where a test installs one)."""

    lag = 2.0 ** -9

    def __init__(self):
        self.t = device_clock._time.perf_counter() + self.lag

    def elapsed_time(self, later):
        return (later.t - self.t) * 1e3

    def synchronize(self):
        clock = device_clock._time
        if isinstance(clock, FakeClock):
            clock.wait_until(self.t)
            return
        while clock.perf_counter() < self.t:
            pass


def test_device_clock_resolves_onto_the_host_clock(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(device_clock, "_time", clock)
    tracer = Tracer()
    dc = DeviceClock(tracer, "cpu", record=FakeEvent)
    t0 = clock.now
    dc.emit("decode.replay", t0, track="eng:x", args={"rid": 3, "model": "m"})
    clock.now += 2.0 ** -11  # the host goes on before the second span ends
    dc.emit("decode.replay", t0, track="eng:x", args={"rid": 3, "model": "m"})
    assert tracer.events() == [] and len(dc._pending) == 2
    dc.resolve()
    a, b = tracer.events()
    assert len(dc._pending) == 0
    assert a.args["rid"] == 3 and a.begin == b.begin == t0
    assert (a.end, b.end) == (t0, t0 + 2.0 ** -11)
    # each `done` is its event's device time on the host clock (the device
    # reaches an event `lag` after the host recorded it), late by exactly the
    # wake-up of the one wait, never early
    assert a.args["done"] == a.end + FakeEvent.lag + FakeClock.wake
    assert b.args["done"] == b.end + FakeEvent.lag + FakeClock.wake
    assert clock.now == b.end + FakeEvent.lag + FakeClock.wake
    dc.resolve()  # nothing pending: no anchor, nothing emitted
    assert len(tracer.events()) == 2 and clock.now == b.args["done"]


def test_device_clock_on_the_cpu_emits_at_once():
    tracer = Tracer()
    clock = DeviceClock(tracer, "cpu")
    t0 = time.perf_counter()
    clock.emit("prefill.kv", t0, track="eng:x", args={"rid": None, "model": "m"})
    (ev,) = tracer.events()
    assert ev.args["done"] == ev.end and len(clock._pending) == 0


def test_close_resolves_what_is_pending():
    tracer = Tracer()
    eng = Engine(1 << 20, device="cpu", tracer=tracer)
    eng.clock = DeviceClock(tracer, "cpu", record=FakeEvent)
    eng.clock.emit("decode.eager", time.perf_counter(), track=eng._track,
                   args={"rid": None, "model": "m"})
    eng.close()
    assert [e.name for e in tracer.events()] == ["decode.eager"]


def test_crash_resolves_before_the_flight_recorder_dumps():
    tracer = Tracer(flight=FlightRecorder())
    eng = Engine(1 << 20, device="cpu", tracer=tracer)
    eng.clock = DeviceClock(tracer, "cpu", record=FakeEvent)
    eng.clock.emit("decode.replay", time.perf_counter(), track=eng._track,
                   args={"rid": 0, "model": "m"})
    eng.crash()
    (dump,) = tracer.flight.dumps
    assert [e.name for e in dump["events"]] == ["decode.replay", "engine.crash"]
    eng.close()


def test_port_spans_are_named_once():
    assert len(PORT_SPANS) == len(set(PORT_SPANS))
    assert {"request", "decode.eager", "decode.capture", "decode.replay"} <= set(PORT_SPANS)
