"""The port's `Prefetcher` and tracer against the reference's.

- The four deadline-scheduling scenarios of tests/test_prefetch.py run on
  both packages' `Prefetcher`s over a stub engine (a tiered host store and
  its lock, no model): the same promotion logs, bytes and job states.  In
  the urgent-join scenario the worker may promote a's first tensor before
  the join lands (the reference's own test allows both orders), so there
  the two logs hold the same promotions and each meets the reference's
  bound.
- tests/test_fastpath.py's traced cold start on both engines: a cold load,
  a store-tier reload, a prefill and 3 fused decode steps give equal lists
  of (name, track, args) spans (walls aside, and the port's own spans,
  `PORT_SPANS`, left out), each phase nested in its load, and a loadable
  Chrome trace.
"""
import dataclasses
import json
import threading
import time
import types

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as ref_obs  # noqa: E402
from repro.configs import all_configs as ref_configs  # noqa: E402
from repro.models import tensors as ref_tensors  # noqa: E402
from repro.serving import engine as ref_engine  # noqa: E402
from repro_torch import obs as port_obs  # noqa: E402
from repro_torch.configs import all_configs as port_configs  # noqa: E402
from repro_torch.models import tensors as port_tensors  # noqa: E402
from repro_torch.obs.device_clock import PORT_SPANS  # noqa: E402
from repro_torch.serving import engine as port_engine  # noqa: E402

from torch_port_helpers import paired_engines  # noqa: E402

PACKAGES = {"ref": (ref_engine, ref_tensors, np.zeros),
            "port": (port_engine, port_tensors, lambda n, dtype: torch.zeros(n, dtype=torch.uint8))}


def _stub_engine(pkg: str, spilled: dict[str, int]):
    """tests/test_prefetch.py's `_stub_engine` on either package: a tiered
    host store with every tensor spilled to the store tier, and its lock."""
    _, tensors, zeros = PACKAGES[pkg]
    eng = types.SimpleNamespace()
    eng.host_store = tensors.HostTensorStore(10**9)
    eng.persistent_store = eng.host_store.spill
    eng._store_lock = threading.RLock()
    for fp, size in spilled.items():
        eng.persistent_store.put(fp, zeros(size, dtype=np.uint8))
    return eng


def _racing_hints(pkg):
    a = {f"a{i}": 10 for i in range(3)}
    b = {f"b{i}": 10 for i in range(3)}
    pf = PACKAGES[pkg][0].Prefetcher(_stub_engine(pkg, {**a, **b}))
    pf.pause()
    ja = pf.submit("a", ["a0", "a1", "a2"], False, deadlines=[0.0, 100.0, 400.0])
    jb = pf.submit("b", ["b0", "b1", "b2"], False, deadlines=[50.0, 150.0, 200.0])
    pf.resume()
    for job in (ja, jb):
        assert job.done.wait(5.0)
    out = {"log": list(pf.promote_log), "bytes": pf.bytes_promoted}
    pf.close()
    return out


def _urgent_join(pkg):
    sizes = {f"a{i}": 10 for i in range(3)} | {f"b{i}": 10 for i in range(3)}
    pf = PACKAGES[pkg][0].Prefetcher(_stub_engine(pkg, sizes))
    pf.pause()
    pf.submit("a", ["a0", "a1", "a2"], False, deadlines=[0.0, 2.0, 4.0])
    job_b = pf.submit("b", ["b0", "b1", "b2"], False, deadlines=[1.0, 3.0, 5.0])
    job_b.started = True  # as if the worker already promoted from b
    pf.resume()
    taken = pf.take("b")  # a load joins b mid-flight: urgent
    assert taken is job_b and job_b.urgent
    assert job_b.done.wait(5.0)
    deadline = time.monotonic() + 5.0
    while len(pf.promote_log) < 6 and time.monotonic() < deadline:
        time.sleep(0.01)
    out = {"log": list(pf.promote_log), "bytes": pf.bytes_promoted}
    pf.close()
    return out


def _unstarted_take(pkg):
    pf = PACKAGES[pkg][0].Prefetcher(_stub_engine(pkg, {"a0": 10}))
    pf.pause()
    job = pf.submit("a", ["a0"], False, deadlines=[0.0])
    taken = pf.take("a")
    out = {"log": list(pf.promote_log), "taken": taken is job, "cancelled": job.cancelled,
           "done": job.done.is_set(), "promoted": job.tensors_promoted}
    pf.resume()
    pf.close()
    return out


def _paused_urgent(pkg):
    pf = PACKAGES[pkg][0].Prefetcher(_stub_engine(pkg, {"a0": 10, "a1": 10}))
    pf.pause()
    job = pf.submit("a", ["a0", "a1"], False, deadlines=[0.0, 1.0])
    job.started = True  # as if the worker was mid-job when paused
    taken = pf.take("a")  # a load joins: urgent, must finish while paused
    out = {"taken": taken is job, "urgent": job.urgent, "done": job.done.wait(5.0)}
    out.update(log=list(pf.promote_log), promoted=job.tensors_promoted)
    pf.resume()
    pf.close()
    return out


SCENARIOS = {"racing_hints": _racing_hints, "urgent_join": _urgent_join,
             "unstarted_take": _unstarted_take, "paused_urgent": _paused_urgent}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_prefetcher_scenario_matches_reference(name):
    ref, port = SCENARIOS[name]("ref"), SCENARIOS[name]("port")
    if name == "urgent_join":
        for log in (ref["log"], port["log"]):
            b_positions = [i for i, (m, _) in enumerate(log) if m == "b"]
            assert b_positions and max(b_positions) <= 3, log  # urgent beats deadlines
        assert sorted(port["log"]) == sorted(ref["log"]) and port["bytes"] == ref["bytes"]
        return
    assert port == ref
    if name == "racing_hints":  # the merged global deadline order, not FIFO
        assert port["log"] == [("a", "a0"), ("b", "b0"), ("a", "a1"), ("b", "b1"),
                               ("b", "b2"), ("a", "a2")]
        assert port["bytes"] == 60
    elif name == "unstarted_take":
        assert port["taken"] and port["cancelled"] and port["done"] and port["promoted"] == 0
    else:
        assert port["taken"] and port["urgent"] and port["done"] and port["promoted"] == 2


# ------------------------------------------------------------ traced cold start
def _small(configs):
    return dataclasses.replace(configs["llama3.2-1b"].smoke(), num_layers=2, vocab_size=512)


def _traced_run(eng, tokens, as_input, argmax, tracer):
    """tests/test_fastpath.py's sequence: a cold load, a store-tier reload
    (host_cache_bytes=0 spilled every leaf; the device copies dropped), a
    prefill and 3 fused decode steps; then the Chrome trace."""
    eng.load("m")
    eng.drop_device_copies("m")
    eng.load("m")
    inst = eng.start_instance("m", num_pages=64)
    tok = argmax(inst.prefill({"tokens": as_input(tokens)}))
    for _ in range(3):
        tok = argmax(eng.decode_many([(inst, tok)])[0])
    eng.close()
    return tracer.events()


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    tracers = {"ref": ref_obs.Tracer(flight=ref_obs.FlightRecorder()),
               "port": port_obs.Tracer(flight=port_obs.FlightRecorder())}

    def with_tracer(cls, tracer):
        return lambda cap, **kw: cls(cap, tracer=tracer, **kw)

    ref, port, _ = paired_engines({"m": (_small(ref_configs()), _small(port_configs()), 0)},
                                  256 << 20, ref_cls=with_tracer(ref_engine.Engine, tracers["ref"]),
                                  port_cls=with_tracer(port_engine.Engine, tracers["port"]),
                                  host_cache_bytes=0)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(np.int32)
    events = {
        "ref": _traced_run(ref, tokens, jnp.asarray,
                           lambda x: jnp.argmax(x, -1).astype(jnp.int32), tracers["ref"]),
        "port": _traced_run(port, tokens, torch.from_numpy,
                            lambda x: x.argmax(-1).to(torch.int32), tracers["port"]),
    }
    return events, port.engine_id, tmp_path_factory.mktemp("trace")


def test_traced_spans_equal_reference(traced):
    """The port's spans without its own (`PORT_SPANS`) are the
    reference's; every other name is the reference's."""
    events, _, _ = traced
    spans = {k: [(e.name, e.track, e.args) for e in evs if e.name not in PORT_SPANS]
             for k, evs in events.items()}
    assert spans["port"] == spans["ref"]
    ref_names = {e.name for e in events["ref"]}
    assert all(e.name in ref_names or e.name in PORT_SPANS for e in events["port"])


def test_traced_phases_nest_in_their_loads(traced):
    events, engine_id, _ = traced
    by_name = {}
    for ev in events["port"]:
        by_name.setdefault(ev.name, []).append(ev)
    for name in ("store.read", "h2d", "h2d.chunk", "init", "profile", "load", "prefill"):
        assert name in by_name, f"cold-start phase {name} never traced"
    assert len(by_name["decode.step"]) == 3
    cold, reload_ = by_name["load"]
    assert cold.track == f"eng:{engine_id}"
    (init,) = by_name["init"]
    assert cold.begin <= init.begin and init.end <= cold.end + 1e-6
    (read,) = by_name["store.read"]
    assert reload_.begin <= read.begin and read.end <= reload_.end + 1e-6
    assert read.args["bytes"] > 0 and read.args["retries"] == 0
    assert cold.args["pred"] > 0


def test_chrome_trace_loads(traced):
    events, _, tmp = traced
    path = port_obs.write_chrome_trace(events["port"], str(tmp / "trace.json"))
    evs = json.loads(open(path).read())["traceEvents"]
    assert any(e["ph"] == "M" for e in evs)  # named thread lanes
    spans = [e for e in evs if e["ph"] == "X"]
    assert spans and all(e["dur"] >= 0 for e in spans)
    assert len(spans) == len(events["port"])
