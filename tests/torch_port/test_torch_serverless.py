"""The port's serverless control plane against the reference.

Modeled plane (pure Python on both sides, so it must be bit-identical):
`ModeledFleetGateway` decisions, logs and summaries, `ClusterSim` results,
`run_serverless_sim` sinks and `affinity_schedule` entries, on the
scenarios of tests/test_fleet.py, test_serverless.py, test_cluster_golden.py
and test_scheduler_cluster.py.

Real plane (the reference `Engine` on the CPU against the port's
`Engine(device="cpu")`, fp32 smoke models over the same weights, the same
numpy-seeded prompt batches handed to both gateways): `Gateway` replays give
equal cold/warm sequences, lifecycle logs, per-load `LoadReport` and
`DataLoadStats` counters and greedy tokens; a two-engine `FleetGateway`
under the seeded `chaos_schedule` gives equal routing decisions and
per-engine fault ledgers (lifecycle and pre-warm logs compared in order,
since their idle stamps add the measured service wall).  Routing scores each engine's queue delay, which
grows by MEASURED service walls; the fleet traces therefore keep every gap
far above any service wall (asserted), so every queue delay is 0 and the
decisions depend on the trace clock alone.  The engine remainder the
control plane calls (`crash`, `prewarm`, `set_host_capacity`,
`host_resident_bytes`, `host_free_bytes`, `fault_summary`) leaves equal
ledgers after the call sequences of tests/test_chaos.py and
test_host_store_properties.py.

Two deliberate departures of the port are pinned here too: its `Engine`
frees the device buffers the pool evicted (in `load`, `release` and
`finish_instance`), and its gateways' walls end on the device.  Where the
pool evicts, the reference engine is given the same rule, and a separate
test shows what the reference does without.
"""
import dataclasses
import enum
import types

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.core.faults as ref_faults  # noqa: E402
import repro.core.scheduler as ref_sched  # noqa: E402
import repro.models.tensors as ref_tensors  # noqa: E402
import repro.serverless as ref_sl  # noqa: E402
import repro.serverless.lifecycle as ref_lc  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.faults as port_faults  # noqa: E402
import repro_torch.core.scheduler as port_sched  # noqa: E402
import repro_torch.models.tensors as port_tensors  # noqa: E402
import repro_torch.serverless as port_sl  # noqa: E402
import repro_torch.serverless.lifecycle as port_lc  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import Engine as PortEngine  # noqa: E402
from repro_torch.serving.step_graph import StepGraphs, shape_key  # noqa: E402

from torch_port_helpers import RecordingCapture, ref_named_numpy, to_f32  # noqa: E402


def plane(core, sl, lc, faults, sched, tensors):
    return types.SimpleNamespace(core=core, sl=sl, lc=lc, faults=faults,
                                 sched=sched, tensors=tensors)


REF = plane(ref_core, ref_sl, ref_lc, ref_faults, ref_sched, ref_tensors)
PORT = plane(port_core, port_sl, port_lc, port_faults, port_sched, port_tensors)


def plain(x):
    """A value with every dataclass, enum and tuple of either package turned
    into builtins, so results of the two packages compare with ==."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if type(x).__name__ == "BoundedLog":
        return [plain(v) for v in x]
    return x


def both(run):
    """`run(plane)` on the reference and on the port; asserts bit-identity
    and returns the (plain) result."""
    ref, port = plain(run(REF)), plain(run(PORT))
    assert port == ref
    return port


# ============================================================ modeled plane
FLEET_MODELS = slice(4, 8)  # tests/test_fleet.py: opt6.7B llama3B qwen3B opt1.3B


def _volley(p):
    models = p.core.PAPER_MODELS[FLEET_MODELS]
    return p.sl.burst_trace(n_requests=96, models=models, mean_interarrival=288.0,
                            burst_every_s=240.0, burst_size=8, burst_models=2,
                            burst_window_s=2.0, seed=7)


def _req(p, time, model, out=16):
    return p.core.Request(time=time, model_id=model, dataset="gsm8k",
                          prompt_tokens=64, output_tokens=out, batch_size=1)


def _colocation(p):
    m = p.core.PAPER_MODELS[FLEET_MODELS]
    L, A, B = m[0].model_id, m[1].model_id, m[2].model_id
    trace = []
    for rnd in range(4):
        base = rnd * 300.0
        trace.append(_req(p, base, L, out=4096))
        trace.append(_req(p, base + 5.0, B if rnd % 2 else A, out=4096))
        for i in range(6):
            trace.append(_req(p, base + 10.0 + 4.0 * i, A if i % 2 else B))
    trace.sort(key=lambda r: r.time)
    return trace


def _fleet(p, *, prewarm=True, keep_alive=None, **kw):
    if keep_alive is None:
        keep_alive = p.lc.AdaptiveHistogram(window_s=720.0, max_ttl=45.0)
    return p.sl.ModeledFleetGateway(
        p.core.PAPER_MODELS[FLEET_MODELS], n_engines=kw.pop("n_engines", 2),
        pool_bytes=int(20e9), host_cache_bytes=int(24e9), seed=7,
        keep_alive=keep_alive, prewarm=prewarm, prewarm_min_benefit=1.0, **kw)


def _fleet_outcome(fg):
    return dict(decisions=fg.decisions, log=fg.log, lifecycle=fg.lifecycle.log,
                summary=fg.summary(), migrations=fg.migrate_log,
                faults=[getattr(n.engine.faults, "log", None) for n in fg.nodes],
                records=fg.sink.records)


def _modeled_prewarm(p):
    fg = _fleet(p)
    fg.run_trace(_volley(p))
    return _fleet_outcome(fg)


def _modeled_reactive(p):
    fg = _fleet(p, prewarm=False)
    fg.run_trace(_volley(p))
    return _fleet_outcome(fg)


def _modeled_fixed_ttl_pressure(p):
    fg = _fleet(p, keep_alive="fixed:30")
    trace = _volley(p)
    fg.run_trace(trace, pressure=p.sl.pressure_wave(
        horizon_s=trace[-1].time, base_bytes=int(24e9), period_s=600.0))
    return _fleet_outcome(fg)


def _modeled_failover(p, recover=True):
    trace = _volley(p)
    horizon = trace[-1].time
    fg = _fleet(p, prewarm=False,
                faults=[p.faults.FaultInjector(seed=7) for _ in range(2)])
    fg.inject_failure(horizon / 3.0, "engine0",
                      recover_after=(horizon / 3.0 if recover else None))
    fg.run_trace(trace)
    return _fleet_outcome(fg)


def _modeled_chaos_schedule(p):
    """tests/test_chaos.py::_chaos_fleet: the seeded schedule on the
    modeled plane, store faults keyed by model id."""
    models = p.core.PAPER_MODELS[FLEET_MODELS]
    trace = p.sl.poisson_trace(n_requests=60, models=models, seed=5,
                               mean_interarrival=12.0)
    specs, events = p.sl.chaos_schedule(
        seed=5, n_engines=2, crash_time=trace[len(trace) // 3].time,
        recover_after=60.0, store_keys=[m.model_id for m in models])
    inj = [p.faults.FaultInjector(specs=tuple(s), seed=5) for s in specs]
    fg = p.sl.ModeledFleetGateway(models, n_engines=2, pool_bytes=int(20e9),
                                  host_cache_bytes=int(24e9), seed=5,
                                  keep_alive="fixed:40", prewarm=False,
                                  faults=inj)
    fg.run_trace(trace, faults=events)
    return _fleet_outcome(fg)


def _modeled_migration(p):
    fg = _fleet(p, prewarm=False, keep_alive="fixed:60", migrate=True)
    fg.run_trace(_colocation(p))
    return _fleet_outcome(fg)


MODELED_FLEET = {
    "prewarm": _modeled_prewarm,
    "reactive": _modeled_reactive,
    "fixed_ttl_pressure": _modeled_fixed_ttl_pressure,
    "failover": _modeled_failover,
    "failover_no_recovery": lambda p: _modeled_failover(p, recover=False),
    "chaos_schedule": _modeled_chaos_schedule,
    "migration": _modeled_migration,
}


@pytest.mark.parametrize("scenario", sorted(MODELED_FLEET))
def test_modeled_fleet_bit_identical(scenario):
    out = both(MODELED_FLEET[scenario])
    assert out["decisions"] and out["summary"]["n"] == len(out["records"])


GOLDEN_SEED = 1234  # tests/test_cluster_golden.py


def _cluster_golden(policy, **over):
    def run(p):
        trace = p.core.generate_trace(n_requests=240, locality="L3",
                                      mean_interarrival=10.0, seed=GOLDEN_SEED,
                                      max_output_tokens=128)
        pol = dataclasses.replace(p.core.POLICIES[policy], **over)
        sim = p.core.ClusterSim(p.core.PAPER_MODELS, pol, n_workers=2,
                                seed=GOLDEN_SEED)
        results = sim.run(trace)
        return dict(results=results, summary=p.core.summarize(results))
    return run


def _cluster_failure(p):
    """tests/test_scheduler_cluster.py::test_fault_injection_and_recovery."""
    trace = p.core.generate_trace(n_requests=120, locality="L3",
                                  mean_interarrival=10.0, seed=33)
    sim = p.core.ClusterSim(p.core.PAPER_MODELS, p.core.POLICIES["tangram"],
                            n_workers=3, seed=5)
    sim.inject_failure(trace[40].time + 0.1, "gpu0", recover_after=200.0)
    results = sim.run(trace)
    return dict(results=results, summary=p.core.summarize(results))


CLUSTER = {
    **{pol: _cluster_golden(pol) for pol in ("sllm", "reuse", "tangram", "tangram-conc")},
    "tier_32e9": _cluster_golden("tangram-tier", name="tier-golden",
                                 host_cache_bytes=32e9),
    "failure_recovery": _cluster_failure,
}


@pytest.mark.parametrize("case", sorted(CLUSTER))
def test_cluster_sim_bit_identical(case):
    out = both(CLUSTER[case])
    assert out["results"]


def _serverless_sweep(ka, pressure=False):
    """tests/test_serverless.py::_sweep under one keep-alive policy."""
    def run(p):
        models = p.core.PAPER_MODELS[2:6]
        trace = p.sl.make_trace("poisson", n_requests=100, models=models, seed=7,
                                mean_interarrival=12.0, max_output_tokens=128)
        pol = dataclasses.replace(p.core.POLICIES["tangram-serverless"],
                                  name=f"t-{ka}", lifecycle=ka)
        press = (p.sl.pressure_walk(horizon_s=trace[-1].time, base_bytes=int(64e9),
                                    step_s=60.0, seed=7) if pressure else ())
        sim, sink = p.sl.run_serverless_sim(models, trace, pol, n_workers=2,
                                            seed=7, pressure=press)
        return dict(records=sink.records, summary=sink.summary(),
                    lifecycle=sim.lifecycle.log if getattr(sim, "lifecycle", None)
                    else None)
    return run


SERVERLESS = {"zero": _serverless_sweep("zero"), "fixed": _serverless_sweep("fixed:60"),
              "adaptive": _serverless_sweep("adaptive"),
              "adaptive_pressure": _serverless_sweep("adaptive", pressure=True)}


@pytest.mark.parametrize("ka", sorted(SERVERLESS))
def test_run_serverless_sim_bit_identical(ka):
    out = both(SERVERLESS[ka])
    assert out["summary"]["n"] == 100


class _Device:
    """tests/test_scheduler_cluster.py's fake devices: resident fingerprints,
    an optional host tier, queue delay and migration offer."""

    def __init__(self, did, cap, resident=(), host=(), delay=None, offer=None):
        self.device_id, self.cap = did, cap
        self.resident, self.host = set(resident), set(host)
        self.delay, self.offer = delay, offer
        self.hints = []

    def can_run(self, model_bytes, model_id=None):
        return model_bytes <= self.cap

    def reusable_bytes(self, records):
        return sum(r.nbytes for r in records if r.fingerprint in self.resident)

    def host_resident_bytes(self, records):
        return sum(r.nbytes for r in records
                   if r.fingerprint not in self.resident and r.fingerprint in self.host)

    def expected_queue_delay(self, now):
        return self.delay if self.delay is not None else 0.0

    def migration_offer(self, now):
        return self.offer

    def hint_prefetch(self, model_id, records, now):
        self.hints.append((model_id, now))


def _records(p, mid, sizes):
    return [p.tensors.TensorRecord(name=f"{mid}/t{i}", shape=(s,), dtype="uint8",
                                   fingerprint=f"{mid}/t{i}", nbytes=s)
            for i, s in enumerate(sizes)]


@pytest.mark.parametrize("policy", ["eq3", "eq3+queue"])
def test_affinity_schedule_entries_bit_identical(policy):
    def run(p):
        a = _records(p, "a", [300, 300, 400])
        b = _records(p, "b", [6_000_000_000, 100])
        fps = [r.fingerprint for r in a + b]
        devs = [_Device("d0", 10**12, resident=fps[:2], delay=2.0),
                _Device("d1", 10**12, host=fps, delay=0.5, offer=0.1),
                _Device("d2", 500),
                _Device("d3", 10**12, resident=fps[3:], offer=9.0)]
        scheds, queued = p.sched.affinity_schedule(
            [("a", a, 1000), ("b", b, None), ("a", a, 1000), ("c", a, 10**13)],
            devs, p.core.paper_l40(), policy=policy, now=3.0)
        return dict(scheds=scheds, queued=queued, hints=[d.hints for d in devs])
    out = both(run)
    assert out["scheds"] and out["queued"]


# =============================================================== real plane
def _cfgs(name, layers):
    over = dict(num_layers=layers, vocab_size=512, dtype="float32")
    return (dataclasses.replace(ref_config(name).smoke(), **over),
            dataclasses.replace(port_config(name).smoke(), **over))


MODELS = {"llama3.2-1b": 2, "deepseek-7b": 2}
PROMPT, GEN = 12, 3


def _loads_of(eng):
    """Everything one load accounts, timings aside."""
    s = {k: v for k, v in eng.last_load.as_dict().items() if "seconds" not in k}
    return s


def _report(rep):
    return (rep.bytes_total, rep.bytes_hit, rep.bytes_transferred,
            rep.bytes_from_host, rep.bytes_from_store, rep.bytes_evicted,
            rep.tensors_hit, rep.tensors_loaded, rep.reuse_fraction,
            rep.load_seconds)


class _Recording:
    """Engine mixin: ledgers every load and the greedy tokens of every
    instance."""

    def _init_rec(self):
        self.loads, self.tokens = [], []

    def load(self, model_id, **kw):
        rep = super().load(model_id, **kw)
        self.loads.append((model_id, _report(rep), _loads_of(self),
                           sorted(self._tensors)))
        return rep

    def start_instance(self, model_id, **kw):
        inst = self._start(model_id, **kw)
        toks = []
        self.tokens.append((model_id, toks))
        prefill, decode = inst.prefill, inst.decode

        def rec(out):
            toks.append(to_f32(out).argmax(-1).tolist())
            return out

        inst.prefill = lambda batch, **k: rec(prefill(batch, **k))
        inst.decode = lambda tok: rec(decode(tok))
        return inst


class _RefStart:
    def _start(self, model_id, **kw):
        # the reference's jitted plain paged attention (tests/test_kernels.py
        # pins it to its Pallas kernel); the port's CPU tensors run its own
        return RefEngine.start_instance(self, model_id, attn_mode="ref", **kw)


class _FreesEvicted:
    """The port `Engine`'s rule on the reference engine: what the pool
    evicted is freed after `load`, `release` and `finish_instance`, sparing
    models in use (`Engine.sync_evictions(keep_active=True)`).  The port
    frees inside `load` before it moves the misses; a miss is never a
    buffer it frees (the loading model is in use), so the ledgers agree."""

    def load(self, model_id, **kw):
        rep = super().load(model_id, **kw)
        PortEngine.sync_evictions(self, keep_active=True)
        return rep

    def release(self, model_id):
        super().release(model_id)
        PortEngine.sync_evictions(self, keep_active=True)

    def finish_instance(self, model_id):
        super().finish_instance(model_id)
        PortEngine.sync_evictions(self, keep_active=True)

    def _drop_graphs(self, **which):
        """`sync_evictions` drops the port's captured steps with a params
        tree; the reference's compiled step holds no device pointers."""


class RecRef(_Recording, _RefStart, RefEngine):
    pass


class SyncRef(_Recording, _FreesEvicted, _RefStart, RefEngine):
    pass


class RecPort(_Recording, PortEngine):
    def _start(self, model_id, **kw):
        return PortEngine.start_instance(self, model_id, **kw)


def engine_pair(cap, ref_cls=RecRef, n=1, faults=None, **kw):
    """`n` reference and `n` port engines with the fp32 smoke models
    registered over the same weights (drawn once by the reference).
    `faults`: one (reference injector, port injector) pair per engine."""
    weights = {}
    for i, (name, layers) in enumerate(MODELS.items()):
        rc, pc = _cfgs(name, layers)
        params = ref_build(rc).init(jax.random.PRNGKey(i + 1))
        weights[name] = (rc, pc, params, ref_named_numpy(params))
    refs, ports = [], []
    for e in range(n):
        rf, pf = faults[e] if faults else (None, None)
        ref = ref_cls(cap, engine_id=f"engine{e}", faults=rf, **kw)
        port = RecPort(cap, engine_id=f"engine{e}", device="cpu", faults=pf, **kw)
        for eng in (ref, port):
            eng._init_rec()
        for name, (rc, pc, params, named) in weights.items():
            ref.register(name, rc, init_fn=lambda p=params: p)
            port.register(name, pc, init_fn=lambda n=named, c=pc: params_from_numpy(
                n, c, device="cpu"))
        refs.append(ref)
        ports.append(port)
    return refs, ports


def numpy_batches(gw_cls, to_batch):
    """A gateway subclass whose prompt batches come from numpy with a seed,
    so both packages prefill the same tokens."""
    class NumpyBatches(gw_cls):
        def _prefill_batch(self, model_id, seed):
            cfg = self.engine.models[model_id].cfg
            toks = np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (1, self.prompt_len)).astype(np.int32)
            return {"tokens": to_batch(toks)}
    return NumpyBatches


REF_GATEWAY = numpy_batches(ref_sl.Gateway, jnp.asarray)
PORT_GATEWAY = numpy_batches(port_sl.Gateway, torch.from_numpy)


def _trace(p, n, seed, mean):
    models = [p.core.SimModel(name, 1e6, 1) for name in MODELS]
    return p.sl.poisson_trace(n_requests=n, models=models, seed=seed,
                              mean_interarrival=mean)


def _gateway_run(ref_cls, cap, keep_alive, seed, graphs=None, **kw):
    """The same trace through both gateways; `graphs`: the port engine's
    `StepGraphs` (else its CPU default, none)."""
    (ref,), (port,) = engine_pair(cap, ref_cls=ref_cls, **kw)
    if graphs is not None:
        port.step_graphs = graphs
    out = []
    for gw_cls, eng, p in ((REF_GATEWAY, ref, REF), (PORT_GATEWAY, port, PORT)):
        gw = gw_cls(eng, keep_alive=keep_alive, prompt_len=PROMPT, gen_tokens=GEN)
        sink = gw.run_trace(_trace(p, 7, seed, 30.0))
        out.append(dict(cold=[(r.model_id, r.cold) for r in sink.records],
                        lifecycle=plain(gw.lifecycle.log), loads=eng.loads,
                        tokens=eng.tokens, store=eng.persistent_store.nbytes(),
                        host=eng.host_store.snapshot().as_dict()))
        eng.close()
    return out


def _pool_for_one_model():
    """A pool that holds either smoke model with its KV but not both."""
    sizes = [sum(r.nbytes for r in port_tensors.spec_records(n, _cfgs(n, l)[1]))
             for n, l in MODELS.items()]
    return max(sizes) + min(sizes) // 2


@pytest.mark.parametrize("keep_alive,seed", [("fixed:45", 3), ("adaptive", 4),
                                             ("zero", 5)])
def test_gateway_matches_reference(keep_alive, seed):
    """A roomy pool: nothing is evicted, so the port engine's freeing of
    evicted buffers is a no-op and the reference runs exactly as it ships."""
    ref, port = _gateway_run(RecRef, 256 << 20, keep_alive, seed)
    assert port == ref
    assert {c for _, c in ref["cold"]} == {True, False} or keep_alive == "zero"
    assert all(len(t) == 1 + GEN for _, t in ref["tokens"])


def test_gateway_matches_reference_when_the_pool_evicts():
    """A pool that holds one model: switching models evicts part of the
    other, and the reload moves exactly the evicted bytes again (0 < reuse
    < 1).  The reference engine gets the port engine's freeing rule."""
    ref, port = _gateway_run(SyncRef, _pool_for_one_model(), "zero", 6)
    assert port == ref
    partial = [ld for ld in port["loads"] if 0 < ld[1][8] < 1]
    assert partial, "no partial-reuse reload in the trace"
    for _, rep, stats, _ in port["loads"]:
        assert stats["bytes_h2d"] == rep[2]  # moved == the report's transfer
        assert stats["bytes_device_hit"] + stats["bytes_h2d"] == rep[0]


class KeyedGraphs(StepGraphs):
    """The port's compiled steps through the CPU double of a CUDA graph,
    recording each call's (shape, params tree) key."""

    def __init__(self):
        super().__init__(RecordingCapture())
        self.keys = set()

    def step(self, model_id, fn, static, inputs, *, tree, baked=(), slab=None):
        self.keys.add((shape_key(static, (*inputs, *baked)), tree))
        return super().step(model_id, fn, static, inputs, tree=tree, baked=baked, slab=slab)


@pytest.mark.parametrize("pool", ["roomy", "one model"])
def test_graphed_gateway_matches_reference(pool):
    """The port gateway with its decode steps captured and kept across
    requests: cold/warm starts, lifecycle, every load's ledger, greedy
    tokens and the host tier equal the reference gateway's over the same
    trace; each distinct (shape, tree) key is captured once and every
    later request over it replays (a re-assembled tree is a new key); and
    the port's specialisations equal the reference's compiled cache of
    `_paged_decode_step`, which outlives its instances as the keys do."""
    from repro.serving import engine as ref_engine

    ref_cls, cap, keep_alive, seed = ((RecRef, 256 << 20, "fixed:45", 3) if pool == "roomy"
                                      else (SyncRef, _pool_for_one_model(), "zero", 6))
    ref_engine._paged_decode_step.clear_cache()
    g = KeyedGraphs()
    ref, port = _gateway_run(ref_cls, cap, keep_alive, seed, graphs=g)
    assert port == ref
    assert g.captures == g.eager_steps == len(g.keys)
    assert g.replays == 7 * GEN - g.eager_steps  # a key's first call alone is eager
    assert ref_engine._paged_decode_step._cache_size() == len(g.shapes) == len(MODELS)
    # the roomy pool keeps both trees (7 requests, 2 keys); in the one-model
    # pool each switch re-assembles the model's tree (l l d l d d l: 5 keys)
    assert len(g.keys) == {"roomy": 2, "one model": 5}[pool]


def test_reference_gateway_counts_evicted_buffers_as_device_hits():
    """What the port departs from: without the syncs, the reference's data
    plane keeps the buffers its pool evicted, so a partial-reuse reload
    moves nothing while its report says bytes were transferred."""
    (ref,), (port,) = engine_pair(_pool_for_one_model())
    gw = REF_GATEWAY(ref, keep_alive="zero", prompt_len=PROMPT, gen_tokens=1)
    gw.run_trace(_trace(REF, 7, 6, 30.0))
    stale = [(rep, stats) for _, rep, stats, _ in ref.loads
             if 0 < rep[8] < 1]
    assert stale and all(s["bytes_h2d"] == 0 < rep[2] for rep, s in stale)
    ref.close(), port.close()


def test_fleet_matches_reference_under_chaos_schedule():
    """Two engines per package, the seeded chaos schedule (an h2d stall per
    engine, a crash and a recovery), adaptive keep-alive with pre-warm."""
    ref_specs, events = ref_sl.chaos_schedule(seed=1, n_engines=2, crash_time=900.0,
                                              recover_after=400.0, stall_s=0.001)
    port_specs, port_events = port_sl.chaos_schedule(
        seed=1, n_engines=2, crash_time=900.0, recover_after=400.0, stall_s=0.001)
    assert plain(port_specs) == plain(ref_specs) and plain(port_events) == plain(events)
    faults = [(ref_faults.FaultInjector(specs=tuple(r), seed=1),
               port_faults.FaultInjector(specs=tuple(q), seed=1))
              for r, q in zip(ref_specs, port_specs)]
    refs, ports = engine_pair(256 << 20, n=2, faults=faults)
    out = []
    for engines, p, evs in ((refs, REF, events), (ports, PORT, port_events)):
        fg = FLEET_WITH_BATCHES[p is REF](engines, keep_alive="adaptive",
                                          prompt_len=PROMPT, gen_tokens=GEN)
        trace = _trace(p, 10, 11, 150.0)
        gaps = [b.time - a.time for a, b in zip(trace, trace[1:])]
        sink = fg.run_trace(trace, faults=evs)
        walls = [r.init_s + r.load_s + r.profile_s + r.prefill_s + r.decode_s
                 for r in sink.records]
        assert max(walls) < min(gaps), (max(walls), min(gaps))
        # idle / expire stamps and pre-warm timers sit at arrival + measured
        # service wall: compare their order, not their times
        out.append(dict(decisions=fg.decisions,
                        log=[(e[0], e[2], e[3]) for e in fg.log],
                        lifecycle=[(e[1], e[2]) for e in plain(fg.lifecycle.log)],
                        faults=[e.fault_summary() for e in engines],
                        loads=[e.loads for e in engines],
                        tokens=[e.tokens for e in engines],
                        summary={k: v for k, v in fg.summary().items()
                                 if "ttft" not in k and k not in ("queue_mean",
                                                                  "load_mean")}))
        for e in engines:
            e.close()
    ref, port = out
    assert port == ref
    assert all(d[4] == 0.0 for d in ref["decisions"])  # no queueing: clock-only
    assert ref["summary"]["engine_crashes"] == 1 == ref["summary"]["engine_recoveries"]
    assert sum(f["h2d_stalls"] for f in ref["faults"]) >= 1
    assert {d[2] for d in ref["decisions"]} == {"engine0", "engine1"}


def _fleet_with_batches(p, to_batch):
    """A FleetGateway whose serve seam prefills numpy-seeded batches (it
    calls the module-level `make_prefill_batch`, patched for the call)."""
    mod = __import__(p.sl.FleetGateway.__module__, fromlist=["x"])

    class Fleet(p.sl.FleetGateway):
        def _serve(self, node, req, now, cold, queue_s):
            def batch(engine, model_id, prompt_len, seed):
                cfg = engine.models[model_id].cfg
                toks = np.random.default_rng(seed).integers(
                    0, cfg.vocab_size, (1, prompt_len)).astype(np.int32)
                return {"tokens": to_batch(toks)}
            keep = mod.make_prefill_batch
            mod.make_prefill_batch = batch
            try:
                return super()._serve(node, req, now, cold, queue_s)
            finally:
                mod.make_prefill_batch = keep
    return Fleet


FLEET_WITH_BATCHES = {True: _fleet_with_batches(REF, jnp.asarray),
                     False: _fleet_with_batches(PORT, torch.from_numpy)}


# ========================================================= engine remainder
def _chaos_engines(cap_host=0, faults=True):
    """tests/test_chaos.py's `chaos_engine` fixture, once per package."""
    inj = [(ref_faults.FaultInjector(), port_faults.FaultInjector())] if faults else None
    (ref,), (port,) = engine_pair(256 << 20, faults=inj, host_cache_bytes=cap_host)
    return ref, port


def _engine_ledger(eng):
    return dict(faults=eng.fault_summary(), host=eng.host_store.snapshot().as_dict(),
                store=eng.persistent_store.nbytes(), stored=len(eng.persistent_store),
                pins=sorted(eng._host_pins), tensors=sorted(eng._tensors),
                free=eng.host_free_bytes(),
                host_resident={m: eng.host_resident_bytes(eng.records_of(m))
                               for m in MODELS},
                crashes=eng.crashes)


def _cold_reload(eng, fault_spec):
    """tests/test_chaos.py::_cold_reload_with: warm up, spill through the
    cap-0 host tier, arm the faults, crash, reload through the store."""
    m = "llama3.2-1b"
    eng.load(m)
    eng.release(m)
    recs = eng.records_of(m)
    eng.faults.arm(fault_spec(recs))
    eng.crash()
    eng.load(m)


def _spec(p, recs, *items):
    return tuple(p.faults.FaultSpec(point, at=(0,), mode=mode,
                                    key=(recs[i].fingerprint if i is not None else None))
                 for point, mode, i in items)


CHAOS_SEQUENCES = {
    "crash_reload": (),
    "corrupt": (("store.read", "corrupt", 0),),
    "transient": (("store.read", "error", 0),),
    "ledger_balance": (("store.read", "corrupt", 0), ("store.read", "error", 1),
                       ("h2d.chunk", "error", None)),
}


@pytest.mark.parametrize("case", sorted(CHAOS_SEQUENCES))
def test_engine_crash_ledgers_match_reference(case):
    ref, port = _chaos_engines()
    items = CHAOS_SEQUENCES[case]
    _cold_reload(ref, lambda recs: _spec(REF, recs, *items))
    _cold_reload(port, lambda recs: _spec(PORT, recs, *items))
    assert _engine_ledger(port) == _engine_ledger(ref)
    assert port.loads == ref.loads
    assert port.fault_summary()["crashes"] == 1
    ref.close(), port.close()


def test_crash_with_armed_hint_matches_reference():
    """tests/test_chaos.py:306: a hint's pins are dropped and counted at the
    crash; the retired tier squeezes; a fresh load cycle leaves no residue."""
    out = []
    for eng in _chaos_engines(cap_host=None):
        m = "llama3.2-1b"
        eng.load(m)
        eng.release(m)
        job = eng.prefetch(m)
        assert job.owns_pin
        old = eng.host_store
        eng.crash()
        squeezed = old.set_capacity_bytes(0)
        led = _engine_ledger(eng)
        eng.load(m)
        eng.release(m)
        out.append((led, squeezed, old.nbytes(), _engine_ledger(eng)))
        eng.close()
    assert out[1] == out[0]
    assert out[0][0]["faults"]["prefetch_pins_dropped"] == 1


def test_prewarm_pressure_and_host_accessors_match_reference():
    """prewarm + tenant pressure through set_host_capacity, with the host
    accessors the affinity score reads after every step."""
    out = []
    for eng in _chaos_engines(cap_host=None, faults=False):
        a, b = MODELS
        steps = []
        steps.append(_report(eng.prewarm(a)))
        steps.append(_engine_ledger(eng))
        eng.release(a)
        steps.append(eng.set_host_capacity(1 << 20))
        steps.append(_engine_ledger(eng))
        steps.append(_report(eng.prewarm(b)))
        eng.drop_device_copies(a)
        steps.append(_engine_ledger(eng))
        steps.append(eng.set_host_capacity(None))
        steps.append(_report(eng.load(a)))
        steps.append(_engine_ledger(eng))
        steps.append(eng.loads)
        out.append(steps)
        eng.close()
    assert out[1] == out[0]


def _concurrent_prefetch(eng, spec_cls):
    """tests/test_host_store_properties.py:344 / :397: a prefetch of model A
    promotes from the worker thread while model B loads over a cap-0 host
    tier.  Who promotes which tensor is a race; the totals are not."""
    a, b = MODELS
    total_a = eng.load(a).bytes_total
    eng.load(b)
    eng.persistent_store.store_bw = 400e6
    a_fps = [r.fingerprint for r in eng.models[a].records]
    totals = []
    for round_i in range(3):
        eng.drop_device_copies(a)
        eng.drop_device_copies(b)
        if spec_cls is not None:  # fault the first read of another tensor of A
            eng.faults.arm((spec_cls("store.read", at=(0,), mode="error",
                                     key=a_fps[round_i % len(a_fps)]),))
        eng.prefetch(a)
        eng.load(b)
        rep = eng.load(a)
        s = eng.last_load
        totals.append((rep.bytes_transferred == total_a,
                       s.bytes_prefetched + s.bytes_store, s.leaves_materialized,
                       s.tensors_quarantined))
        eng.release(b)
        eng.release(a)
    fs = eng.fault_summary()
    return dict(totals=totals, pinned=eng.host_store.pinned_nbytes(),
                store=eng.persistent_store.nbytes(),
                host=eng.host_store.nbytes(), crashes=fs["crashes"],
                injected=fs["injected"], quarantined=fs["store_quarantined"])


@pytest.mark.parametrize("faulted", [False, True])
def test_concurrent_prefetch_totals_match_reference(faulted):
    out = []
    for eng, p in zip(_chaos_engines(), (REF, PORT)):
        out.append(_concurrent_prefetch(eng, p.faults.FaultSpec if faulted else None))
        eng.close()
    assert out[1] == out[0]
    assert out[0]["pinned"] == 0 and out[0]["host"] == 0


def test_a_load_can_evict_its_own_hits_and_the_port_keeps_them():
    """A fault of the reference's Reuse Store, kept by the port's copy:
    `ReuseStore.load_model` activates the model only after allocating its
    misses, so the allocation may evict the model's own resident tensors it
    has just counted as hits.  The reference's data plane never notices (it
    keeps every evicted buffer); the port's `Engine` frees evicted buffers,
    so it must spare a model in use — its instance still
    reads them.  Both stores make the same decision on the same sequence."""
    names = list(MODELS)
    evicted_hits = []
    for p, eng_cls, device in ((REF, RefEngine, None), (PORT, PortEngine, "cpu")):
        cfgs = {n: _cfgs(n, layers)[p is PORT] for n, layers in MODELS.items()}
        cfgs[names[1]] = dataclasses.replace(cfgs[names[1]], num_layers=4)
        kw = {} if device is None else {"device": device}
        sizes = [sum(r.nbytes for r in port_tensors.spec_records(n, _cfgs(n, 2)[1]))
                 for n in names]
        eng = eng_cls(int(max(sizes) * 2.2), **kw)
        for n, c in cfgs.items():
            eng.register(n, c)
        found = []
        for step, m in enumerate([names[1], names[0], names[1], names[0], names[1],
                                  names[0]]):
            before = set(eng.store.tensor_map)
            eng.load(m)
            live = set(eng.store.tensor_map)
            lost = [r.name for r in eng.records_of(m)
                    if r.fingerprint in before and r.fingerprint not in live]
            found.append((step, m, lost))
            if p is PORT and lost:
                assert m in eng._params_cache  # spared: the model is in use
                eng.release(m)
                assert m not in eng._params_cache  # freed once released
            else:
                eng.release(m)
        evicted_hits.append(found)
        eng.close()
    assert evicted_hits[1] == evicted_hits[0]
    assert any(lost for _, _, lost in evicted_hits[0]), evicted_hits[0]
