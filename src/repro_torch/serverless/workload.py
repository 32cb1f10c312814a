"""Trace-driven workload generator + co-located-tenant pressure feed.

``core.trace.generate_trace`` models the paper's locality-controlled Gamma
arrivals; serverless gateways see richer shapes.  This driver synthesizes
three arrival processes over the same model pool — all seeded, all
deterministic, all returning plain ``core.trace.Request`` lists so every
existing consumer (cluster sim, gateway, benchmarks) replays them:

  * ``poisson``   memoryless arrivals at a constant mean rate — the
                  steady-state baseline every queueing result assumes;
  * ``diurnal``   a sinusoidally-modulated rate (day/night load swing),
                  sampled by Lewis thinning so the process is an exact
                  inhomogeneous Poisson, not a binned approximation;
  * ``burst``     Azure-trace-style: a Poisson background plus periodic
                  near-simultaneous request volleys aimed at the hottest
                  models — the stampede shape that separates keep-alive
                  policies (a TTL that covers the inter-burst gap turns the
                  whole volley warm).

The **tenant-pressure feed** models the ROADMAP's co-located non-LLM
tenants: a deterministic schedule of ``PressureEvent``s that shrink/grow
the host-tier byte budget while requests are in flight.  Both planes apply
it through the ``set_capacity_bytes`` resize path (``SimHostCache`` /
``HostTensorStore``), where eviction-on-shrink respects pins.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.trace import DATASETS, PAPER_MODELS, Request, SimModel

#: Arrival-process names `make_trace` (and every --trace flag) accepts.
ARRIVALS = ("poisson", "diurnal", "burst")


# ---------------------------------------------------------------- requests
def _popularity(models: Sequence[SimModel], rng: random.Random,
                zipf: float) -> list[float]:
    """Zipf popularity over the pool, rank order shuffled by the seed (the
    same skew source core.trace.generate_trace uses)."""
    ranks = list(range(1, len(models) + 1))
    rng.shuffle(ranks)
    pop = [1.0 / (r ** zipf) for r in ranks]
    total = sum(pop)
    return [p / total for p in pop]


def _request(rng: random.Random, t: float, model_id: str, *,
             batch_size: int, max_output_tokens: int) -> Request:
    ds = rng.choice(list(DATASETS))
    (pm, ps), (om, osig) = DATASETS[ds]
    prompt = max(8, int(rng.lognormvariate(pm, ps)))
    output = max(4, int(rng.lognormvariate(om, osig)))
    return Request(time=t, model_id=model_id, dataset=ds,
                   prompt_tokens=min(prompt, 4096),
                   output_tokens=min(output, max_output_tokens),
                   batch_size=batch_size)


def _assemble(times: Sequence[float], models: Sequence[SimModel],
              rng: random.Random, *, zipf: float, batch_size: int,
              max_output_tokens: int) -> list[Request]:
    pop = _popularity(models, rng, zipf)
    idxs = range(len(models))
    return [_request(rng, t,
                     models[rng.choices(idxs, weights=pop)[0]].model_id,
                     batch_size=batch_size,
                     max_output_tokens=max_output_tokens)
            for t in times]


def poisson_trace(*, n_requests: int,
                  models: Sequence[SimModel] = tuple(PAPER_MODELS),
                  mean_interarrival: float = 20.0, seed: int = 0,
                  zipf: float = 1.1, batch_size: int = 1,
                  max_output_tokens: int = 256) -> list[Request]:
    """Homogeneous Poisson arrivals (exponential inter-arrival gaps)."""
    rng = random.Random(seed)
    t = 0.0
    times = []
    for _ in range(n_requests):
        t += rng.expovariate(1.0 / mean_interarrival)
        times.append(t)
    return _assemble(times, models, rng, zipf=zipf, batch_size=batch_size,
                     max_output_tokens=max_output_tokens)


def diurnal_trace(*, n_requests: int,
                  models: Sequence[SimModel] = tuple(PAPER_MODELS),
                  mean_interarrival: float = 20.0, period_s: float = 1200.0,
                  amplitude: float = 0.8, seed: int = 0, zipf: float = 1.1,
                  batch_size: int = 1,
                  max_output_tokens: int = 256) -> list[Request]:
    """Inhomogeneous Poisson with rate
    lambda(t) = base * (1 + amplitude * sin(2 pi t / period)), sampled by
    Lewis thinning: candidates arrive at the PEAK rate and survive with
    probability lambda(t)/lambda_max — an exact sampler, so the quiet
    trough really is (1-amplitude)/(1+amplitude) times the peak."""
    assert 0.0 <= amplitude < 1.0
    rng = random.Random(seed)
    base = 1.0 / mean_interarrival
    lam_max = base * (1.0 + amplitude)
    t = 0.0
    times = []
    while len(times) < n_requests:
        t += rng.expovariate(lam_max)
        lam = base * (1.0 + amplitude * math.sin(2.0 * math.pi * t / period_s))
        if rng.random() * lam_max <= lam:
            times.append(t)
    return _assemble(times, models, rng, zipf=zipf, batch_size=batch_size,
                     max_output_tokens=max_output_tokens)


def burst_trace(*, n_requests: int,
                models: Sequence[SimModel] = tuple(PAPER_MODELS),
                mean_interarrival: float = 20.0, burst_every_s: float = 300.0,
                burst_size: int = 8, burst_models: int = 2,
                burst_window_s: float = 2.0, seed: int = 0,
                zipf: float = 1.1, batch_size: int = 1,
                max_output_tokens: int = 256) -> list[Request]:
    """Poisson background + periodic volleys at the most popular models.

    Every ``burst_every_s`` seconds, ``burst_size`` requests land inside
    ``burst_window_s`` seconds, round-robin over the ``burst_models``
    hottest models of the background popularity.  ``n_requests`` counts the
    TOTAL (background + burst) so policy comparisons stay same-sized."""
    rng = random.Random(seed)
    pop = _popularity(models, rng, zipf)
    hot = sorted(range(len(models)), key=lambda i: -pop[i])[:max(1, burst_models)]
    per_burst = max(1, burst_size)
    out: list[Request] = []
    t = 0.0
    next_burst = burst_every_s
    while len(out) < n_requests:
        gap = rng.expovariate(1.0 / mean_interarrival)
        if t + gap >= next_burst and len(out) + per_burst <= n_requests:
            t0 = next_burst
            for j in range(per_burst):
                out.append(_request(
                    rng, t0 + rng.uniform(0.0, burst_window_s),
                    models[hot[j % len(hot)]].model_id,
                    batch_size=batch_size,
                    max_output_tokens=max_output_tokens))
            next_burst += burst_every_s
            continue
        t += gap
        idx = rng.choices(range(len(models)), weights=pop)[0]
        out.append(_request(rng, t, models[idx].model_id,
                            batch_size=batch_size,
                            max_output_tokens=max_output_tokens))
    return sorted(out[:n_requests], key=lambda r: r.time)


def make_trace(kind: str, *, n_requests: int,
               models: Sequence[SimModel] = tuple(PAPER_MODELS),
               seed: int = 0, **kw) -> list[Request]:
    """Dispatch on the arrival-process name (see ``ARRIVALS``)."""
    fns = {"poisson": poisson_trace, "diurnal": diurnal_trace,
           "burst": burst_trace}
    if kind not in fns:
        raise ValueError(f"unknown arrival process {kind!r} "
                         f"(expected one of {ARRIVALS})")
    return fns[kind](n_requests=n_requests, models=models, seed=seed, **kw)


# ---------------------------------------------------------------- pressure
@dataclass(frozen=True)
class PressureEvent:
    """At ``time``, the host-tier byte budget becomes ``capacity_bytes``
    (what the co-located tenants left for the model store)."""

    time: float
    capacity_bytes: int


def pressure_wave(*, horizon_s: float, base_bytes: int,
                  low_frac: float = 0.5, period_s: float = 600.0,
                  duty: float = 0.5) -> list[PressureEvent]:
    """Square-wave pressure: each period the budget drops to
    ``low_frac * base_bytes`` for ``duty`` of the period (the tenant's
    working phase), then recovers.  Deterministic — the worst-case
    repeatable squeeze for golden tests and the fig16 sweep."""
    assert 0.0 < low_frac <= 1.0 and 0.0 < duty < 1.0
    events: list[PressureEvent] = []
    t = period_s * (1.0 - duty)  # first squeeze after a calm lead-in
    while t < horizon_s:
        events.append(PressureEvent(t, int(low_frac * base_bytes)))
        recover = t + period_s * duty
        if recover < horizon_s:
            events.append(PressureEvent(recover, int(base_bytes)))
        t += period_s
    return events


def pressure_walk(*, horizon_s: float, base_bytes: int, step_s: float = 60.0,
                  low_frac: float = 0.4, seed: int = 0) -> list[PressureEvent]:
    """Seeded bounded random walk between ``low_frac`` and 1.0 of the base
    budget — gentler, churnier pressure than the square wave (memory
    ballooning of many small co-tenants rather than one big one)."""
    assert 0.0 < low_frac <= 1.0
    rng = random.Random(seed)
    frac = 1.0
    events: list[PressureEvent] = []
    t = step_s
    while t < horizon_s:
        frac = min(1.0, max(low_frac, frac + rng.uniform(-0.15, 0.15)))
        events.append(PressureEvent(t, int(frac * base_bytes)))
        t += step_s
    return events


# ------------------------------------------------------------------- chaos
@dataclass(frozen=True)
class FaultEvent:
    """At ``time`` (trace clock), engine ``engine_id`` suffers ``kind``
    ("crash" is the only kind today); with ``recover_after`` set it rejoins
    that many seconds later with cold tiers at the then-current pressure
    budget.  Consumed by ``FleetGateway.run_trace(faults=...)`` — the fleet
    mirror of ``ClusterSim.inject_failure`` (DESIGN.md §15)."""

    time: float
    engine_id: str
    kind: str = "crash"
    recover_after: float | None = None


def chaos_schedule(*, seed: int = 0, n_engines: int = 2,
                   crash_time: float = 20.0, recover_after: float = 15.0,
                   store_keys: Sequence[str] = (),
                   stall_s: float = 0.05) -> tuple[list, list[FaultEvent]]:
    """The canonical seeded fault schedule (fig17, `serve.py --chaos`):
    one store blob corruption + one transient store read error + one h2d
    chunk stall + one prefetch-worker death, plus one engine crash/recover.

    Returns ``(specs_per_engine, fault_events)`` where ``specs_per_engine``
    is a list of per-engine ``FaultSpec`` lists (build one ``FaultInjector``
    per engine from them — per-engine injectors keep the fleet ledger
    summable).  ``store_keys`` are the keys the plane's ``store.read``
    point fires with: tensor FINGERPRINTS for the real plane
    (`PersistentStore` keys reads by blob), model ids for the modeled plane
    (`ModeledEngine` keys by model) — key-pinned first-occurrence specs are
    thread-interleaving-proof, so the same schedule is deterministic on
    both planes.  Deterministic in `seed`: which engine crashes and which
    keys the store faults hit are seeded picks, the occurrence indices are
    fixed — replaying the same schedule fires the same faults.
    """
    from repro_torch.core.faults import FaultSpec

    rng = random.Random(seed)
    crash_engine = rng.randrange(n_engines)
    victims = list(store_keys)
    rng.shuffle(victims)
    specs: list[list] = [[] for _ in range(n_engines)]
    for i in range(n_engines):
        eng_specs = specs[i]
        # every engine sees one early h2d stall and one worker death; the
        # keyed store faults rotate across the seeded victim keys per engine
        eng_specs.append(FaultSpec("h2d.chunk", at=(3,), mode="stall",
                                   delay_s=stall_s))
        if victims:
            corrupt_victim = victims[i % len(victims)]
            eng_specs.append(FaultSpec("store.read", at=(0,), mode="corrupt",
                                       key=corrupt_victim))
        if len(victims) > 1:
            error_victim = victims[(i + 1) % len(victims)]
            eng_specs.append(FaultSpec("store.read", at=(0,), mode="error",
                                       key=error_victim))
        eng_specs.append(FaultSpec("prefetch.worker", at=(1,)))
    events = [FaultEvent(crash_time, f"engine{crash_engine}",
                         recover_after=recover_after)]
    return specs, events
