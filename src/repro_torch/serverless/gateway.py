"""Request gateway: admission, routing hooks, and TTFT-breakdown metrics
(port of `repro/serverless/gateway.py`).

The front door of the serverless control plane (DESIGN.md §13).  Two
consumers share one metrics vocabulary:

  * **sim plane** — ``run_serverless_sim`` runs a workload trace (plus an
    optional tenant-pressure schedule) through ``ClusterSim`` under a
    lifecycle policy and folds every ``RequestResult`` into a
    ``MetricsSink``, so benchmarks report cold-start rates and TTFT
    percentiles per policy instead of raw result lists;
  * **real plane** — ``Gateway`` replays a trace through a live ``Engine``:
    it expires idle models on the trace clock, classifies each request
    cold/warm, fires the prefetch hint for the next routed model, drives
    ``Engine.retain``/``release`` from the keep-alive policy, applies
    pressure events through ``Engine.set_host_capacity``, and records
    measured (wall-clock) phase breakdowns into the same sink.

TTFT accounting follows the paper's phase split: queue + init + load +
profile + prefill (decode is recorded but excluded from TTFT).

Two deliberate departures from the reference's real plane, both for the
card (ROADMAP queue 3):

  * **walls end when the device is done.**  CUDA work is asynchronous, so
    a host clock stopped right after the dispatch measures Python, not the
    card.  `prefill_s` stops when the first token's device event has
    completed and `decode_s` when the last token's has; the decode loop in
    between runs under ``torch.cuda.set_sync_debug_mode("error")``, so a
    host sync inside it raises instead of slowing it silently;
  * **evicted buffers are freed.**  The reference engine keeps a tensor's
    device buffer until `Engine.sync_evictions` drops it, and its gateways
    never call it: device memory then grows past the pool, a reload after
    an eviction counts the stale buffers as device hits while its
    `LoadReport` says they were transferred, and a prefetch hint skips the
    evicted tensors.  The port's `Engine` frees them itself (in `load`,
    `release` and `finish_instance`), so the gateways here call nothing
    extra.

The port also traces more: with a tracer on its engine, `Gateway.run_trace`
opens one ``request`` span a request on the engine's track and hands the
request's index in the sink (`rid`) to the engine's own spans
(`obs/device_clock.py`), and its records are `GatewayRecord`s, which carry
that `rid` and the request's `DataLoadStats`.
"""
from __future__ import annotations

import contextlib
import time as _time
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

# the ONE percentile convention (hoisted to core.trace so this module and
# core.cluster.summarize cannot drift apart); re-exported here because the
# serverless package is where metrics consumers historically import it from
from repro_torch.core.trace import percentile  # noqa: F401
from repro_torch.obs import NULL_TRACER, trace_request
from repro_torch.serverless.lifecycle import LifecycleManager, make_keep_alive
from repro_torch.serverless.workload import PressureEvent


@dataclass(frozen=True)
class TTFTRecord:
    """One admitted request's phase breakdown (seconds)."""

    model_id: str
    arrival: float
    cold: bool  # no live/warm instance served it: the start was paid
    queue_s: float = 0.0
    init_s: float = 0.0
    load_s: float = 0.0  # includes merge/compaction on the sim plane
    profile_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    joined: bool = False
    prefetched: bool = False
    bytes_from_store: int = 0

    @property
    def ttft(self) -> float:
        return (self.queue_s + self.init_s + self.load_s + self.profile_s
                + self.prefill_s)


@dataclass(frozen=True)
class GatewayRecord(TTFTRecord):
    """A real-plane request's `TTFTRecord` with its index in the sink
    (`rid`, the ``rid`` of its spans) and its load's `DataLoadStats`, which
    the phase walls are cut from (port-only: the sim plane's records stay
    the reference's `TTFTRecord`, field for field)."""

    rid: Optional[int] = None
    load_stats: Any = None


class MetricsSink:
    """Append-only per-request metrics with percentile summaries, plus the
    chaos plane's fault-event stream (DESIGN.md §15)."""

    def __init__(self):
        self.records: list[TTFTRecord] = []
        # (time, kind, engine_id) — crash/recover events the gateway applied
        self.fault_events: list[tuple[float, str, str]] = []

    def add(self, rec: TTFTRecord):
        self.records.append(rec)

    def record_fault(self, time: float, kind: str, engine_id: str):
        """Ledger one fleet fault/recovery event (visible in `summary`)."""
        self.fault_events.append((round(time, 6), kind, engine_id))

    def add_sim(self, res):
        """Fold one cluster-sim ``RequestResult`` (duck-typed: any object
        with the RequestResult fields) into the sink."""
        self.add(TTFTRecord(
            model_id=res.model_id, arrival=res.arrival, cold=not res.warm,
            queue_s=res.queue_s, init_s=res.init_s, load_s=res.load_phase,
            profile_s=res.profile_s, prefill_s=res.prefill_s,
            decode_s=res.decode_s, joined=res.joined,
            prefetched=res.prefetched,
            bytes_from_store=res.bytes_from_store))

    def summary(self) -> dict[str, float]:
        n = len(self.records)
        if n == 0:
            return {"n": 0, "fault_events": len(self.fault_events)}
        ttfts = [r.ttft for r in self.records]
        cold = [r.ttft for r in self.records if r.cold]
        out = {
            "n": n,
            "cold_starts": len(cold),
            "cold_start_rate": len(cold) / n,
            "ttft_p50": percentile(ttfts, 0.50),
            "ttft_p95": percentile(ttfts, 0.95),
            "ttft_p99": percentile(ttfts, 0.99),
            "queue_mean": sum(r.queue_s for r in self.records) / n,
            "load_mean": sum(r.load_s for r in self.records) / n,
            "bytes_from_store": sum(r.bytes_from_store for r in self.records),
            "fault_events": len(self.fault_events),
        }
        for q in (0.50, 0.95, 0.99):
            out[f"cold_ttft_p{int(q * 100)}"] = percentile(cold, q)
        return out


# -------------------------------------------------------------- sim plane
def run_serverless_sim(models, trace, policy, *, n_workers: int = 2,
                       seed: int = 0,
                       pressure: Sequence[PressureEvent] = (),
                       pool_bytes: Optional[int] = None):
    """Run a trace through the cluster sim under a serverless policy and
    return ``(sim, sink)``.  The lifecycle manager, pressure schedule, and
    affinity scheduler are all engaged by the sim itself
    (``SimPolicy.lifecycle``); this wrapper is the gateway's admission +
    metrics layer."""
    from repro_torch.core.cluster import ClusterSim  # lazy: no import cycle

    sim = ClusterSim(models, policy, n_workers=n_workers, seed=seed,
                     pool_bytes=pool_bytes)
    results = sim.run(trace, pressure=pressure)
    sink = MetricsSink()
    for r in results:
        sink.add_sim(r)
    return sim, sink


# ------------------------------------------------------------- real plane
def make_prefill_batch(engine, model_id: str, prompt_len: int, seed: int):
    """Synthesize one prompt batch for a registered model (shared by the
    single-engine Gateway and the fleet gateway's real-plane serve path):
    drawn from a CPU `torch.Generator` seeded with `seed`, so the same seed
    gives the same tokens on every device, and placed on the engine's
    device."""
    import dataclasses

    from repro_torch.configs import SHAPES
    from repro_torch.models import build_model

    cfg = engine.models[model_id].cfg
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=prompt_len,
                                global_batch=1, kind="prefill")
    return build_model(cfg).make_batch(torch.Generator().manual_seed(seed),
                                       shape, device=engine.device)


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Next tokens from logits, on their device (no host read)."""
    return torch.argmax(logits, -1).to(torch.int32)


def settle(t: torch.Tensor) -> torch.Tensor:
    """Block until the device has computed `t` (a no-op on the CPU): the
    point where a token exists for the caller, and where a phase wall may
    stop."""
    if t.device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        done.synchronize()
    return t


@contextlib.contextmanager
def sync_free(device: torch.device):
    """Raise on any host sync inside the block (CUDA only): the decode loop
    between the first and the last token must never wait on the card."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def generate(inst, batch, gen_tokens: int) -> tuple[float, float]:
    """Prefill `batch` on `inst`, then decode `gen_tokens` greedy tokens.
    Returns the prefill and decode walls: the first ends when the first
    token is on hand, the second when the last one is, and the decode loop
    between them is sync-free."""
    t1 = _time.perf_counter()
    tok = settle(greedy(inst.prefill(batch)))
    prefill_s = _time.perf_counter() - t1
    t2 = _time.perf_counter()
    with sync_free(tok.device):
        for _ in range(gen_tokens):
            tok = greedy(inst.decode(tok))
    settle(tok)
    return prefill_s, _time.perf_counter() - t2


class Gateway:
    """Trace replay against a live ``Engine`` under a keep-alive policy.

    The trace clock is VIRTUAL (keep-alive and pressure decisions replay
    deterministically from request timestamps) while phase durations are
    MEASURED wall time — the same split the cost plane makes between
    decisions and prices.  Single-engine: routing is trivial, but the hint
    path is the real one (the next routed model prefetches while the
    current request runs)."""

    def __init__(self, engine, *, keep_alive: str = "fixed:60",
                 prefetch: bool = True, prompt_len: int = 16,
                 gen_tokens: int = 4, num_pages: int = 64, tracer=None):
        self.engine = engine
        # obs plane (DESIGN.md §18): per-request span families keyed by the
        # trace clock; the engine's own spans ride its injected tracer
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.lifecycle = LifecycleManager(make_keep_alive(keep_alive))
        self.prefetch = prefetch
        self.prompt_len = prompt_len
        self.gen_tokens = gen_tokens
        self.num_pages = num_pages
        self.sink = MetricsSink()
        self._warm: dict[str, float] = {}  # model_id -> warm-until (trace s)
        # virtual single-server queue on the trace clock: arrivals that land
        # while a previous request's MEASURED service is still in flight (on
        # that clock) wait, and the wait is reported as the paper's Queue
        # phase — previously dropped entirely on the real plane
        self._busy_until = 0.0

    def _expire(self, now: float):
        for model, until in sorted(self._warm.items(), key=lambda kv: kv[1]):
            if until <= now:
                del self._warm[model]
                # withdraw any in-flight hint FIRST: an expired model's
                # prefetch would otherwise keep its host pin and its
                # store-bandwidth slot, so TTL lapses never actually freed
                # host bytes under tenant pressure
                self.engine.cancel_prefetch(model)
                self.engine.release(model)  # pins drop: spillable again
                self.lifecycle.on_expire(model, until)

    def _admit(self, model: str, now: float) -> bool:
        """Admission bookkeeping for one arrival: feed the gap histogram,
        classify cold/warm, and take the model LIVE (its warm-until entry is
        POPPED — see `_finish_request`).  Returns True when the start is
        cold."""
        self.lifecycle.observe_arrival(model, now)
        cold = model not in self._warm
        self.lifecycle.on_start(model, now, warm=not cold)
        self._warm.pop(model, None)  # LIVE while serving
        return cold

    def _finish_request(self, model: str, now: float):
        """Post-serve keep-alive bookkeeping: ask the policy for a fresh TTL
        and retain (WARM) or scale to zero.  The warm entry was popped at
        admission, so a STALE warm-until from the previous idle period can
        never truncate the newly chosen TTL — the real-plane analogue of the
        sim's ``WorkerInstance.idle_epoch`` guard, pinned by
        tests/test_fleet.py."""
        ttl = self.lifecycle.on_idle(model, now)
        if ttl > 0:
            self.engine.retain(model)  # stays pinned + active (WARM)
            self._warm[model] = now + ttl
        else:
            self.lifecycle.on_expire(model, now)  # scale-to-zero

    def _prefill_batch(self, model_id: str, seed: int):
        return make_prefill_batch(self.engine, model_id, self.prompt_len, seed)

    def run_trace(self, trace, *,
                  pressure: Sequence[PressureEvent] = ()) -> MetricsSink:
        press = sorted(pressure, key=lambda p: p.time)
        pi = 0
        # next routed DIFFERENT model per position, one backward pass (the
        # per-request tail rescan would make replay quadratic)
        next_model: list[Optional[str]] = [None] * len(trace)
        for j in range(len(trace) - 2, -1, -1):
            nxt = trace[j + 1].model_id
            next_model[j] = (nxt if nxt != trace[j].model_id
                             else next_model[j + 1])
        eng = self.engine
        for i, req in enumerate(trace):
            # port-only: one ``request`` span a request on the engine's track
            # and host clock, parent of the engine's spans of its `rid`
            tb = _time.perf_counter() if eng.tracer.enabled else 0.0
            rid = len(self.sink.records)
            now = req.time
            while pi < len(press) and press[pi].time <= now:
                # trace-clock order like the sim's event heap: keep-alives
                # that lapsed BEFORE this squeeze must release their pins
                # first, or the shrink wrongly evicts around them
                self._expire(press[pi].time)
                self.engine.set_host_capacity(press[pi].capacity_bytes)
                pi += 1
            self._expire(now)
            model = req.model_id
            cold = self._admit(model, now)
            # admission defers when the engine is still serving on the trace
            # clock: the wait is the Queue phase of the paper's TTFT split
            queue_s = max(0.0, self._busy_until - now)

            t0 = _time.perf_counter()
            rep = self.engine.load(model, now=now, rid=rid)
            load_s = _time.perf_counter() - t0
            stats = self.engine.last_load
            # keep the phase split disjoint (one vocabulary with the sim
            # plane): the measured load wall contains the first-ever
            # init_fn materialization (init_s) and the param-tree assembly
            # (profile_s), which TTFTRecord reports as their own phases
            load_s = max(0.0, load_s - stats.init_seconds
                         - stats.profile_seconds)
            if self.prefetch and next_model[i] is not None:
                # routing decided the next placement: hint it now so its
                # store read overlaps this request's prefill/decode
                self.engine.prefetch(next_model[i])
            inst = self.engine.start_instance(model, num_pages=self.num_pages, rid=rid)
            batch = self._prefill_batch(model, i)
            prefill_s, decode_s = generate(inst, batch, self.gen_tokens)
            inst.finish()
            # measured service wall occupies the virtual server on the
            # trace clock (decode included: the instance holds its slot
            # until the last token)
            service_s = _time.perf_counter() - t0
            self._busy_until = now + queue_s + service_s

            self._finish_request(model, now)
            rec = GatewayRecord(
                model_id=model, arrival=now, cold=cold, queue_s=queue_s,
                init_s=stats.init_seconds, load_s=load_s,
                profile_s=stats.profile_seconds,
                prefill_s=prefill_s, decode_s=decode_s,
                prefetched=stats.bytes_prefetched > 0,
                bytes_from_store=stats.bytes_store, rid=rid, load_stats=stats)
            self.sink.add(rec)
            if eng.tracer.enabled:
                eng.tracer.emit("request", tb, _time.perf_counter(),
                                track=f"eng:{eng.engine_id}", cat="request",
                                args={"rid": rid, "model": model, "cold": cold})
            if self.tracer.enabled:
                # span-accounting identity (DESIGN.md §18): parent span is
                # the REPORTED ttft, children the measured phase walls laid
                # on the trace clock; the engine's cost plane supplies the
                # load prediction for the span/cost cross-check
                trace_request(
                    self.tracer, rid=rid,
                    model_id=model, arrival=now, ttft=rec.ttft,
                    phases=[("queue", rec.queue_s), ("init", rec.init_s),
                            ("load", rec.load_s),
                            ("profile", rec.profile_s),
                            ("prefill", rec.prefill_s)],
                    decode_s=rec.decode_s, cold=cold,
                    engine=self.engine.engine_id,
                    preds={"load": rep.load_seconds})
        return self.sink
