"""Multi-engine fleet gateway with predictive pre-warm (DESIGN.md §14), port
of `repro/serverless/fleet.py`.

The real-plane ``Gateway`` replays traces against exactly one engine, so
the affinity score — the paper's headline mechanism — would only be
exercised inside the cluster simulator.  This module is the control plane
above N engines:

  * **Routing** — every arrival is placed by the SAME ``affinity_schedule``
    code path the cluster sim runs (``core.scheduler``, eq3+queue by
    default): device-resident bytes beat host-resident bytes beat store
    promotions (Eq. 3 tiered), discounted by the per-engine expected queue
    delay.  The fleet cannot drift from the sim because there is one
    scoring function, consumed through the same ``DeviceView`` protocol
    (``EngineNode`` adapts an engine to it).
  * **Lifecycle** — one ``LifecycleManager`` arbitrates cold/warm/live for
    the whole fleet; ``retain``/``release`` and prefetch hints are driven
    per engine, and tenant-pressure events resize every engine's host tier
    (``set_host_capacity``), exactly like the sim's pressure feed.
  * **Predictive pre-warm** — the adaptive keep-alive histogram already
    models per-model inter-arrival gaps, so when a model scales to zero the
    fleet asks ``LifecycleManager.predict_next_arrival`` for (eta, prob)
    and arms a timer at ``eta - lead``.  When it fires, the model is routed
    (same affinity score), and promoted/loaded AHEAD of the arrival iff the
    cost/benefit check passes: expected cold-load seconds saved x arrival
    probability vs. the store-bandwidth slot and displaced host bytes taken
    from co-tenants (``PhaseCosts.prewarm_net_benefit``).  A reactive-only
    fleet (``prewarm=False``) still prefetches on placement but always eats
    the cold start — the ablation benchmarks/fig16_serverless.py sweeps.

Two engine flavours implement one protocol (engine_id, records_of, load,
prefetch/cancel_prefetch, retain/release, prewarm, host_resident_bytes,
host_free_bytes, set_host_capacity):

  * ``serving.engine.Engine`` — the real torch data plane (measured walls),
    driven from ``launch/serve.py --n-engines``;
  * ``ModeledEngine`` (here) — tensor-free: a ``ReuseStore`` +
    ``SimHostCache`` + ``PhaseCosts`` node whose durations are modeled
    seconds, so fleet benchmarks and golden tests are deterministic and
    machine-independent.

The trace clock is virtual in both cases; the real plane measures phase
walls (the Gateway's split, with its walls ending on the device — see
`serverless.gateway`), the modeled plane prices them.  Everything but the real plane's serve seam (`FleetGateway._serve`)
is the reference's code.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
import time as _time
from typing import Optional, Sequence

from repro_torch.core.costmodel import Hardware, PhaseCosts, paper_l40, unique_bytes
from repro_torch.core.engine_api import LoadRequest, submit_load
from repro_torch.core.faults import FaultInjector
from repro_torch.core.hostcache import SimHostCache
from repro_torch.core.reuse_store import LoadReport, ReuseStore
from repro_torch.core.scheduler import ScheduleEntry, affinity_schedule
from repro_torch.core.trace import (Request, SimModel, synthetic_tensor_sizes,
                                    synthetic_variant_records)
from repro_torch.models.tensors import ModelSpec, TensorRecord, VariantSpec
from repro_torch.obs import NULL_TRACER, BoundedLog, trace_request
from repro_torch.stats import FleetStats, ModeledFaultStats
from repro_torch.serverless.gateway import (MetricsSink, TTFTRecord, generate,
                                            make_prefill_batch)
from repro_torch.serverless.lifecycle import LifecycleManager, make_keep_alive
from repro_torch.serverless.workload import FaultEvent, PressureEvent


class ModeledEngine:
    """A tensor-free engine-protocol node for the modeled fleet plane.

    Exactly the state one real ``Engine`` owns — a device ``ReuseStore``
    over its own pool and a bounded ``SimHostCache`` host tier with the
    persistent store below — minus the data plane: loads resolve through
    ``ReuseStore.load_model`` (which consumes prefetch hints and prices
    tier-aware, overlap-aware Eq. 3), and durations are modeled seconds.
    """

    def __init__(self, engine_id: str, capacity_bytes: int, *,
                 costs: Optional[PhaseCosts] = None,
                 host_cache_bytes: Optional[int] = None,
                 host_keep_alive_s: Optional[float] = None,
                 hint_ttl_s: Optional[float] = None,
                 faults: Optional[FaultInjector] = None,
                 tracer=None):
        self.engine_id = engine_id
        # obs plane (DESIGN.md §18): modeled spans carry explicit virtual
        # trace-clock stamps — this engine never reads a wall clock
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.store = ReuseStore(capacity_bytes,
                                costs or PhaseCosts(paper_l40()))
        self.store.host_cache = SimHostCache(host_cache_bytes,
                                             keep_alive_s=host_keep_alive_s,
                                             hint_ttl_s=hint_ttl_s)
        self.models: dict[str, list[TensorRecord]] = {}
        self.last_report: Optional[LoadReport] = None
        # chaos plane (DESIGN.md §15): same injector protocol as the real
        # engine, consulted at the modeled store-read point; per-engine
        # injector (NOT shared) so the fleet ledger sums cleanly
        self.faults = faults
        self.store_retries = 0  # modeled transient-read retries priced in
        self.crashes = 0

    # ------------------------------------------------------ engine protocol
    def register(self, model: ModelSpec | str,
                 records: Sequence[TensorRecord]):
        """Register a model under a `ModelSpec` identity (a bare id means
        identity policy) — the records are pre-fingerprinted on this plane,
        so the spec's role here is the store's sharer/dedup registry."""
        spec = self.store.register_model(model)
        self.models[spec.model_id] = list(records)

    def records_of(self, model_id: str) -> list[TensorRecord]:
        return self.models[model_id]

    def load(self, model_id: str, *, now: float = 0.0,
             overlap_s: float = 0.0) -> LoadReport:
        rep = self.store.load_model(model_id, self.models[model_id],
                                    now=now, overlap_s=overlap_s)
        if self.faults is not None and rep.bytes_from_store > 0:
            # modeled plane's ``store.read`` point: a transient failure adds
            # the re-read + backoff penalty the real plane would measure
            spec = self.faults.fire("store.read", key=model_id)
            if spec is not None:
                self.store_retries += 1
                rep.load_seconds += self.store.costs.store_retry_time(
                    rep.bytes_from_store)
                if self.tracer.enabled:
                    self.tracer.instant("store.retry", now,
                                        track=f"eng:{self.engine_id}",
                                        cat="fault",
                                        args={"model": model_id})
        self.last_report = rep
        return rep

    # -------------------------------------------------------- chaos plane
    def crash(self):
        """Modeled engine crash, mirroring both `Engine.crash` and the
        sim's fail handler: fresh device pool + fresh host tier at the
        CURRENT capacity budget; durable (modeled) store state is implicit
        — the next load of anything simply prices as fully cold."""
        self.crashes += 1
        cache = self.store.host_cache
        costs = self.store.costs
        self.store = ReuseStore(self.store.pool.capacity, costs)
        self.store.host_cache = SimHostCache(cache.capacity_bytes,
                                             keep_alive_s=cache.keep_alive_s,
                                             hint_ttl_s=cache.hint_ttl_s)
        self.last_report = None

    def fault_summary(self) -> dict:
        # typed snapshot (DESIGN.md §18): field order = legacy key order
        return ModeledFaultStats(
            injected=(self.faults.ledger() if self.faults is not None
                      else {}),
            store_retries=self.store_retries,
            crashes=self.crashes,
        ).as_dict()

    def prefetch(self, model_id: str, *, now: float = 0.0):
        self.store.hint_prefetch(model_id, self.models[model_id], now)

    def cancel_prefetch(self, model_id: str):
        self.store.host_cache.cancel_prefetch(model_id)

    def retain(self, model_id: str):
        self.store.activate(model_id)

    def release(self, model_id: str):
        self.store.release(model_id)

    def prewarm(self, model_id: str, *, now: float = 0.0) -> LoadReport:
        """Load ahead of the predicted arrival and retain (WARM)."""
        rep = self.load(model_id, now=now)
        self.retain(model_id)
        return rep

    def set_host_capacity(self, capacity_bytes: Optional[int]) -> int:
        return self.store.set_host_capacity(capacity_bytes)

    def host_resident_bytes(self, records: Sequence[TensorRecord]) -> int:
        """Mirror of `SimWorker.host_resident_bytes` / the real engine's:
        host-tier bytes among the DEVICE pool's misses only."""
        misses = [r for r in records
                  if r.fingerprint not in self.store.tensor_map]
        return self.store.host_cache.host_resident_bytes(misses)

    def host_free_bytes(self) -> Optional[int]:
        cache = self.store.host_cache
        if cache.capacity_bytes is None:
            return None
        return max(0, cache.capacity_bytes - cache.nbytes())


class EngineNode:
    """``DeviceView`` adapter: what ``affinity_schedule`` may ask about one
    engine (real or modeled), plus the fleet's per-engine control state —
    a virtual busy-until horizon (the queueing term of eq3+queue) and the
    warm-until map the keep-alive policy maintains."""

    def __init__(self, engine, *, prefetch: bool = True):
        self.engine = engine
        self.device_id: str = engine.engine_id
        self.prefetch_enabled = prefetch
        self.allow_hint = True  # scoring-only routing passes clear this
        self.failed = False  # crashed (chaos plane): invisible to routing
        self.score_dead = False  # shadow pass: score the node as if alive
        self.busy_until = 0.0  # trace-clock horizon of queued service
        self.warm: dict[str, float] = {}  # model_id -> warm-until (trace s)
        self.prewarmed: dict[str, float] = {}  # model_id -> predicted eta
        self.fleet = None  # back-ref for migration offers (set by the fleet)
        # what the busy horizon is made of: one entry per in-flight request
        # ({t_end, model, kv_bytes, model_bytes}), so a crash can count the
        # work it interrupted and a migration offer can price the blocking
        # decode (DESIGN.md §16).  kv_bytes == 0 marks "unpriceable" (real
        # plane): still ledgered, never offered.
        self.inflight: list[dict] = []

    # ---------------------------------------------------------- DeviceView
    def can_run(self, model_bytes: int,
                model_id: Optional[str] = None) -> bool:
        if self.failed and not self.score_dead:
            return False  # a crashed engine takes no placements
        return model_bytes <= self.engine.store.pool.capacity

    def reusable_bytes(self, records: Sequence[TensorRecord]) -> int:
        return self.engine.store.reusable_bytes(records)

    def host_resident_bytes(self, records: Sequence[TensorRecord]) -> int:
        return self.engine.host_resident_bytes(records)

    def expected_queue_delay(self, now: float) -> float:
        return max(0.0, self.busy_until - now)

    def migration_offer(self, now: float) -> Optional[float]:
        """DeviceView (optional, DESIGN.md §16): seconds until this node
        frees up if its blocking decode hands off elsewhere — the
        source-side snapshot stall — or None when nothing is migratable.
        Side-effect-free: the scheduler probes it on scoring-only and
        shadow passes whose entries are never executed."""
        if self.fleet is None:
            return None
        return self.fleet._migration_offer(self, now)

    def hint_prefetch(self, model_id: str, records: Sequence[TensorRecord],
                      now: float):
        if self.prefetch_enabled and self.allow_hint:
            self.engine.prefetch(model_id, now=now)


class FleetGateway:
    """Trace replay against N engines: shared-score routing, per-engine
    lifecycle/pressure, and predictive pre-warm.

    The default serve path drives real ``Engine``s (measured phase walls on
    a virtual trace clock, like the single-engine ``Gateway``);
    ``ModeledFleetGateway`` overrides `_serve` with the deterministic cost
    plane.  ``decisions`` records the replay-exact (time, model, engine,
    cold, queue) routing sequence the golden tests pin.
    """

    def __init__(self, engines: Sequence, *, keep_alive="adaptive",
                 hw: Optional[Hardware] = None, prefetch: bool = True,
                 prewarm: bool = True, prewarm_min_benefit: float = 0.0,
                 policy: str = "eq3+queue", prompt_len: int = 16,
                 gen_tokens: int = 4, num_pages: int = 64,
                 migrate: bool = False, migrate_replay_tokens: int = 4,
                 tracer=None):
        assert len(engines) >= 1
        # obs plane (DESIGN.md §18): per-request span families on the
        # virtual trace clock + fault/migration instants; `_last_preds` is
        # the serve seam's side channel carrying each phase's cost-model
        # prediction into the request's spans (the span/cost cross-check)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._last_preds: Optional[dict] = None
        self.nodes = [EngineNode(e, prefetch=prefetch) for e in engines]
        ids = [n.device_id for n in self.nodes]
        assert len(set(ids)) == len(ids), f"duplicate engine ids: {ids}"
        for n in self.nodes:
            n.fleet = self
        self.costs: PhaseCosts = engines[0].store.costs
        self.hw = hw or self.costs.hw
        self.lifecycle = LifecycleManager(make_keep_alive(keep_alive))
        self.prefetch = prefetch
        self.prewarm_enabled = prewarm
        self.prewarm_min_benefit = prewarm_min_benefit
        self.policy = policy
        self.prompt_len = prompt_len
        self.gen_tokens = gen_tokens
        self.num_pages = num_pages
        self.sink = MetricsSink()
        # replay-exact routing log: (time, model, engine, cold, queue_s)
        self.decisions: list[tuple[float, str, str, bool, float]] = []
        # pre-warm decision log: (event, time, model, engine, detail)
        self.log: list[tuple[str, float, str, str, float]] = []
        self.prewarms = 0  # speculative loads issued
        self.prewarm_hits = 0  # predicted arrival landed inside the window
        self.prewarm_wasted = 0  # window lapsed unused (release + charge)
        self._timers: list[tuple[float, int, str, float, float]] = []
        self._armed: dict[str, float] = {}  # model -> predicted eta
        # chaos plane (DESIGN.md §15): scheduled crash/recover events merged
        # into `_advance`'s trace-clock ordering like pressure and timers
        self._fault_events: list[tuple[float, int, str, str]] = []
        self.engine_crashes = 0
        self.engine_recoveries = 0
        self.requests_redriven = 0  # arrivals a live crash re-routed
        self.requests_interrupted = 0  # in-flight work a crash cut short
        self._arrivals = 0  # total requests offered (drop accounting)
        # live KV migration (DESIGN.md §16): decode handoffs between nodes
        self.migrate_enabled = migrate
        self.migrate_replay_tokens = migrate_replay_tokens
        self.migrations = 0
        # handoff log: (time, model, src, dst, stall_s, moved_done) —
        # bounded ring with counted drops (DESIGN.md §18)
        self.migrate_log: BoundedLog = BoundedLog(4096)
        self._seq = itertools.count()
        self._req_seq = itertools.count()  # prefill batch seeds (real plane)

    # ------------------------------------------------------------- helpers
    def _records(self, model_id: str) -> list[TensorRecord]:
        return self.nodes[0].engine.records_of(model_id)

    def _bytes(self, model_id: str) -> int:
        # deduped footprint (DESIGN.md §17): each fingerprint counted once —
        # identical to sum(nbytes) whenever no fingerprint repeats
        return unique_bytes(self._records(model_id))

    def _find_warm(self, model_id: str) -> Optional[EngineNode]:
        for n in self.nodes:
            if model_id in n.warm:
                return n
        return None

    def _route(self, model_id: str, now: float, *, hint: bool,
               score_dead: bool = False) -> tuple[ScheduleEntry, EngineNode]:
        """Place one model by the sim's affinity score — literally the same
        ``affinity_schedule`` call the cluster sim makes, over DeviceView
        nodes.  `hint=False` runs a scoring-only pass (pre-warm cost checks
        must not leave a prefetch hint behind when they decline).
        `score_dead=True` is the failover shadow pass: crashed nodes score
        as if alive (hints required off), so the gateway can tell which
        arrivals a crash actually re-routed (``requests_redriven``)."""
        assert not (score_dead and hint), "shadow pass must not hint"
        records = self._records(model_id)
        for n in self.nodes:
            n.allow_hint = hint
            n.score_dead = score_dead
        try:
            scheds, queued = affinity_schedule(
                [(model_id, records, self._bytes(model_id))], self.nodes,
                self.hw, policy=self.policy, now=now)
        finally:
            for n in self.nodes:
                n.allow_hint = True
                n.score_dead = False
        if not scheds:
            raise RuntimeError(f"no engine can run {model_id} "
                               f"({self._bytes(model_id)} B)")
        entry = scheds[0]
        node = next(n for n in self.nodes if n.device_id == entry.device_id)
        return entry, node

    def _device_free_for(self, node: EngineNode, model_id: str) -> float:
        """Device-pool bytes not pinned by OTHER active (warm/live) models —
        what a load of `model_id` can claim on this node, since inactive
        residents are evictable but retained co-tenants are not."""
        store = node.engine.store
        active = sum(store.resident_bytes(m) for m in store.active_models
                     if m != model_id)
        return store.pool.capacity - active

    def _make_room(self, node: EngineNode, model_id: str, now: float):
        """Scale down warm instances (soonest-to-expire first) until the
        cold load fits beside the node's remaining pins — a real arrival
        outranks keep-alive squatters, warm or pre-warmed.  Evicted models
        go through the same expiry path (withdraw hint, release, notify or
        charge the speculation) so the decision log stays replay-exact."""
        mbytes = self._bytes(model_id)
        while (self._device_free_for(node, model_id) < mbytes
               and node.warm):
            victim, until = min(node.warm.items(), key=lambda kv: kv[1])
            del node.warm[victim]
            node.engine.cancel_prefetch(victim)
            node.engine.release(victim)
            eta = node.prewarmed.pop(victim, None)
            if eta is not None:
                self.prewarm_wasted += 1
                self.log.append(("prewarm-evicted", round(now, 6), victim,
                                 node.device_id, round(eta, 6)))
            else:
                self.lifecycle.on_expire(victim, now)
                self._arm_prewarm(victim, now)

    # ------------------------------------------------- live KV migration §16
    def _migration_meta(self, req: Request) -> Optional[dict]:
        """KV/weight bytes of this request's decode, for handoff pricing.
        The real plane cannot know them ahead of serving (None: its
        inflight entries still count toward crash interruption but never
        price an offer); the modeled plane derives them from the SimModel."""
        return None

    def _blocking_entry(self, node: EngineNode) -> Optional[dict]:
        """The in-flight request whose completion IS the node's busy
        horizon — the decode an arrival here would actually queue behind."""
        for e in reversed(node.inflight):
            if e["t_end"] == node.busy_until:
                return e
        return None

    def _migration_offer(self, node: EngineNode,
                         now: float) -> Optional[float]:
        """Price a decode handoff off `node` (DESIGN.md §16): offered only
        when the full migration (snapshot d2h + host-path ship + restore
        h2d + <=K-token replay) beats waiting out the blocking decode AND a
        live peer exists to absorb it.  Returns the source-side snapshot
        stall — what an arrival actually queues behind — or None."""
        if not self.migrate_enabled or node.failed:
            return None
        rem = node.busy_until - now
        if rem <= 0.0:
            return None
        entry = self._blocking_entry(node)
        if entry is None or entry["kv_bytes"] <= 0.0:
            return None
        full = self.costs.migrate_time(
            entry["kv_bytes"], entry["model_bytes"],
            replay_tokens=self.migrate_replay_tokens)
        if full >= rem:
            return None  # the decode finishes before the handoff would
        if not any(n is not node and not n.failed for n in self.nodes):
            return None  # nowhere to hand off
        return self.costs.migrate_stall(entry["kv_bytes"])

    def _do_migrate(self, node: EngineNode, now: float):
        """Execute the handoff the router priced: the blocking decode
        snapshots (the source stalls only for the d2h), ships through the
        host path, and finishes on the least-loaded live peer — whose busy
        horizon absorbs the transfer, replay, and remaining decode."""
        entry = self._blocking_entry(node)
        if entry is None:
            return
        rem = node.busy_until - now
        kv = entry["kv_bytes"]
        stall = self.costs.migrate_stall(kv)
        full = self.costs.migrate_time(
            kv, entry["model_bytes"],
            replay_tokens=self.migrate_replay_tokens)
        target = min((n for n in self.nodes
                      if n is not node and not n.failed),
                     key=lambda n: (n.busy_until, n.device_id))
        node.inflight.remove(entry)
        node.busy_until = max(
            now + stall, max((e["t_end"] for e in node.inflight),
                             default=0.0))
        moved_done = max(target.busy_until, now + full) \
            + max(0.0, rem - stall)
        target.busy_until = max(target.busy_until, moved_done)
        target.inflight.append({**entry, "t_end": moved_done})
        self.migrations += 1
        self.migrate_log.append((round(now, 6), entry["model"],
                                 node.device_id, target.device_id,
                                 round(stall, 6), round(moved_done, 6)))
        if self.tracer.enabled:
            self.tracer.instant("migrate", now, track="fleet",
                                args={"model": entry["model"],
                                      "src": node.device_id,
                                      "dst": target.device_id})

    # ------------------------------------------------------------ lifecycle
    def _expire_all(self, now: float):
        """Release keep-alive lapses (trace order) on every node: withdraw
        the in-flight hint FIRST (its pin would otherwise survive the
        expiry), then drop pins and notify the lifecycle.  A lapsed
        pre-warm window counts as wasted speculation and is NOT re-armed —
        only a real arrival refreshes the prediction, so a dead model
        cannot pre-warm itself in a loop."""
        for node in self.nodes:
            for model, until in sorted(node.warm.items(),
                                       key=lambda kv: kv[1]):
                if until > now:
                    continue
                del node.warm[model]
                node.engine.cancel_prefetch(model)
                node.engine.release(model)
                eta = node.prewarmed.pop(model, None)
                if eta is not None:
                    self.prewarm_wasted += 1
                    self.log.append(("prewarm-wasted", round(until, 6),
                                     model, node.device_id, round(eta, 6)))
                else:
                    self.lifecycle.on_expire(model, until)
                    self._arm_prewarm(model, until)

    def _arm_prewarm(self, model: str, now: float):
        """The model just went cold: if the policy can predict its next
        arrival, schedule a pre-warm check at eta minus the worst-case lead
        (full store promotion + init) so a positive decision finishes
        loading BEFORE the arrival lands."""
        if not self.prewarm_enabled or model in self._armed:
            return
        pred = self.lifecycle.predict_next_arrival(model, now)
        if pred is None:
            return
        eta, prob = pred
        if eta <= now:
            return  # the predicted arrival is already overdue
        mbytes = self._bytes(model)
        lead = (self.costs.load_time(mbytes, in_host_cache=False)
                + self.costs.init_time(mbytes))
        fire = max(now, eta - lead)
        self._armed[model] = eta
        heapq.heappush(self._timers, (fire, next(self._seq), model, eta,
                                      prob))

    def _fire_prewarm(self, now: float, model: str, eta: float, prob: float):
        armed = self._armed.pop(model, None)
        if armed is None or armed != eta:
            return  # an arrival (or a newer prediction) superseded the timer
        if self._find_warm(model) is not None:
            return
        entry, node = self._route(model, now, hint=False)
        records = self._records(model)
        mbytes = self._bytes(model)
        if self._device_free_for(node, model) < mbytes:
            # speculation never evicts certain warm hits to make room
            self.log.append(("prewarm-nofit", round(now, 6), model,
                             node.device_id, 0.0))
            return
        missing = max(0, mbytes - node.reusable_bytes(records))
        host = min(node.host_resident_bytes(records), missing)
        store_b = missing - host
        free = node.engine.host_free_bytes()
        displaced = 0 if free is None else max(0, store_b - free)
        # what a cold arrival would pay here (load score minus the queueing
        # term — pre-warm cannot save queueing) plus the Init phase
        saved = (max(0.0, entry.expected_load_seconds
                     - node.expected_queue_delay(now))
                 + self.costs.init_time(mbytes))
        net = self.costs.prewarm_net_benefit(saved, prob, store_b, displaced)
        self.log.append(("prewarm-check", round(now, 6), model,
                         node.device_id, round(net, 6)))
        if net <= self.prewarm_min_benefit:
            return
        node.engine.prewarm(model, now=now)
        ttl = max(1.0, self.lifecycle.policy.ttl(model))
        node.warm[model] = eta + ttl  # hold through the arrival's jitter
        node.prewarmed[model] = eta
        self.prewarms += 1
        self.log.append(("prewarm", round(now, 6), model, node.device_id,
                         round(eta, 6)))

    # ---------------------------------------------------------- chaos plane
    def inject_failure(self, time: float, engine_id: str, *,
                       recover_after: Optional[float] = None):
        """Schedule an engine crash at `time` (trace clock) — the fleet
        mirror of ``ClusterSim.inject_failure``.  The crashed engine's
        arrivals re-route through `affinity_schedule` to survivors, its
        lifecycle instances are expired consistently, and (with
        `recover_after`) it rejoins with cold tiers at the CURRENT pressure
        budget.  Call before `run_trace`; events interleave with pressure
        and pre-warm timers in trace-clock order."""
        assert any(n.device_id == engine_id for n in self.nodes), engine_id
        heapq.heappush(self._fault_events,
                       (time, next(self._seq), "crash", engine_id))
        if recover_after is not None:
            heapq.heappush(self._fault_events,
                           (time + recover_after, next(self._seq),
                            "recover", engine_id))

    def _apply_fault(self, now: float, kind: str, engine_id: str):
        node = next(n for n in self.nodes if n.device_id == engine_id)
        injector = getattr(node.engine, "faults", None)
        if kind == "crash":
            self.engine_crashes += 1
            # every warm/pre-warmed instance dies with the node: expire
            # through the lifecycle (sim parity — its fail handler calls
            # on_expire per instance); lost pre-warm windows are charged as
            # wasted speculation.  No re-arm: a crash is not an idle lapse.
            for model, until in sorted(node.warm.items(),
                                       key=lambda kv: kv[1]):
                eta = node.prewarmed.pop(model, None)
                if eta is not None:
                    self.prewarm_wasted += 1
                    self.log.append(("prewarm-lost", round(now, 6), model,
                                     engine_id, round(eta, 6)))
                else:
                    self.lifecycle.on_expire(model, now)
            node.warm.clear()
            node.prewarmed.clear()
            node.failed = True
            # queued virtual work died with the node.  The drop ledger
            # (`_arrivals - records`) is untouched — every interrupted
            # request already produced its record on the virtual clock —
            # but the crash must COUNT what it cut short, not silently
            # zero the horizon (fault-before-arrival tie-break means an
            # arrival sharing the crash timestamp never lands here).
            self.requests_interrupted += sum(
                1 for e in node.inflight if e["t_end"] > now)
            node.inflight.clear()
            node.busy_until = now
            if injector is not None:
                injector.record("engine.crash", key=engine_id)
            node.engine.crash()  # cold tiers at the CURRENT capacity budget
            self.log.append(("crash", round(now, 6), "", engine_id, 0.0))
            self.sink.record_fault(now, "crash", engine_id)
            if self.tracer.enabled:
                # flight-recorder dump on the TRACE clock (the real plane's
                # Engine.crash also records, on its wall clock)
                self.tracer.record_fault("engine.crash", now,
                                         args={"engine": engine_id})
        else:
            node.failed = False
            self.engine_recoveries += 1
            # rejoin: tiers are cold (crash() already reset them at the
            # then-current budget; pressure events during the downtime hit
            # ALL nodes, failed included — same as the sim), queue horizon
            # restarts from now
            node.busy_until = max(node.busy_until, now)
            if injector is not None:
                injector.record("engine.recover", key=engine_id)
            self.log.append(("recover", round(now, 6), "", engine_id, 0.0))
            self.sink.record_fault(now, "recover", engine_id)
            if self.tracer.enabled:
                self.tracer.instant("engine.recover", now, track="faults",
                                    args={"engine": engine_id})

    def _advance(self, now: float, press: Sequence[PressureEvent],
                 pi: int) -> int:
        """Process pressure events, pre-warm timers, and fault events due by
        `now`, merged in trace-clock order (like the sim's event heap);
        keep-alives that lapsed before each event release their pins
        first.  Tie-break at equal times: fault events first (a crash at t
        pre-empts a timer at t), then timers, then pressure — fixed order,
        so replays are event-for-event deterministic."""
        while True:
            tp = press[pi].time if pi < len(press) else math.inf
            tt = self._timers[0][0] if self._timers else math.inf
            tf = (self._fault_events[0][0] if self._fault_events
                  else math.inf)
            t = min(tp, tt, tf)
            if t > now:
                break
            self._expire_all(t)
            if tf <= tt and tf <= tp:
                fire, _, kind, engine_id = heapq.heappop(self._fault_events)
                self._apply_fault(fire, kind, engine_id)
            elif tt <= tp:
                fire, _, model, eta, prob = heapq.heappop(self._timers)
                self._fire_prewarm(fire, model, eta, prob)
            else:
                for node in self.nodes:
                    node.engine.set_host_capacity(press[pi].capacity_bytes)
                pi += 1
        self._expire_all(now)
        return pi

    # ------------------------------------------------------------ trace run
    def run_trace(self, trace: Sequence[Request], *,
                  pressure: Sequence[PressureEvent] = (),
                  faults: Sequence[FaultEvent] = ()) -> MetricsSink:
        for ev in faults:  # workload-supplied chaos schedule (DESIGN.md §15)
            self.inject_failure(ev.time, ev.engine_id,
                                recover_after=ev.recover_after)
        press = sorted(pressure, key=lambda p: p.time)
        pi = 0
        for req in trace:
            now = req.time
            self._arrivals += 1
            pi = self._advance(now, press, pi)
            model = req.model_id
            self.lifecycle.observe_arrival(model, now)
            self._armed.pop(model, None)  # the arrival voids the prediction
            if any(n.failed for n in self.nodes):
                # failover accounting: a shadow scoring pass with dead nodes
                # visible tells us whether THIS arrival would have landed on
                # a crashed engine — those are the requests the crash
                # actually redrove to survivors
                _, ghost = self._route(model, now, hint=False,
                                       score_dead=True)
                if ghost.failed:
                    self.requests_redriven += 1
            # ALWAYS score — never short-circuit to a warm node.  A warm
            # node wins naturally (device-resident bytes -> t_load ~ 0),
            # but under eq3+queue a saturated warm engine loses to an idle
            # cold one: exactly the trap Algorithm 2's queueing term exists
            # for, and the sim scores every arrival the same way.
            entry, node = self._route(model, now, hint=self.prefetch)
            if entry.migrate and self.migrate_enabled:
                # the router chose migrate-over-queue: hand the blocking
                # decode off BEFORE admission, so this arrival queues only
                # behind the source-side snapshot stall it was priced
                self._do_migrate(node, now)
            cold = model not in node.warm
            if cold:
                self._make_room(node, model, now)
            else:
                node.warm.pop(model)  # LIVE while serving
                eta = node.prewarmed.pop(model, None)
                if eta is not None:
                    self.prewarm_hits += 1
                    self.log.append(("prewarm-hit", round(now, 6), model,
                                     node.device_id, round(eta, 6)))
            self.lifecycle.on_start(model, now, warm=not cold)
            queue_s = max(0.0, node.busy_until - now)
            rec, service_s = self._serve(node, req, now, cold, queue_s)
            t_end = now + queue_s + service_s
            node.busy_until = t_end
            node.inflight = [e for e in node.inflight if e["t_end"] > now]
            node.inflight.append({"t_end": t_end, "model": model,
                                  "kv_bytes": 0.0, "model_bytes": 0.0,
                                  **(self._migration_meta(req) or {})})
            self.decisions.append((round(now, 6), model, node.device_id,
                                   cold, round(queue_s, 6)))
            self.sink.add(rec)
            if self.tracer.enabled:
                # span-accounting identity (DESIGN.md §18): the parent span
                # is the REPORTED ttft, children are the phase fields — a
                # phase folded into the sum without a span shows up as
                # unattributed time, and check_bench fails the entry
                trace_request(
                    self.tracer, rid=len(self.sink.records) - 1,
                    model_id=model, arrival=now, ttft=rec.ttft,
                    phases=[("queue", rec.queue_s), ("init", rec.init_s),
                            ("load", rec.load_s),
                            ("profile", rec.profile_s),
                            ("prefill", rec.prefill_s)],
                    decode_s=rec.decode_s, cold=cold,
                    engine=node.device_id, preds=self._last_preds)
            # post-serve keep-alive: the warm entry was popped at admission,
            # so a stale warm-until can never truncate the fresh TTL (the
            # same idle_epoch-style guard the Gateway and sim carry)
            ttl = self.lifecycle.on_idle(model, t_end)
            if ttl > 0:
                node.engine.retain(model)
                node.warm[model] = t_end + ttl
            else:
                self.lifecycle.on_expire(model, t_end)
                node.engine.release(model)
                self._arm_prewarm(model, t_end)
        return self.sink

    # ----------------------------------------------------------- serve seam
    def _serve(self, node: EngineNode, req: Request, now: float, cold: bool,
               queue_s: float) -> tuple[TTFTRecord, float]:
        """Real-plane serve on the routed engine: measured phase walls (the
        single-engine Gateway's split, each ending on the device), virtual
        trace clock for queueing."""
        eng = node.engine
        t0 = _time.perf_counter()
        rep = submit_load(eng, LoadRequest(req.model_id, now=now))
        load_s = _time.perf_counter() - t0
        stats = eng.last_load
        load_s = max(0.0, load_s - stats.init_seconds
                     - stats.profile_seconds)
        inst = eng.start_instance(req.model_id, num_pages=self.num_pages)
        batch = make_prefill_batch(eng, req.model_id, self.prompt_len,
                                   next(self._req_seq))
        prefill_s, decode_s = generate(inst, batch, self.gen_tokens)
        inst.finish()
        service_s = _time.perf_counter() - t0
        rec = TTFTRecord(
            model_id=req.model_id, arrival=now, cold=cold, queue_s=queue_s,
            init_s=stats.init_seconds, load_s=load_s,
            profile_s=stats.profile_seconds, prefill_s=prefill_s,
            decode_s=decode_s, prefetched=stats.bytes_prefetched > 0,
            bytes_from_store=stats.bytes_store)
        # span/cost cross-check: the measured load wall vs the cost plane's
        # tiered price for the same bytes (the only phase both planes state)
        self._last_preds = {"load": rep.load_seconds}
        return rec, service_s

    # -------------------------------------------------------------- summary
    def stats(self) -> FleetStats:
        """Typed control-plane snapshot (repro.stats schema).  The chaos
        ledger zero-values absent faults, so fault-free snapshots stay
        bit-identical to their pre-chaos selves (DESIGN.md §15)."""
        fc: dict[str, float] = {}
        for n in self.nodes:  # per-engine injectors: summing never doubles
            fs = getattr(n.engine, "fault_summary", None)
            if fs is None:
                continue
            for k, v in fs().items():
                if k == "injected":
                    for point, c in v.items():
                        key = "injected." + point
                        fc[key] = fc.get(key, 0) + c
                else:
                    fc[k] = fc.get(k, 0) + v
        return FleetStats(
            expirations=self.lifecycle.summary()["expirations"],
            prewarms=self.prewarms,
            prewarm_hits=self.prewarm_hits,
            prewarm_wasted=self.prewarm_wasted,
            pressure_evictions=sum(
                getattr(n.engine.store.host_cache, "pressure_evictions", 0)
                for n in self.nodes
                if getattr(n.engine.store, "host_cache", None) is not None),
            dropped_requests=self._arrivals - len(self.sink.records),
            engine_crashes=self.engine_crashes,
            engine_recoveries=self.engine_recoveries,
            requests_redriven=self.requests_redriven,
            requests_interrupted=self.requests_interrupted,
            migrations=self.migrations,
            fault_counters=fc)

    def summary(self) -> dict:
        """Sink percentiles + the typed `stats()` snapshot, one flat dict.
        Key names ARE the `FleetStats` field names — the schema cannot
        drift from the typed surface (DESIGN.md §17)."""
        return {**self.sink.summary(), **self.stats().as_dict()}


class ModeledFleetGateway(FleetGateway):
    """Deterministic fleet over ``ModeledEngine`` nodes: every duration is
    a modeled second from ``PhaseCosts``, so fig16's fleet sweep and the
    golden routing tests are machine-independent and replay-exact.

    Builds its own engines from ``SimModel``s the way ``ClusterSim`` does
    (seeded ``synthetic_tensor_sizes`` records, one pool + host tier per
    engine).  ``variants`` adds fine-tune variant fleets (DESIGN.md §17):
    each ``VariantSpec`` becomes a routable model whose records share its
    base's fingerprints outside the delta leaves, so the affinity score
    steers it toward base-warm engines and a cold start moves only delta
    bytes."""

    def __init__(self, models: Sequence[SimModel], *, n_engines: int = 2,
                 pool_bytes: int, host_cache_bytes: Optional[int] = None,
                 host_keep_alive_s: Optional[float] = None,
                 hw: Optional[Hardware] = None, seed: int = 0,
                 keep_alive="adaptive", prefetch: bool = True,
                 prewarm: bool = True, prewarm_min_benefit: float = 0.0,
                 policy: str = "eq3+queue",
                 faults: Optional[Sequence[FaultInjector]] = None,
                 migrate: bool = False, migrate_replay_tokens: int = 4,
                 variants: Sequence[VariantSpec] = (), tracer=None):
        hw = hw or paper_l40()
        costs = PhaseCosts(hw)
        rng = random.Random(seed + 17)  # the sim's record-size convention
        records: dict[str, list[TensorRecord]] = {}
        specs: dict[str, ModelSpec | str] = {}
        for m in models:
            sizes = synthetic_tensor_sizes(m, rng)
            records[m.model_id] = [
                TensorRecord(name=f"{m.model_id}/t{i}", shape=(s // 2,),
                             dtype="bfloat16",
                             fingerprint=f"{m.model_id}/t{i}", nbytes=s)
                for i, s in enumerate(sizes)]
            specs[m.model_id] = m.model_id
        sims = {m.model_id: m for m in models}
        for v in variants:
            assert v.base_id in records, f"unknown base {v.base_id}"
            records[v.variant_id] = synthetic_variant_records(
                v, records[v.base_id])
            specs[v.variant_id] = v.to_model_spec()
            b = sims[v.base_id]  # same geometry/decode rates as the base
            sims[v.variant_id] = SimModel(v.variant_id, b.params,
                                          b.n_tensors, b.alpha,
                                          b.kv_bytes_per_token)
        if faults is not None:
            assert len(faults) == n_engines, "one injector per engine"
        engines = []
        for i in range(n_engines):
            eng = ModeledEngine(f"engine{i}", pool_bytes, costs=costs,
                                host_cache_bytes=host_cache_bytes,
                                host_keep_alive_s=host_keep_alive_s,
                                faults=faults[i] if faults else None,
                                tracer=tracer)
            for mid, recs in records.items():
                eng.register(specs[mid], recs)
            engines.append(eng)
        super().__init__(engines, keep_alive=keep_alive, hw=hw,
                         prefetch=prefetch, prewarm=prewarm,
                         prewarm_min_benefit=prewarm_min_benefit,
                         policy=policy, migrate=migrate,
                         migrate_replay_tokens=migrate_replay_tokens,
                         tracer=tracer)
        self._sim = sims

    def _migration_meta(self, req: Request) -> dict:
        """Modeled plane knows the decode's KV footprint up front: the
        sequence's token count at the SimModel's per-token KV rate, plus
        the weights the target must hold for replay."""
        m = self._sim[req.model_id]
        tokens = req.prompt_tokens + req.output_tokens
        return {"kv_bytes": float(m.kv_bytes_per_token * tokens
                                  * max(1, req.batch_size)),
                "model_bytes": float(m.bytes)}

    def _serve(self, node: EngineNode, req: Request, now: float, cold: bool,
               queue_s: float) -> tuple[TTFTRecord, float]:
        m = self._sim[req.model_id]
        eng = node.engine
        start = now + queue_s
        init_s = self.costs.init_time(m.bytes) if cold else 0.0
        # the load lands after queueing + init on the trace clock, so a
        # hint fired at routing time has (queue_s + init_s) of elapsed
        # background read when `take_prefetch` prices the overlap
        rep = submit_load(eng, LoadRequest(req.model_id, now=start + init_s))
        load_s = rep.load_seconds + rep.merge_seconds
        profile_s = self.costs.profile_time(m.bytes) if cold else 0.0
        prefill_s = self.costs.prefill_time(m.params, req.prompt_tokens,
                                            req.batch_size)
        decode_s = self.costs.decode_time(m.bytes, req.output_tokens)
        rec = TTFTRecord(
            model_id=req.model_id, arrival=now, cold=cold, queue_s=queue_s,
            init_s=init_s, load_s=load_s, profile_s=profile_s,
            prefill_s=prefill_s, decode_s=decode_s,
            prefetched=rep.prefetched,
            bytes_from_store=rep.bytes_from_store)
        # modeled phases ARE their own predictions (queue is emergent), so
        # span_cost_ratio pins at 1.0 — drift means a phase was billed into
        # TTFT without being priced
        self._last_preds = {"init": init_s, "load": load_s,
                            "profile": profile_s, "prefill": prefill_s}
        service_s = init_s + load_s + profile_s + prefill_s + decode_s
        return rec, service_s
