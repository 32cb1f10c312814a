"""Event-driven cluster simulator: controller + N multi-instance workers.

This is the *cost plane* (DESIGN.md §2): the Tangram algorithms (Reuse Store,
MCE+PGP allocation, ElasticKV block accounting, affinity scheduling) execute
for real and byte-exact; wall-clock latencies for transfer/init/profile/
prefill/decode come from the calibrated PhaseCosts model.

Policies:
  sllm      exclusive memory, parallel chunked loading (baseline)
  sllm-c    + CRIU checkpointing (Init ~ gone)
  sllm-cm   + Medusa offline profiling (Profile ~ gone)
  reuse     SLLM + Tangram Reuse Store (Fig. 9 "+Reuse")
  tangram   reuse + on-demand KV + affinity scheduling (full system)
  tangram-conc      + concurrent multi-instance workers with queueing-aware
                      affinity (DESIGN.md §8; beyond-paper)
  tangram-conc-eq3  concurrent workers but pure Eq.-3 affinity (ablation)
Variants toggled via SimPolicy fields for ablations (Fig. 10/12/13/14).

Concurrency model (DESIGN.md §8): a worker may keep several model instances
decoding at once over the shared Unified Memory Pool, each with its own
ElasticKV accounting.  Requests for an already-decoding model JOIN the
running instance (continuous batching: no load, no new slot) instead of
queueing for exclusivity.  Admission control rejects a placement when the
weights + a per-sequence KV headroom reservation do not fit beside the
already-pinned instances.  Decode of k co-resident instances shares HBM
bandwidth: each new request's decode time is scaled by the number of busy
instances on its device at start (processor-sharing approximation, fixed at
admission).
"""
from __future__ import annotations

import heapq
import itertools
import random
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.core.costmodel import Hardware, PhaseCosts, paper_l40
from repro_torch.core.elastic_kv import ElasticKV
from repro_torch.core.hostcache import SimHostCache
from repro_torch.core.regions import RState
from repro_torch.core.reuse_store import AllocationError, ReuseStore
from repro_torch.core.scheduler import affinity_schedule, random_schedule
from repro_torch.core.trace import (Request, SimModel, percentile,
                              synthetic_tensor_sizes,
                              synthetic_variant_records)
from repro_torch.models.tensors import TensorRecord
from repro_torch.obs import NULL_TRACER, BoundedLog, trace_request
from repro_torch.stats import ClusterSummaryStats


@dataclass(frozen=True)
class SimPolicy:
    name: str
    criu: bool = False
    medusa: bool = False
    reuse: bool = False  # retain tensors across instances (Reuse Store)
    odkv: bool = False  # on-demand KV allocation
    affinity: bool = False  # affinity-aware scheduling (else random)
    alloc_policy: str = "mce+pgp"  # mce+pgp | mce+gm | rand+gm
    keep_alive: float = 40.0
    kv_block_tokens: int = 16
    kv_blocks_per_region: int = 64
    max_seq_reserve: int = 4096  # non-ODKV worst-case KV reservation
    # ---- concurrent multi-instance workers (DESIGN.md §8)
    concurrent: bool = False  # several instances may decode on one device
    max_concurrent: int = 4  # active-instance slots per worker (concurrent)
    queue_aware: bool = False  # affinity score adds expected_queue_delay
    max_join_batch: int = 8  # sequences batched onto one running instance
    admit_kv_tokens: int = 512  # per-sequence KV headroom at admission
    # ---- tiered model store (DESIGN.md §11): per-node host-cache byte cap.
    # None disables host-tier modeling (legacy: every transferred byte is
    # priced at h2d_bw).  When set, each node gets a bounded LRU host cache;
    # misses beyond it are promoted from the persistent store at
    # min(h2d_bw, store_bw), and affinity t_load scores see the split.
    host_cache_bytes: Optional[float] = None
    # ---- prefetch-on-affinity-hint (DESIGN.md §12): when placement picks a
    # node, its host tier starts promoting the model's store-resident
    # tensors immediately, so the store read overlaps worker-queue wait +
    # Init instead of extending the load (overlap-aware Eq. 3 pricing; tier
    # byte counters unchanged).  Needs host_cache_bytes.
    prefetch: bool = False
    # hints unconsumed after this long are dead at the cache (their
    # placement was dropped or served warm) — a later unrelated load must
    # not inherit their overlap credit
    prefetch_ttl: float = 60.0
    # host-tier aging: tensors idle in a node's host cache longer than this
    # TTL are spilled (keep-alive expiry / co-tenant churn).  None = static.
    host_keep_alive: Optional[float] = None
    # ---- serverless control plane (DESIGN.md §13): instance lifecycle.
    # None keeps the legacy fixed `keep_alive` TTL.  Otherwise a keep-alive
    # spec for serverless.lifecycle.make_keep_alive ("zero", "fixed:T",
    # "adaptive[:P]") — idle instances scale to zero on the TTL the
    # LifecycleManager picks per model, and cold/warm transitions are
    # logged for golden replay.
    lifecycle: Optional[str] = None
    # ---- live KV migration (DESIGN.md §16): a worker blocked by a long
    # decode may offer to hand that decode to a peer; the affinity score
    # then sees the other instances' residual plus the source-side
    # snapshot stall instead of the full blocking residual (migrate vs
    # queue).  Needs queue_aware — the offer replaces the queueing term.
    migrate: bool = False
    migrate_replay_tokens: int = 4  # snapshot-window tokens replayed (K)


POLICIES = {
    "sllm": SimPolicy("sllm"),
    "sllm-c": SimPolicy("sllm-c", criu=True),
    "sllm-cm": SimPolicy("sllm-cm", criu=True, medusa=True),
    "reuse": SimPolicy("reuse", criu=True, medusa=True, reuse=True),
    "tangram": SimPolicy("tangram", criu=True, medusa=True, reuse=True,
                         odkv=True, affinity=True),
    "tangram-conc": SimPolicy("tangram-conc", criu=True, medusa=True,
                              reuse=True, odkv=True, affinity=True,
                              concurrent=True, queue_aware=True),
    "tangram-conc-eq3": SimPolicy("tangram-conc-eq3", criu=True, medusa=True,
                                  reuse=True, odkv=True, affinity=True,
                                  concurrent=True, queue_aware=False),
    # full system over a BOUNDED per-node host cache (64 GB ~= half the
    # paper-model working set): cold loads beyond the cap pay the
    # persistent-store tier, and affinity scoring sees the host/store split
    "tangram-tier": SimPolicy("tangram-tier", criu=True, medusa=True,
                              reuse=True, odkv=True, affinity=True,
                              concurrent=True, queue_aware=True,
                              host_cache_bytes=64e9),
    # tiered system + prefetch-on-affinity-hint: placement starts the
    # store->host promotion, so cold loads pay only the part of the store
    # read the queue+init window could not hide (DESIGN.md §12)
    "tangram-prefetch": SimPolicy("tangram-prefetch", criu=True, medusa=True,
                                  reuse=True, odkv=True, affinity=True,
                                  concurrent=True, queue_aware=True,
                                  host_cache_bytes=64e9, prefetch=True),
    # full serverless control plane (DESIGN.md §13): the prefetching tiered
    # system with histogram-adaptive keep-alive driving per-model
    # scale-to-zero instead of the fixed 40 s TTL
    "tangram-serverless": SimPolicy("tangram-serverless", criu=True,
                                    medusa=True, reuse=True, odkv=True,
                                    affinity=True, concurrent=True,
                                    queue_aware=True, host_cache_bytes=64e9,
                                    prefetch=True, lifecycle="adaptive"),
    # serverless plane + live KV migration (DESIGN.md §16): long decodes
    # hand off to idle peers instead of walling arrivals behind their
    # residual — the evict-vs-queue-vs-migrate decision fig18 sweeps
    "tangram-migrate": SimPolicy("tangram-migrate", criu=True, medusa=True,
                                 reuse=True, odkv=True, affinity=True,
                                 concurrent=True, queue_aware=True,
                                 host_cache_bytes=64e9, prefetch=True,
                                 lifecycle="adaptive", migrate=True),
}


@dataclass
class RequestResult:
    model_id: str
    arrival: float
    start: float
    warm: bool
    joined: bool = False  # batched onto an already-decoding instance
    concurrency: int = 1  # busy instances on the device at start
    queue_s: float = 0.0
    init_s: float = 0.0
    load_s: float = 0.0
    bytes_from_host: int = 0  # tier split of bytes_transferred
    bytes_from_store: int = 0
    prefetched: bool = False  # a placement-time prefetch hint covered the load
    bytes_store_hidden: int = 0  # store bytes hidden by the overlap window
    merge_s: float = 0.0
    profile_s: float = 0.0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    kv_overhead_s: float = 0.0
    reuse_fraction: float = 0.0
    bytes_total: int = 0
    bytes_hit: int = 0
    bytes_transferred: int = 0
    bytes_merged: int = 0

    @property
    def ttft(self) -> float:
        return (self.queue_s + self.init_s + self.load_s + self.merge_s
                + self.profile_s + self.prefill_s)

    @property
    def load_phase(self) -> float:
        return self.load_s + self.merge_s

    @property
    def done(self) -> float:
        """Completion wall-clock time of this request."""
        return self.start + self.ttft - self.queue_s + self.decode_s


# per-op costs for ElasticKV runtime overhead (Fig. 11b calibration)
KV_POOL_ALLOC_S = 2.0e-4
KV_FREELIST_ALLOC_S = 2.0e-6


@dataclass
class WorkerInstance:
    """One model instance resident on a worker: weights pinned in the store,
    its own ElasticKV over the shared pool, and a batch of in-flight
    sequences (running > 0 while decoding, 0 while idle in keep-alive)."""

    model_id: str
    weight_bytes: int
    seq: int  # monotone token: invalidates stale idle_expire timers
    # idle-period token: bumped each time a keep-alive timer is armed, so a
    # timer from a PREVIOUS idle period (instance warm-reused meanwhile,
    # same seq) cannot truncate the TTL the latest idle transition chose
    idle_epoch: int = 0
    kv: Optional[ElasticKV] = None
    kv_reserved: list[tuple[int, int]] = field(default_factory=list)  # (off, size)
    running: int = 0  # in-flight requests
    batched_seqs: int = 0  # sequences currently in the decode batch
    expected_free: float = 0.0  # latest completion among in-flight requests
    last_used: float = 0.0

    def kv_pinned_bytes(self) -> int:
        reserved = sum(size for _, size in self.kv_reserved)
        if self.kv is not None:
            reserved += self.kv.reserved_bytes()
        return reserved


class SimWorker:
    def __init__(self, wid: str, capacity: int, costs: PhaseCosts,
                 policy: SimPolicy, *, indexed: bool = True):
        self.device_id = wid
        self.capacity = capacity
        self.policy = policy
        self.costs = costs
        self.indexed = indexed
        store_policy = policy.alloc_policy if policy.reuse else "none"
        self.store = ReuseStore(capacity, costs, policy=store_policy,
                                indexed=indexed)
        # bounded per-node host Model Store tier (None = legacy unbounded)
        self.host_cache: Optional[SimHostCache] = None
        if policy.host_cache_bytes is not None:
            self.host_cache = SimHostCache(int(policy.host_cache_bytes),
                                           keep_alive_s=policy.host_keep_alive,
                                           hint_ttl_s=policy.prefetch_ttl)
            self.store.host_cache = self.host_cache
        self.kv_rate: dict[str, int] = {}  # model_id -> kv_bytes_per_token
        self.slots = policy.max_concurrent if policy.concurrent else 1
        self.instances: dict[str, WorkerInstance] = {}
        # waiting room: same-model follow-ups (exclusive) or requests routed
        # here while their instance's decode batch was full (concurrent)
        self.queue: deque[Request] = deque()
        self.queued_work_s = 0.0  # estimated decode seconds waiting in queue
        self._seq = itertools.count()
        self.last_assign = -1.0
        self.failed = False
        # serverless lifecycle manager (shared, set by ClusterSim): every
        # instance termination reports an expiry to it
        self.lifecycle = None
        # controller back-ref for migration target discovery (set by
        # ClusterSim); None keeps migration_offer silent
        self.cluster = None

    # ----------------------------------------------------------------- views
    def busy_instances(self) -> list[WorkerInstance]:
        return [i for i in self.instances.values() if i.running > 0]

    def idle_instances(self) -> list[WorkerInstance]:
        return [i for i in self.instances.values() if i.running == 0]

    @property
    def busy_model(self) -> Optional[str]:
        """Single-instance compat view: a model currently decoding, if any."""
        busy = self.busy_instances()
        return busy[0].model_id if busy else None

    @property
    def idle_model(self) -> Optional[str]:
        idle = self.idle_instances()
        return idle[0].model_id if idle else None

    def has_free_slot(self) -> bool:
        return len(self.busy_instances()) < self.slots

    def pinned_bytes(self, *, busy_only: bool = False) -> int:
        """Bytes the pool cannot reclaim right now: weights + KV of resident
        instances.  Idle instances are terminable, so admission checks pass
        busy_only=True and rely on LRU termination to make room."""
        insts = self.busy_instances() if busy_only else self.instances.values()
        return sum(i.weight_bytes + i.kv_pinned_bytes() for i in insts)

    # --------------------------------------------------- DeviceView protocol
    def can_run(self, model_bytes: int, model_id: Optional[str] = None) -> bool:
        if self.failed or not self.has_free_slot():
            return False
        if not self.policy.concurrent:
            return model_bytes <= self.capacity
        # model-identity-aware admission: when this model is already BUSY
        # here, its weights sit inside pinned_bytes(busy_only=True) and a new
        # placement shares them (join / shared tensors) — counting them again
        # double-charges the pool and locks hot workers out (ROADMAP item).
        shared = 0
        kv_need = self.policy.admit_kv_tokens  # rate unknown: nominal floor
        if model_id is not None:
            inst = self.instances.get(model_id)
            if inst is not None and inst.running > 0:
                shared = min(model_bytes, inst.weight_bytes)
            rate = self.kv_rate.get(model_id)
            if rate is not None:  # real per-sequence KV headroom in BYTES
                kv_need = self.policy.admit_kv_tokens * max(rate, 1)
        return self.can_admit(model_bytes - shared, kv_need)

    def reusable_bytes(self, records: Sequence[TensorRecord]) -> int:
        return self.store.reusable_bytes(records)

    def host_resident_bytes(self, records: Sequence[TensorRecord]) -> int:
        """Bytes of the records a load here would actually MISS in the
        device pool that the HOST tier caches (DESIGN.md §11).  Counting
        device-resident records' host copies would let a node whose host
        tier spilled exactly the missing tensors score as if it cached
        them.  With host-tier modeling off, every miss counts as
        host-cached — the legacy assumption the tiered score generalizes."""
        misses = [r for r in records if r.fingerprint not in self.store.tensor_map]
        if self.host_cache is None:
            return sum(r.nbytes for r in misses)
        return self.host_cache.host_resident_bytes(misses)

    def hint_prefetch(self, model_id: str, records: Sequence[TensorRecord],
                      now: float):
        """Prefetch-on-affinity-hint (DESIGN.md §12): the scheduler placed a
        request here — start promoting the model's store-resident tensors
        into this node's host tier NOW.  Gated on the policy so unhinted
        baselines (tangram-tier and below) keep their exact timings."""
        if self.policy.prefetch:
            self.store.hint_prefetch(model_id, records, now)

    def expected_queue_delay(self, now: float) -> float:
        """Expected queueing seconds a new instance placement sees here:
        residual decode work of busy instances plus the decode work already
        waiting in this worker's queue, spread over the slots (M/G/k-style
        processor-sharing estimate).  This is the term the pure-Eq.3 score
        ignores — and why hot devices absorb every request for their
        resident models under bursts (DESIGN.md §8)."""
        residual = sum(max(0.0, i.expected_free - now)
                       for i in self.busy_instances())
        return (residual + self.queued_work_s) / max(1, self.slots)

    # ------------------------------------------------ live KV migration §16
    def kv_inflight_bytes(self, inst: WorkerInstance) -> int:
        """Deterministic KV estimate of an in-flight decode batch: the
        per-sequence admission headroom times the batched sequences.  (The
        sim releases exact ElasticKV accounting right after pricing it, so
        the admission-control estimate is the footprint both the offer and
        the execution price — they must agree.)"""
        rate = self.kv_rate.get(inst.model_id, 0)
        return (rate * self.policy.admit_kv_tokens
                * max(1, inst.batched_seqs))

    def migration_victim(self) -> Optional[WorkerInstance]:
        """The longest-residual busy decode — what an arrival here would
        wait behind, and what a handoff frees."""
        busy = self.busy_instances()
        if not busy:
            return None
        return max(busy, key=lambda i: (i.expected_free, i.model_id))

    def migration_offer(self, now: float) -> Optional[float]:
        """DeviceView (optional, DESIGN.md §16): expected queueing here if
        the blocking decode migrates away — the OTHER instances' residual
        plus the source-side snapshot stall, processor-shared like
        `expected_queue_delay` — or None when no handoff pays.
        Side-effect-free; the scheduler's chosen entry executes it."""
        if not self.policy.migrate or self.failed or self.cluster is None:
            return None
        victim = self.migration_victim()
        if victim is None:
            return None
        rem = victim.expected_free - now
        if rem <= 0.0:
            return None
        kv = self.kv_inflight_bytes(victim)
        if kv <= 0:
            return None
        full = self.costs.migrate_time(
            kv, victim.weight_bytes,
            replay_tokens=self.policy.migrate_replay_tokens)
        if full >= rem:
            return None  # the decode finishes before the handoff would
        if self.cluster.migration_target(self, victim, now) is None:
            return None
        stall = self.costs.migrate_stall(kv)
        residual = sum(max(0.0, i.expected_free - now)
                       for i in self.busy_instances())
        return max(0.0, (residual - rem + stall + self.queued_work_s)
                   / max(1, self.slots))

    # ------------------------------------------------------ admission control
    def kv_admit_need(self, model: SimModel, batch_size: int,
                      admit_tokens: Optional[int] = None) -> int:
        tokens = (self.policy.admit_kv_tokens if admit_tokens is None
                  else admit_tokens)
        return batch_size * tokens * max(model.kv_bytes_per_token, 1)

    def can_admit(self, model_bytes: int, admit_kv_bytes: int = 0) -> bool:
        """Weights + KV headroom fit beside the busy instances' pinned bytes
        (inactive resident tensors and idle instances are reclaimable)."""
        need = model_bytes + admit_kv_bytes
        return need <= self.capacity - self.pinned_bytes(busy_only=True)

    def can_join(self, model: SimModel, batch_size: int) -> bool:
        """A request may join this worker's running instance of the model:
        batch cap not exceeded and KV headroom for the new sequences."""
        if not self.policy.concurrent:
            return False  # exclusive baselines serialize same-model requests
        inst = self.instances.get(model.model_id)
        if inst is None or inst.running == 0 or self.failed:
            return False
        if inst.batched_seqs + batch_size > self.policy.max_join_batch:
            return False
        kv_need = self.kv_admit_need(model, batch_size)
        return kv_need <= self.capacity - self.pinned_bytes()

    def has_waiter_for(self, model_id: str) -> bool:
        """A request for this model is already parked in the worker queue —
        fresh arrivals must not batch-join ahead of it (FIFO fairness)."""
        return any(q.model_id == model_id for q in self.queue)

    # -------------------------------------------------------------- instance
    def terminate_instance(self, model_id: str, now: Optional[float] = None):
        """Scale an instance to zero.  `now` (when known) notifies the
        lifecycle manager — EVERY termination is an expiry from the control
        plane's view, whether a timer, capacity pressure (make_room /
        terminate_idle), or a node failure killed it; otherwise the
        manager's state and expiration counters drift from the sim."""
        inst = self.instances.pop(model_id)
        self.store.release(model_id)
        if not self.policy.reuse:
            self.store.drop_model(model_id)
        if inst.kv is not None:
            inst.kv.finish_instance()
        for off, _ in inst.kv_reserved:
            self.store.pool.free(off)
        if self.lifecycle is not None and now is not None:
            self.lifecycle.on_expire(model_id, now)

    def terminate_idle(self, now: Optional[float] = None):
        for inst in list(self.idle_instances()):
            self.terminate_instance(inst.model_id, now)

    def make_room(self, need_bytes: int, now: Optional[float] = None):
        """LRU-terminate idle co-tenants until `need_bytes` fits beside the
        still-pinned instances (warm younger tenants survive)."""
        for inst in sorted(self.idle_instances(), key=lambda i: i.last_used):
            if need_bytes <= self.capacity - self.pinned_bytes():
                return
            self.terminate_instance(inst.model_id, now)

class ClusterSim:
    def __init__(self, models: Sequence[SimModel], policy: SimPolicy, *,
                 n_workers: int = 1, hw: Optional[Hardware] = None, seed: int = 0,
                 pool_bytes: Optional[int] = None, indexed: bool = True,
                 variants: Sequence = (), tracer=None):
        self.hw = hw or paper_l40()
        # obs plane (DESIGN.md §18): spans carry VIRTUAL trace-clock
        # timestamps — the sim never reads a wall clock, so a replay at a
        # fixed seed serializes a bit-identical trace
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.costs = PhaseCosts(self.hw, criu=policy.criu, medusa=policy.medusa)
        self.policy = policy
        self.models = {m.model_id: m for m in models}
        rng = random.Random(seed + 17)
        self.records: dict[str, list[TensorRecord]] = {}
        for m in models:
            sizes = synthetic_tensor_sizes(m, rng)
            self.records[m.model_id] = [
                TensorRecord(name=f"{m.model_id}/t{i}", shape=(s // 2,),
                             dtype="bfloat16", fingerprint=f"{m.model_id}/t{i}",
                             nbytes=s)
                for i, s in enumerate(sizes)
            ]
        # fine-tune variants (DESIGN.md §17): each VariantSpec clones its
        # base's shape/size profile but shares the base's fingerprints for
        # every non-delta leaf, so the pool/host tiers dedup them and the
        # affinity score routes a variant toward base-warm workers
        for v in variants:
            base = self.models[v.base_id]
            self.models[v.variant_id] = SimModel(
                v.variant_id, base.params, base.n_tensors, base.alpha,
                base.kv_bytes_per_token)
            self.records[v.variant_id] = synthetic_variant_records(
                v, self.records[v.base_id])
        cap = int(pool_bytes if pool_bytes is not None else self.hw.device_mem)
        kv_rates = {m.model_id: m.kv_bytes_per_token
                    for m in self.models.values()}
        self.workers = [SimWorker(f"gpu{i}", cap, self.costs, policy,
                                  indexed=indexed)
                        for i in range(n_workers)]
        for w in self.workers:
            w.kv_rate = kv_rates
        self.rng = random.Random(seed)
        # serverless lifecycle manager (DESIGN.md §13).  Lazy import: the
        # serverless package's gateway imports repro.core back — importing
        # it at module scope would cycle through core/__init__.
        self.lifecycle = None
        if policy.lifecycle is not None:
            from repro_torch.serverless.lifecycle import (LifecycleManager,
                                                    make_keep_alive)
            self.lifecycle = LifecycleManager(make_keep_alive(policy.lifecycle))
        for w in self.workers:
            w.lifecycle = self.lifecycle
            w.cluster = self  # migration target discovery (DESIGN.md §16)
        self.migrations = 0
        # handoff log: (time, model, src, dst, stall_s, moved_done) —
        # bounded ring with counted drops (DESIGN.md §18)
        self.migrate_log: BoundedLog = BoundedLog(4096)
        # current fleet-wide host-tier budget: pressure events move it, and
        # a failed node that recovers must rejoin at the CURRENT budget,
        # not the policy's original one
        self._host_cap = policy.host_cache_bytes
        self.results: list[RequestResult] = []
        self.global_queue: deque[Request] = deque()
        self._events: list = []
        self._seq = itertools.count()
        self.access_counts: dict[str, float] = defaultdict(float)
        self._access_total = 0.0  # running sum of access_counts (O(1) update)
        self.events_processed = 0

    # --------------------------------------------------------------- events
    def _push(self, t: float, kind: str, payload):
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    # ------------------------------------------------------------ scheduling
    def _record_access(self, model_id: str):
        """EWMA access counts with an O(1) running total — the per-arrival
        all-models/all-workers probability rebroadcast is gone; workers get a
        fresh snapshot lazily, right before their store consumes it."""
        old = self.access_counts[model_id]
        new = 0.9 * old + 1.0
        self.access_counts[model_id] = new
        self._access_total += new - old

    def _refresh_miss_probs(self, w: SimWorker):
        """Push current p_m into `w`'s store.  Called at placement/join time —
        the only points whose eviction decisions read miss_prob — so the store
        sees exactly the probabilities it would have under per-arrival
        broadcasting, without the per-arrival cost."""
        total = self._access_total or 1.0
        w.store.miss_prob.update(
            (m, c / total) for m, c in self.access_counts.items())

    def _try_schedule(self, now: float):
        if not self.global_queue:
            return
        avail = [w for w in self.workers
                 if w.has_free_slot() and not w.failed]
        if not avail:
            return
        # LRU candidate order: Algorithm 2 keeps the first device on latency
        # ties, so presenting least-recently-assigned workers first spreads
        # no-reuse models across the fleet instead of churning one pool.
        avail.sort(key=lambda w: w.last_assign)
        reqs = [(r.model_id, self.records[r.model_id],
                 self.models[r.model_id].bytes) for r in self.global_queue]
        if self.policy.affinity:
            sched_policy = "eq3+queue" if self.policy.queue_aware else "eq3"
            schedules, _ = affinity_schedule(reqs, avail, self.hw,
                                             policy=sched_policy, now=now)
        else:
            schedules, _ = random_schedule(reqs, avail, self.rng)
        chosen = {s.model_id: s.device_id for s in schedules}
        migrating = {s.model_id for s in schedules if s.migrate}
        assigned = []
        byid = {w.device_id: w for w in self.workers}
        remaining = deque()
        used = set()
        for r in self.global_queue:
            dev = chosen.get(r.model_id)
            if dev is not None and dev not in used and r.model_id not in used:
                used.add(dev)
                used.add(r.model_id)
                assigned.append((r, byid[dev]))
            else:
                remaining.append(r)
        self.global_queue = remaining
        for r, w in assigned:
            if r.model_id in migrating:
                # the scheduler priced migrate-over-queue for this worker:
                # hand its blocking decode off before the placement lands
                self._execute_migration(now, w)
            self._start_on_worker(now, r, w)

    # ----------------------------------------------------- per-worker queue
    def _enqueue_on_worker(self, w: SimWorker, req: Request, *,
                           front: bool = False):
        if front:
            w.queue.appendleft(req)
        else:
            w.queue.append(req)
        model = self.models[req.model_id]
        w.queued_work_s += self.costs.decode_time(model.bytes, req.output_tokens)

    def _dequeue_from_worker(self, w: SimWorker) -> Request:
        req = w.queue.popleft()
        model = self.models[req.model_id]
        w.queued_work_s = max(0.0, w.queued_work_s - self.costs.decode_time(
            model.bytes, req.output_tokens))
        return req

    def _drain_worker_queue(self, now: float, w: SimWorker) -> bool:
        """Serve head-of-line waiting requests that became serviceable: join
        their running instance once batch slots freed, or start them when an
        instance slot opened.  Returns whether anything was served."""
        served = False
        while w.queue and not w.failed:
            nxt = w.queue[0]
            nmodel = self.models[nxt.model_id]
            ninst = w.instances.get(nxt.model_id)
            if ninst is not None and ninst.running > 0:
                if not w.can_join(nmodel, nxt.batch_size):
                    break  # decode batch still full: keep waiting (FIFO)
                self._join_instance(now, self._dequeue_from_worker(w), w, ninst)
            elif w.has_free_slot():
                if not self._start_on_worker(now, self._dequeue_from_worker(w), w):
                    break  # placement failed and re-queued: wait for a drain
            else:
                break
            served = True
        return served

    # ------------------------------------------------------------ KV plumbing
    def _run_kv(self, req: Request, w: SimWorker, inst: WorkerInstance,
                res: RequestResult, model: SimModel):
        """Per-request KV accounting on the instance's ElasticKV (ODKV) or a
        worst-case reservation (baselines).  Returns the output token count
        actually decodable (truncated under genuine device pressure)."""
        # engines cap sequence memory at what the device can actually hold
        # (vLLM's max_num_batched_tokens); same cap applies to every policy.
        kv_budget = max(0, w.capacity - model.bytes)
        token_cap = int(0.9 * kv_budget / max(model.kv_bytes_per_token, 1)
                        / max(req.batch_size, 1))
        prompt_tokens = max(8, min(req.prompt_tokens, token_cap // 2))
        output_tokens = max(4, min(req.output_tokens, token_cap - prompt_tokens))
        total_tokens = prompt_tokens + output_tokens
        if self.policy.odkv:
            if inst.kv is None:
                inst.kv = ElasticKV(w.store, req.model_id,
                                    block_tokens=self.policy.kv_block_tokens,
                                    kv_bytes_per_token=model.kv_bytes_per_token,
                                    blocks_per_region=self.policy.kv_blocks_per_region)
            kv = inst.kv
            p0, f0 = kv.stats.pool_allocs, kv.stats.freelist_allocs
            seq_keys = [f"r{id(req)}-{b}" for b in range(req.batch_size)]
            # prefill allocation (batched) + per-step growth, amortized here
            for step_tokens in range(prompt_tokens, total_tokens + 1,
                                     self.policy.kv_block_tokens):
                try:
                    kv.ensure(dict.fromkeys(seq_keys, step_tokens))
                except MemoryError:
                    # device genuinely full: sequence is truncated (preemption
                    # /swap in a real engine); decode proceeds on what fits
                    output_tokens = max(4, step_tokens - prompt_tokens)
                    break
            res.kv_overhead_s = ((kv.stats.pool_allocs - p0) * KV_POOL_ALLOC_S
                                 + (kv.stats.freelist_allocs - f0) * KV_FREELIST_ALLOC_S)
            for key in seq_keys:
                kv.release(key)
        else:
            # worst-case reservation (vLLM-style): batch x max-seq KV bytes,
            # EVICTING inactive resident tensors to make room — this is what
            # destroys reuse at large batch sizes (Fig. 9/11a)
            if not inst.kv_reserved:
                want = (req.batch_size * self.policy.max_seq_reserve
                        * model.kv_bytes_per_token)
                want = min(want, w.capacity - model.bytes)
                if want > w.store.free_bytes():
                    w.store.urgent_reclaim(want)
                want = min(want, w.store.free_bytes())
                remaining = want
                while remaining > 0:
                    chunk = min(remaining, w.store.pool.largest_free())
                    if chunk <= 0:
                        break
                    reg = w.store.pool.alloc_best_fit(
                        chunk, RState.KV, f"kvres:{req.model_id}", pinned=True)
                    if reg is None:
                        break
                    inst.kv_reserved.append((reg.offset, reg.size))
                    remaining -= chunk
        return output_tokens

    # --------------------------------------------------------- instance start
    def _start_on_worker(self, now: float, req: Request, w: SimWorker) -> bool:
        """Place `req` on `w`: join, start, or (concurrent mode) park it in
        the worker queue when the decode batch or the pool can't take it yet.
        Returns False when the request had to wait."""
        self._refresh_miss_probs(w)
        model = self.models[req.model_id]
        inst = w.instances.get(req.model_id)
        if inst is not None and inst.running > 0:
            # scheduler routed a request at a worker already decoding this
            # model: batch it on if the decode batch has room (and no earlier
            # same-model request is parked), else wait in the worker's queue
            # for a batch slot (the queueing delay the eq3+queue affinity
            # score accounts for)
            if w.can_join(model, req.batch_size) and not w.has_waiter_for(
                    req.model_id):
                self._join_instance(now, req, w, inst)
                return True
            self._enqueue_on_worker(w, req)
            return False
        warm = inst is not None  # idle same-model instance in keep-alive
        if not warm:
            if self.policy.concurrent:
                kv_need = w.kv_admit_need(model, req.batch_size)
                w.make_room(model.bytes + kv_need, now)  # LRU-free idle co-tenants
            else:
                w.terminate_idle(now)
        w.last_assign = now
        res = RequestResult(model_id=req.model_id, arrival=req.time, start=now,
                            warm=warm, queue_s=now - req.time,
                            concurrency=len(w.busy_instances()) + 1)
        if warm:
            w.store.activate(req.model_id)
            # keep-alive hit: everything resident, nothing transferred.
            # reuse_fraction stays 0 — it counts tensor-level Reuse Store
            # hits at LOAD time only (Fig. 9 semantics), not warm starts.
            res.bytes_total = model.bytes
            res.bytes_hit = model.bytes
            res.prefill_s = self.costs.prefill_time(model.params, req.prompt_tokens,
                                                    req.batch_size)
        else:
            res.init_s = self.costs.init_time(model.bytes)
            # Init is the hideable window between landing here and the load's
            # own h2d starting: a pending prefetch hint's store read keeps
            # running through it (plus the hint->now worker-queue elapsed,
            # which the host cache tracks itself)
            try:
                rep = w.store.load_model(req.model_id, self.records[req.model_id],
                                         now=now, overlap_s=res.init_s)
            except AllocationError:
                # model cannot fit: drop idle co-tenants then retry once
                w.terminate_idle(now)
                try:
                    rep = w.store.load_model(req.model_id,
                                             self.records[req.model_id],
                                             now=now, overlap_s=res.init_s)
                except AllocationError:
                    if not self.policy.concurrent:
                        raise
                    # busy co-tenants pin too much (fragmented) space for
                    # this model right now: admission defers the placement
                    # until an instance drains instead of failing the fleet
                    self._enqueue_on_worker(w, req, front=True)
                    return False
            res.load_s, res.merge_s = rep.load_seconds, rep.merge_seconds
            res.reuse_fraction = rep.reuse_fraction
            res.bytes_total = rep.bytes_total
            res.bytes_hit = rep.bytes_hit
            res.bytes_transferred = rep.bytes_transferred
            res.bytes_from_host = rep.bytes_from_host
            res.bytes_from_store = rep.bytes_from_store
            res.prefetched = rep.prefetched
            res.bytes_store_hidden = rep.bytes_store_hidden
            res.bytes_merged = rep.bytes_merged
            res.profile_s = self.costs.profile_time(model.bytes)
            res.prefill_s = self.costs.prefill_time(model.params, req.prompt_tokens,
                                                    req.batch_size)
            inst = WorkerInstance(req.model_id, model.bytes, next(w._seq))
            w.instances[req.model_id] = inst

        if self.lifecycle is not None:
            # recorded HERE, past every defer/requeue path, so lifecycle
            # starts match emitted results one-for-one (a placement parked
            # by admission control is not a start yet)
            self.lifecycle.on_start(req.model_id, now, warm=warm)
        output_tokens = self._run_kv(req, w, inst, res, model)
        res.decode_s = (self.costs.decode_time(model.bytes, output_tokens)
                        * res.concurrency + res.kv_overhead_s)
        inst.running += 1
        inst.batched_seqs = req.batch_size
        inst.last_used = now
        done = now + res.ttft - res.queue_s + res.decode_s
        inst.expected_free = max(inst.expected_free, done)
        self.results.append(res)
        if self.tracer.enabled:
            self._trace_result(res, w.device_id)
        self._push(done, "request_done",
                   (w.device_id, req.model_id, req.batch_size, inst.seq))
        return True

    def _join_instance(self, now: float, req: Request, w: SimWorker,
                       inst: WorkerInstance):
        """Continuous batching: the request's sequences join the model's
        running decode batch — no load, no init, no new slot."""
        self._refresh_miss_probs(w)
        if self.lifecycle is not None:
            self.lifecycle.on_start(req.model_id, now, warm=True)
        model = self.models[req.model_id]
        res = RequestResult(model_id=req.model_id, arrival=req.time, start=now,
                            warm=True, joined=True, queue_s=now - req.time,
                            concurrency=len(w.busy_instances()),
                            bytes_total=model.bytes, bytes_hit=model.bytes)
        res.prefill_s = self.costs.prefill_time(model.params, req.prompt_tokens,
                                                req.batch_size)
        output_tokens = self._run_kv(req, w, inst, res, model)
        res.decode_s = (self.costs.decode_time(model.bytes, output_tokens)
                        * res.concurrency + res.kv_overhead_s)
        inst.running += 1
        inst.batched_seqs += req.batch_size
        inst.last_used = now
        done = now + res.ttft - res.queue_s + res.decode_s
        inst.expected_free = max(inst.expected_free, done)
        self.results.append(res)
        if self.tracer.enabled:
            self._trace_result(res, w.device_id)
        self._push(done, "request_done",
                   (w.device_id, req.model_id, req.batch_size, inst.seq))

    def _trace_result(self, res: RequestResult, engine: str) -> None:
        """Emit the request's span family on the virtual trace clock
        (DESIGN.md §18).  The sim's priced phase durations double as their
        own cost-model predictions (queue is emergent, not priced), so
        ``span_cost_ratio`` pins at 1.0 here — any drift means a phase got
        billed into TTFT without being priced, or vice versa."""
        phases = [(name, getattr(res, f"{name}_s"))
                  for name in ("queue", "init", "load", "merge", "profile",
                               "prefill")]
        trace_request(self.tracer, rid=len(self.results) - 1,
                      model_id=res.model_id, arrival=res.arrival,
                      ttft=res.ttft, phases=phases, decode_s=res.decode_s,
                      cold=not res.warm, engine=engine,
                      preds={n: d for n, d in phases if n != "queue"})

    # ------------------------------------------------ live KV migration §16
    def migration_target(self, src: SimWorker, victim: WorkerInstance,
                         now: float) -> Optional[SimWorker]:
        """Deterministic peer choice for a handoff: the least-queued live
        worker with a free instance slot that can admit the moved weights
        + KV beside its pinned instances."""
        kv = src.kv_inflight_bytes(victim)
        peers = [w for w in self.workers
                 if w is not src and not w.failed and w.has_free_slot()
                 and w.can_admit(victim.weight_bytes, kv)]
        if not peers:
            return None
        return min(peers, key=lambda w: (w.expected_queue_delay(now),
                                         w.device_id))

    def _execute_migration(self, now: float, src: SimWorker):
        """Hand `src`'s blocking decode to a peer (DESIGN.md §16).  The
        source slot frees after the d2h snapshot stall; the moved batch
        finishes on the target after ship + restore + replay + the decode
        remainder.  Guards re-run (state may have moved since scoring); a
        no-longer-payable handoff silently degrades to plain queueing."""
        victim = src.migration_victim()
        if victim is None:
            return
        rem = victim.expected_free - now
        kv = src.kv_inflight_bytes(victim)
        if rem <= 0.0 or kv <= 0:
            return
        full = self.costs.migrate_time(
            kv, victim.weight_bytes,
            replay_tokens=self.policy.migrate_replay_tokens)
        if full >= rem:
            return
        target = self.migration_target(src, victim, now)
        if target is None:
            return
        stall = self.costs.migrate_stall(kv)
        model_id = victim.model_id
        batch = victim.batched_seqs
        # source: only the snapshot d2h holds the slot.  Bumping seq makes
        # every pending completion stale (the handler's stale-done guard);
        # the single replacement completion at the stall walks the normal
        # idle/keep-alive path, so lifecycle accounting stays one-for-one.
        victim.seq = next(src._seq)
        victim.running = 1
        victim.expected_free = now + stall
        self._push(now + stall, "request_done",
                   (src.device_id, model_id, batch, victim.seq))
        # target: adopt (or create) an instance and finish the decode there
        inst = target.instances.get(model_id)
        if inst is None:
            inst = WorkerInstance(model_id, victim.weight_bytes,
                                  next(target._seq))
            target.instances[model_id] = inst
        target.store.activate(model_id)
        done = now + full + max(0.0, rem - stall)
        inst.running += 1
        inst.batched_seqs += batch
        inst.last_used = now
        inst.expected_free = max(inst.expected_free, done)
        self._push(done, "request_done",
                   (target.device_id, model_id, batch, inst.seq))
        self.migrations += 1
        self.migrate_log.append((round(now, 6), model_id, src.device_id,
                                 target.device_id, round(stall, 6),
                                 round(done, 6)))
        if self.tracer.enabled:
            self.tracer.instant("migrate", now, track="cluster",
                                args={"model": model_id,
                                      "src": src.device_id,
                                      "dst": target.device_id})

    # ------------------------------------------------------------- main loop
    def inject_failure(self, time: float, worker_id: str,
                       recover_after: Optional[float] = None):
        """Schedule a node failure: the worker dies (pool wiped, in-flight
        request re-queued); optionally rejoins after `recover_after` seconds
        with a COLD pool — the elastic-scaling path."""
        self._push(time, "fail", (worker_id, recover_after))

    def run(self, trace: Sequence[Request], *,
            pressure: Sequence = ()) -> list[RequestResult]:
        for r in trace:
            self._push(r.time, "arrival", r)
        for p in pressure:
            # tenant-pressure feed (DESIGN.md §13): at p.time the co-located
            # tenants leave p.capacity_bytes of host memory to every node's
            # model-store tier
            self._push(p.time, "pressure", p.capacity_bytes)
        byid = {w.device_id: w for w in self.workers}
        while self._events:
            now, _, kind, payload = heapq.heappop(self._events)
            self.events_processed += 1
            if kind == "arrival":
                req: Request = payload
                self._record_access(req.model_id)
                if self.lifecycle is not None:
                    self.lifecycle.observe_arrival(req.model_id, now)
                if self.policy.concurrent:
                    # decode batching: join a running instance of the model
                    # when KV headroom and the batch cap allow it — but never
                    # ahead of a same-model request already waiting in that
                    # worker's queue
                    target = next((w for w in self.workers
                                   if w.can_join(self.models[req.model_id],
                                                 req.batch_size)
                                   and not w.has_waiter_for(req.model_id)),
                                  None)
                    if target is not None:
                        self._join_instance(
                            now, req, target,
                            target.instances[req.model_id])
                    else:
                        self.global_queue.append(req)
                        self._try_schedule(now)
                else:
                    # same-model busy worker with an empty queue -> dispatch
                    # to that engine; otherwise let the controller scale out
                    # another instance on a free worker (replica scaling)
                    target = next((w for w in self.workers
                                   if w.busy_model == req.model_id
                                   and not w.queue), None)
                    if target is not None and not any(
                            w.busy_model is None for w in self.workers):
                        self._enqueue_on_worker(target, req)
                    else:
                        self.global_queue.append(req)
                        self._try_schedule(now)
            elif kind == "request_done":
                wid, model_id, batch, seq = payload
                w = byid[wid]
                if getattr(w, "failed", False):
                    continue  # the node died mid-flight; request was re-queued
                inst = w.instances.get(model_id)
                if inst is None or inst.seq != seq:
                    continue  # instance wiped by a failure event (stale done)
                inst.running = max(0, inst.running - 1)
                inst.batched_seqs = max(0, inst.batched_seqs - batch)
                served = self._drain_worker_queue(now, w)
                # instance may have been terminated/replaced by the drain
                cur = w.instances.get(model_id)
                if cur is inst and inst.running == 0:
                    # keep-alive decision: the lifecycle manager's per-model
                    # TTL (scale-to-zero at <= 0) or the legacy fixed TTL
                    ttl = (self.lifecycle.on_idle(model_id, now)
                           if self.lifecycle is not None
                           else self.policy.keep_alive)
                    if ttl <= 0.0:
                        w.terminate_instance(model_id, now)
                        self._try_schedule(now)
                    else:
                        # arm the timer under a fresh idle epoch: a pending
                        # timer from an earlier idle period (instance warm-
                        # reused since, seq unchanged) must not fire and
                        # truncate THIS period's TTL
                        inst.idle_epoch += 1
                        self._push(now + ttl, "idle_expire",
                                   (w.device_id, model_id, inst.seq,
                                    inst.idle_epoch))
                if not served or self.policy.concurrent:
                    self._try_schedule(now)
            elif kind == "fail":
                wid, recover_after = payload
                w = byid[wid]
                if self.tracer.enabled:
                    # flight-recorder hook: the dump snapshots the span
                    # timeline that led into the node death
                    self.tracer.record_fault("engine.crash", now,
                                             args={"engine": wid})
                if self.lifecycle is not None:
                    for model in w.instances:  # node death scales all to zero
                        self.lifecycle.on_expire(model, now)
                # drop device state entirely
                w.instances = {}
                w.store = ReuseStore(w.capacity, self.costs,
                                     policy=(self.policy.alloc_policy
                                             if self.policy.reuse else "none"),
                                     indexed=w.indexed)
                if w.host_cache is not None:
                    # the node died: its host cache dies with it; recovery
                    # rejoins with a cold host tier backed by the store, at
                    # the CURRENT pressure budget (not the policy default).
                    # None = unbounded budget — int(None) would crash the
                    # fail handler exactly when a pressure wave lifted caps
                    w.host_cache = SimHostCache(
                        None if self._host_cap is None else
                        int(self._host_cap),
                        keep_alive_s=self.policy.host_keep_alive,
                        hint_ttl_s=self.policy.prefetch_ttl)
                    w.store.host_cache = w.host_cache
                w.failed = True
                # re-queue whatever the node had pending (its in-flight
                # instance died with it; accounting rows already recorded)
                while w.queue:
                    self.global_queue.append(w.queue.popleft())
                w.queued_work_s = 0.0
                if recover_after is not None:
                    self._push(now + recover_after, "recover", wid)
            elif kind == "recover":
                w = byid[payload]
                w.failed = False
                if self.tracer.enabled:
                    self.tracer.instant("engine.recover", now,
                                        track="faults",
                                        args={"engine": payload})
                # rejoin at the CURRENT budget in every policy: pressure
                # events during the downtime already hit this worker (the
                # pressure handler walks ALL workers), but re-applying here
                # is the explicit, idempotent guarantee the golden test pins
                w.store.set_host_capacity(self._host_cap)
                self._try_schedule(now)
            elif kind == "idle_expire":
                wid, model, seq, epoch = payload
                w = byid[wid]
                inst = w.instances.get(model)
                if (inst is not None and inst.running == 0
                        and inst.seq == seq and inst.idle_epoch == epoch
                        and not w.failed):
                    w.terminate_instance(model, now)
                    self._try_schedule(now)
            elif kind == "pressure":
                # co-located tenants resized the host tier on every node;
                # eviction-on-shrink happens inside the cache (LRU spill)
                if self.tracer.enabled:
                    self.tracer.instant("pressure", now, track="cluster",
                                        args={"capacity_bytes": payload})
                self._host_cap = payload
                for w in self.workers:
                    w.store.set_host_capacity(payload)
        return self.results


def summarize(results: Sequence[RequestResult]) -> dict[str, float]:
    import statistics as st

    if not results:
        return {}
    ttfts = sorted(r.ttft for r in results)
    makespan = max(r.done for r in results) - min(r.arrival for r in results)
    # typed snapshot (DESIGN.md §18): field order of ClusterSummaryStats IS
    # this rollup's legacy key order, so as_dict() is bit-identical to the
    # old literal
    return ClusterSummaryStats(
        n=len(results),
        ttft_mean=st.fmean(ttfts),
        ttft_p50=percentile(ttfts, 0.50),
        ttft_p99=percentile(ttfts, 0.99),
        load_mean=st.fmean(r.load_phase for r in results),
        warm_frac=sum(r.warm for r in results) / len(results),
        joined_frac=sum(r.joined for r in results) / len(results),
        reuse_frac_mean=st.fmean(r.reuse_fraction for r in results),
        bytes_from_store_total=sum(r.bytes_from_store for r in results),
        bytes_store_hidden_total=sum(r.bytes_store_hidden
                                     for r in results),
        prefetched_frac=sum(r.prefetched for r in results) / len(results),
        makespan=makespan,
        throughput_rps=len(results) / makespan if makespan > 0 else 0.0,
    ).as_dict()
