"""Reuse Store (§3.1): per-device tensor-level model reuse over the Unified
Memory Pool.

Maintains the Tensor Map (fingerprint -> resident region), plans loads
(hits vs misses), runs Stage-1 Minimal-Cost Eviction and Stage-2
Partitioned-Gain Packing, and returns a LoadReport with the byte/time
accounting the scheduler and benchmarks consume.

The Reuse Store is the *algorithm plane*: it tracks bytes and addresses
exactly.  The engine's *data plane* (`serving/engine.py`) holds the actual
jax.Arrays and consults the store for which tensors are resident.

Accounting is incremental (DESIGN.md §10): resident-byte totals are running
counters, the tensor map is additionally indexed per model so eviction
candidates come from iterating only *inactive* models (with the Eq. 2 cost
factor computed once per model, not once per tensor), and the allocate path
skips candidate generation entirely when the pool already has the free bytes.
`indexed=False` restores the original scan-everything behaviour over a
`NaiveRegionList` — the measured baseline for benchmarks/fig15_fastpath.py.

Cross-model dedup (DESIGN.md §17): entries are keyed by CONTENT-capable
fingerprints, so two model ids whose records carry the same fingerprint
(a fine-tune variant and its base) resolve to ONE resident tensor.  Each
entry tracks its *sharers* — the model ids currently claiming it — and
eviction counts sharers, not models: a tensor with any ACTIVE sharer is
never an eviction candidate, its Eq. 2 cost sums over all sharers (evicting
it costs every one of them a future re-transfer), and `drop_model` only
frees pool bytes when the LAST sharer departs.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

from repro_torch.core.allocator import (AllocationError, EvictionCandidate, NewTensor,
                                  apply_plan, global_merge_plan,
                                  minimal_cost_eviction, partitioned_gain_packing)
from repro_torch.core.costmodel import Hardware, PhaseCosts
from repro_torch.core.regions import NaiveRegionList, RegionList, RState
from repro_torch.models.tensors import ModelSpec, TensorRecord
from repro_torch.stats import DedupStats


@dataclass
class TensorEntry:
    record: TensorRecord
    model_id: str  # first loader (display/debug; ownership lives in sharers)
    offset: int
    last_access: float = 0.0
    hits: int = 0
    # model ids currently claiming this tensor (cross-model dedup §17):
    # populated by _admit with the loader, grown by _share on cross-model
    # hits, shrunk by drop_model — empty means the entry is being freed
    sharers: set[str] = field(default_factory=set)


@dataclass
class LoadReport:
    model_id: str
    bytes_total: int = 0
    bytes_hit: int = 0  # reused, no transfer
    bytes_transferred: int = 0  # host -> device
    # tier split of bytes_transferred (DESIGN.md §11): host-cache hits move
    # at h2d_bw, store-tier misses at min(h2d_bw, store_bw).  With no host
    # tier modeled, the legacy in_host_cache flag assigns all bytes to one.
    bytes_from_host: int = 0
    bytes_from_store: int = 0
    # prefetch overlap (DESIGN.md §12): store-tier bytes whose promotion was
    # hidden behind the hint->load window.  They still count in
    # bytes_from_store (the store read happened — overlap, not avoidance);
    # load_seconds prices them at h2d_bw instead of the store pipeline.
    bytes_store_hidden: int = 0
    prefetched: bool = False  # a prefetch hint covered this load
    bytes_evicted: int = 0
    bytes_merged: int = 0  # device-side compaction copies
    tensors_hit: int = 0
    tensors_loaded: int = 0
    compute_seconds: float = 0.0  # allocator planning wall time
    load_seconds: float = 0.0  # modeled transfer time
    merge_seconds: float = 0.0  # modeled compaction time

    @property
    def reuse_fraction(self) -> float:
        return self.bytes_hit / self.bytes_total if self.bytes_total else 0.0

    @property
    def total_seconds(self) -> float:
        return self.load_seconds + self.merge_seconds + self.compute_seconds


class ReuseStore:
    """One per accelerator (worker GPU / TPU slice)."""

    def __init__(self, capacity: int, costs: PhaseCosts, *,
                 policy: str = "mce+pgp", indexed: bool = True):
        assert policy in ("mce+pgp", "mce+gm", "rand+gm", "none")
        self.pool = RegionList(capacity) if indexed else NaiveRegionList(capacity)
        self.costs = costs
        self.policy = policy
        self.indexed = indexed
        self.tensor_map: dict[str, TensorEntry] = {}  # fingerprint -> entry
        self.active_models: set[str] = set()
        # simulated per-node host Model Store tier (core.hostcache.SimHostCache
        # or None).  When set, load_model prices each miss by the tier it
        # actually resolves from instead of the blanket in_host_cache flag.
        self.host_cache = None
        self.miss_prob: dict[str, float] = {}  # model_id -> p_m (from controller)
        self.alpha: dict[str, float] = {}  # model_id -> latency sensitivity
        self._rand_state = 0x9E3779B9
        # declarative registry (DESIGN.md §17): ModelSpec per model id, so
        # the pool knows each model's fingerprint policy/base lineage
        self.model_specs: dict[str, ModelSpec] = {}
        # incremental accounting (kept in lockstep with tensor_map).
        # _resident_total dedups (each fingerprint once); _resident_by_model
        # is the per-sharer logical view (a shared tensor counts for every
        # sharer), so their sum can exceed the total under dedup.
        self._resident_total = 0
        self._resident_by_model: dict[str, int] = {}
        self._model_tensors: dict[str, dict[str, TensorEntry]] = {}

    # -------------------------------------------------------------- registry
    def register_model(self, spec: Union[ModelSpec, str]) -> ModelSpec:
        """Record a model's declarative identity (idempotent).  A bare id
        registers under the identity policy."""
        if not isinstance(spec, ModelSpec):
            spec = ModelSpec(spec)
        self.model_specs[spec.model_id] = spec
        return spec

    # ----------------------------------------------------------------- stats
    def resident_bytes(self, model_id: Optional[str] = None) -> int:
        if self.indexed:
            if model_id is None:
                return self._resident_total
            return self._resident_by_model.get(model_id, 0)
        return sum(e.record.nbytes for e in self.tensor_map.values()
                   if model_id is None or model_id in e.sharers)

    def dedup_stats(self) -> DedupStats:
        """Cross-model sharing ledger (repro.stats schema).  sharer_orphans
        counts resident entries with an EMPTY sharer set — a refcount bug,
        gated to zero by scripts/check_bench.py."""
        shared_b = shared_t = orphans = 0
        for e in self.tensor_map.values():
            if len(e.sharers) >= 2:
                shared_b += e.record.nbytes
                shared_t += 1
            elif not e.sharers:
                orphans += 1
        logical = (sum(self._resident_by_model.values()) if self.indexed
                   else sum(e.record.nbytes * len(e.sharers)
                            for e in self.tensor_map.values()))
        return DedupStats(unique_bytes=self.resident_bytes(),
                          logical_bytes=logical, shared_bytes=shared_b,
                          shared_tensors=shared_t, sharer_orphans=orphans)

    def reusable_bytes(self, records: Sequence[TensorRecord]) -> int:
        """S' in Eq. 3: bytes of `records` already resident here."""
        return sum(r.nbytes for r in records if r.fingerprint in self.tensor_map)

    def free_bytes(self) -> int:
        return self.pool.free_bytes()

    # ------------------------------------------------------------- lifecycle
    def activate(self, model_id: str):
        self.active_models.add(model_id)

    def release(self, model_id: str):
        """Instance terminated: tensors STAY resident (the paper's key idea)."""
        self.active_models.discard(model_id)

    def drop_model(self, model_id: str) -> int:
        """Drop a model's CLAIM on its resident tensors.  A tensor shared
        with another resident model (cross-model dedup §17) survives under
        its remaining sharers; pool bytes free only when the LAST sharer
        departs — evicting one variant never invalidates another.  Returns
        the bytes actually freed."""
        freed = 0
        for fp, e in list(self._model_tensors.get(model_id, {}).items()):
            e.sharers.discard(model_id)
            self._unregister(model_id, fp, e.record.nbytes)
            if not e.sharers:
                del self.tensor_map[fp]
                self.pool.free(e.offset)
                self._resident_total -= e.record.nbytes
                freed += e.record.nbytes
        return freed

    def set_host_capacity(self, capacity_bytes) -> int:
        """Tenant-pressure feed (serverless control plane): resize this
        node's host Model Store tier.  The device pool is untouched —
        co-located tenants contend for HOST memory; accelerator memory stays
        the LLM worker's.  No-op (0) without a modeled host cache."""
        if self.host_cache is None:
            return 0
        return self.host_cache.set_capacity_bytes(capacity_bytes)

    def _register(self, model_id: str, entry: TensorEntry):
        self._resident_by_model[model_id] = (
            self._resident_by_model.get(model_id, 0) + entry.record.nbytes)
        self._model_tensors.setdefault(model_id, {})[
            entry.record.fingerprint] = entry

    def _unregister(self, model_id: str, fp: str, nbytes: int):
        owned = self._model_tensors[model_id]
        del owned[fp]
        if owned:  # dict emptiness, not byte count (zero-size tensors exist)
            self._resident_by_model[model_id] -= nbytes
        else:
            del self._resident_by_model[model_id]
            del self._model_tensors[model_id]

    def _admit(self, entry: TensorEntry):
        if entry.record.fingerprint in self.tensor_map:
            # re-admission without a drop (policy="none" reload): release the
            # stale copy so counters and the pool stay exact
            self._evict(entry.record.fingerprint)
        if not entry.sharers:
            entry.sharers.add(entry.model_id)
        self.tensor_map[entry.record.fingerprint] = entry
        self._resident_total += entry.record.nbytes
        for model_id in entry.sharers:
            self._register(model_id, entry)

    def _share(self, model_id: str, entry: TensorEntry):
        """A load by `model_id` hit a tensor admitted under another model id
        (cross-model dedup): record the claim so eviction refcounting and
        the per-model resident view count SHARERS, not first owners."""
        if model_id in entry.sharers:
            return
        entry.sharers.add(model_id)
        self._register(model_id, entry)

    def _evict(self, fp: str) -> int:
        e = self.tensor_map.pop(fp)
        self.pool.free(e.offset)
        self._resident_total -= e.record.nbytes
        for model_id in e.sharers:
            self._unregister(model_id, fp, e.record.nbytes)
        e.sharers.clear()
        return e.record.nbytes

    # ------------------------------------------------------- eviction costs
    def _factor(self, model_id: str) -> float:
        # Eq. 2: c_j = p_m * (s_j / b_m) * alpha_m — the per-model factor is
        # constant across the model's tensors
        return self.costs.eviction_cost(1.0,
                                        self.miss_prob.get(model_id, 1.0),
                                        self.alpha.get(model_id, 1.0))

    def _candidates(self) -> list[EvictionCandidate]:
        cands = []
        seen: set[str] = set()  # shared tensors must yield ONE candidate
        factors: dict[str, float] = {}
        for model_id, owned in self._model_tensors.items():
            if model_id in self.active_models:
                continue
            if self.policy == "rand+gm":
                for fp, e in owned.items():
                    if fp in seen or e.sharers & self.active_models:
                        continue
                    seen.add(fp)
                    # pseudo-random cost (baseline "Rand")
                    self._rand_state = (self._rand_state * 1103515245 + 12345) & 0x7FFFFFFF
                    cands.append(EvictionCandidate(fp, e.offset, e.record.nbytes,
                                                   float(self._rand_state)))
            else:
                if model_id not in factors:
                    factors[model_id] = self._factor(model_id)
                factor = factors[model_id]
                for fp, e in owned.items():
                    if fp in seen:
                        continue
                    if len(e.sharers) == 1:
                        cost = factor * e.record.nbytes
                    else:
                        # sharer-aware Eq. 2 (§17): a tensor with any ACTIVE
                        # sharer is untouchable; otherwise evicting it costs
                        # every sharer a future re-transfer, so the costs sum
                        if e.sharers & self.active_models:
                            continue
                        cost = e.record.nbytes * sum(
                            factors.setdefault(m, self._factor(m))
                            for m in e.sharers)
                    seen.add(fp)
                    cands.append(EvictionCandidate(fp, e.offset,
                                                   e.record.nbytes, cost))
        return cands

    def _has_candidates(self) -> bool:
        for model_id, owned in self._model_tensors.items():
            if model_id in self.active_models:
                continue
            for e in owned.values():
                if not (e.sharers & self.active_models):
                    return True
        return False

    # ------------------------------------------------------------------ load
    def plan_load(self, records: Sequence[TensorRecord]):
        hits = [r for r in records if r.fingerprint in self.tensor_map]
        misses = [r for r in records if r.fingerprint not in self.tensor_map]
        return hits, misses

    def hint_prefetch(self, model_id: str, records: Sequence[TensorRecord],
                      now: float):
        """Affinity hint (DESIGN.md §12): placement chose this device, so the
        node starts promoting the model's store-resident tensors into its
        host tier NOW — the read overlaps queueing/init instead of extending
        the load.  No-op without a modeled host cache."""
        if self.host_cache is not None:
            misses = [r for r in records
                      if r.fingerprint not in self.tensor_map]
            self.host_cache.prefetch(model_id, misses, now)

    def load_model(self, model_id: str, records: Sequence[TensorRecord], *,
                   now: float = 0.0, in_host_cache: bool = True,
                   overlap_s: float = 0.0) -> LoadReport:
        """Load a model: reuse hits, evict/pack/transfer misses.  §3.1 + §3.2.

        `overlap_s`: hideable wall seconds between the load landing and its
        own h2d starting (the Init phase, for the simulator) — a pending
        prefetch hint adds its hint->load elapsed on top and clips the
        modeled store time (`PhaseCosts.load_time_prefetched`)."""
        t0 = _time.perf_counter()
        rep = LoadReport(model_id=model_id,
                         bytes_total=sum(r.nbytes for r in records))
        if self.policy == "none":
            # exclusive baseline (SLLM): nothing resident between instances
            hits, misses = [], list(records)
        else:
            hits, misses = self.plan_load(records)

        for r in hits:
            e = self.tensor_map[r.fingerprint]
            e.last_access, e.hits = now, e.hits + 1
            # cross-model dedup (§17): a hit on a tensor another model id
            # admitted (variant hitting its base's leaves) claims shared
            # ownership, so eviction refcounting counts this load too
            self._share(model_id, e)
            rep.bytes_hit += r.nbytes
        rep.tensors_hit = len(hits)

        if misses:
            # content fingerprints can repeat WITHIN one record set (tied
            # weights): allocate/transfer each fingerprint once; later
            # occurrences are hits-by-admission
            uniq, seen_fp = [], set()
            for r in misses:
                if r.fingerprint in seen_fp:
                    rep.bytes_hit += r.nbytes
                    rep.tensors_hit += 1
                else:
                    seen_fp.add(r.fingerprint)
                    uniq.append(r)
            misses = uniq
            need = sum(r.nbytes for r in misses)
            new_tensors = [NewTensor(r.fingerprint, r.nbytes) for r in misses]
            placed = self._allocate(model_id, new_tensors, need, rep)
            for r in misses:
                self._admit(TensorEntry(record=r, model_id=model_id,
                                        offset=placed[r.fingerprint],
                                        last_access=now, hits=0))
            rep.bytes_transferred = need
            rep.tensors_loaded = len(misses)

        self.activate(model_id)
        rep.compute_seconds = _time.perf_counter() - t0
        if self.host_cache is not None:
            # the hint must be consumed BEFORE plan_fetch admits this
            # load's store misses — `covered` is the bytes the background
            # read could actually have promoted (absent at hint time AND
            # still absent now)
            taken = self.host_cache.take_prefetch(model_id, now, misses)
            # tier-aware Eq. 3: the simulated host tier resolves each missed
            # tensor, admitting store-tier fetches (and LRU-spilling others)
            rep.bytes_from_host, rep.bytes_from_store = \
                self.host_cache.plan_fetch(misses, now=now)
            if taken is None or not misses or not taken[1]:
                # the hint is consumed either way, but a load it covered no
                # bytes of (nothing moved, or the snapshot held none of the
                # misses) was not helped — prefetched_frac must count only
                # loads the overlap could actually touch
                rep.load_seconds = self.costs.load_time_tiered(
                    rep.bytes_from_host, rep.bytes_from_store)
            else:
                # overlap-aware pricing: the store read started at hint time
                # and keeps running through the worker-queue wait (elapsed)
                # and the Init phase (overlap_s) — tier byte counters are
                # untouched, only the wall time shrinks, and only for the
                # bytes the hint's snapshot covered (a stale hint cannot
                # hide tensors that spilled after it fired)
                elapsed, covered = taken
                window = elapsed + overlap_s
                rep.prefetched = True
                rep.bytes_store_hidden = int(min(
                    self.costs.prefetch_hidden_bytes(
                        rep.bytes_from_host, rep.bytes_from_store, window),
                    covered))
                rep.load_seconds = self.costs.load_time_prefetched(
                    rep.bytes_from_host, rep.bytes_from_store, window,
                    hidden_cap=covered)
        else:
            if in_host_cache:
                rep.bytes_from_host = rep.bytes_transferred
            else:
                rep.bytes_from_store = rep.bytes_transferred
            rep.load_seconds = self.costs.load_time(rep.bytes_transferred,
                                                    in_host_cache=in_host_cache)
        rep.merge_seconds = self.costs.merge_time(rep.bytes_merged)
        return rep

    def _allocate(self, model_id: str, new_tensors: list[NewTensor], need: int,
                  rep: LoadReport) -> dict[str, int]:
        """Stage 1 (MCE) + Stage 2 (PGP or GlobalMerge), with retry-on-fragmentation."""
        for attempt in range(8):
            target = need + attempt * (need // 4)
            if self.indexed and self.pool.free_bytes() >= target:
                evictions = []  # MCE is a no-op: skip candidate generation
            else:
                evictions = minimal_cost_eviction(self.pool, self._candidates(),
                                                  target)
            for ev in evictions:
                rep.bytes_evicted += self._evict(ev.fingerprint)
            try:
                if self.policy in ("mce+gm", "rand+gm"):
                    plan = global_merge_plan(self.pool, new_tensors)
                else:
                    plan = partitioned_gain_packing(self.pool, new_tensors)
                moved, relocations, placed = apply_plan(self.pool, plan)
                rep.bytes_merged += moved
                for owner, new_off in relocations.items():
                    if owner in self.tensor_map:
                        self.tensor_map[owner].offset = new_off
                return placed
            except AllocationError:
                if not self._has_candidates():
                    raise
                continue
        raise AllocationError(f"could not place {need}B for {model_id}")

    # ------------------------------------------------ urgent KV reclamation
    def urgent_reclaim(self, need: int) -> int:
        """§3.3: decode needs KV blocks NOW — MCE-evict without any merging."""
        try:
            evictions = minimal_cost_eviction(self.pool, self._candidates(), need)
        except AllocationError:
            evictions = self._candidates()  # free everything reachable
        return sum(self._evict(ev.fingerprint) for ev in evictions)

    def urgent_reclaim_contiguous(self, block_bytes: int) -> bool:
        """Create one contiguous free hole >= block_bytes for a KV block.

        Pure MCE evicts the *cheapest* (typically smallest) tensors first,
        which can leave only sub-block holes.  This pass instead picks the
        window of consecutive (free | evictable-tensor) regions whose total
        size reaches block_bytes at minimal eviction cost, and evicts exactly
        that window.  Two-pointer / O(n): costs are non-negative, so for each
        window end the cheapest satisfying window is the shortest one — the
        left pointer only ever advances.  Beyond-paper refinement, documented
        in DESIGN.md §3.
        """
        cand_cost = {c.fingerprint: c.cost for c in self._candidates()}
        regions = self.pool.regions
        best: Optional[tuple[float, int, int]] = None  # (cost, i, j)
        i = 0
        size = 0
        cost = 0.0
        for j, r in enumerate(regions):
            if r.state == RState.FREE:
                size += r.size
            elif r.state == RState.TENSOR and r.owner in cand_cost:
                size += r.size
                cost += cand_cost[r.owner]
            else:
                # active/pinned region breaks the window: restart past it
                i, size, cost = j + 1, 0, 0.0
                continue
            # shrink: drop left regions the window no longer needs
            while size - regions[i].size >= block_bytes:
                left = regions[i]
                size -= left.size
                if left.state == RState.TENSOR:
                    cost -= cand_cost[left.owner]
                i += 1
            if size >= block_bytes and (best is None or cost < best[0]):
                best = (cost, i, j)
        if best is None:
            return False
        _, i, j = best
        for r in list(regions[i : j + 1]):
            if r.state == RState.TENSOR and r.owner in cand_cost:
                self._evict(r.owner)
        return True
