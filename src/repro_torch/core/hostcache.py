"""Simulated per-node host Model Store tier for the cost plane.

Algorithm-plane mirror of `models.tensors.HostTensorStore` (DESIGN.md §11):
a bounded LRU over fingerprints and byte sizes, one per simulated worker
node.  The cluster simulator consults it at load time to split transferred
bytes into host-cache hits (streamed at `h2d_bw`) and persistent-store
misses (paying Eq. 3's `min(h2d_bw, store_bw)` through the overlapped
pipeline), and the affinity scheduler queries it so t_load estimates
reflect host misses, not just device-pool misses.

Two additions for the prefetch pipeline (DESIGN.md §12):

  * **In-flight promotions** — `prefetch(model_id, records, now)` records
    that a store->host read for the model's absent tensors started at the
    hint time.  The bytes are NOT admitted early (store-byte counters stay
    identical to the unhinted run — overlap, not avoidance); the pending
    hint only tells `take_prefetch` how long the read has already been
    running when the load lands, which clips the modeled store time.
  * **Aging** — with `keep_alive_s` set, tensors idle longer than the TTL
    are spilled on the next access sweep, modeling keep-alive expiry /
    host-memory churn from co-located tenants instead of a static cache.

Byte accounting is incremental (a counter, never a scan), matching the
data-plane store's contract.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

from repro_torch.models.tensors import TensorRecord
from repro_torch.stats import HostStoreStats


class SimHostCache:
    """Bounded LRU of host-cached tensors, keyed by fingerprint."""

    def __init__(self, capacity_bytes: Optional[int] = None, *,
                 keep_alive_s: Optional[float] = None,
                 hint_ttl_s: Optional[float] = None):
        self._res: "OrderedDict[str, int]" = OrderedDict()  # fp -> nbytes, LRU
        self.capacity_bytes = capacity_bytes
        self.keep_alive_s = keep_alive_s
        # hints older than this are dead at consumption: the placement they
        # belonged to was dropped or served warm, and crediting a later
        # unrelated load with their (long-finished) read would overstate
        # the overlap.  None = never expire (unit-test determinism).
        self.hint_ttl_s = hint_ttl_s
        self._last: dict[str, float] = {}  # fp -> last access (aging clock)
        # model_id -> (hint time, fps absent from the host tier at the hint)
        self._pending: dict[str, tuple[float, frozenset[str]]] = {}
        self._nbytes = 0
        self.evictions = 0  # cumulative host -> store spills
        self.bytes_spilled = 0
        self.bytes_fetched = 0  # cumulative store -> host promotions
        self.expirations = 0  # cumulative TTL-aged spills (subset of evictions)
        self.pressure_evictions = 0  # spills forced by set_capacity_bytes

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._res

    def __len__(self) -> int:
        return len(self._res)

    def nbytes(self) -> int:
        return self._nbytes

    def snapshot(self) -> HostStoreStats:
        """Typed counter snapshot (repro.stats schema, DESIGN.md §17) —
        the same shape the real plane's `HostTensorStore.snapshot` fills;
        fields the sim tier does not track stay at their zero defaults."""
        return HostStoreStats(
            resident_bytes=self._nbytes,
            evictions=self.evictions,
            bytes_spilled=self.bytes_spilled,
            bytes_fetched=self.bytes_fetched,
            expirations=self.expirations,
            pressure_evictions=self.pressure_evictions)

    def host_resident_bytes(self, records: Sequence[TensorRecord]) -> int:
        """Bytes of `records` currently in this node's host tier (read-only:
        no recency touch — scoring a candidate is not an access)."""
        return sum(r.nbytes for r in records if r.fingerprint in self._res)

    # ------------------------------------------------------ tenant pressure
    def set_capacity_bytes(self, capacity_bytes: Optional[int]) -> int:
        """Resize the host-tier byte budget (serverless control plane: the
        tenant-pressure feed squeezing this node's host memory).  Shrinking
        below the resident set LRU-spills immediately — the co-located
        tenant takes the pages NOW, not at the next load.  The sim cache has
        no pin concept (the data-plane `HostTensorStore` enforces pin
        exemption); growth just raises the cap.  Returns bytes spilled."""
        self.capacity_bytes = capacity_bytes
        spilled = 0
        if capacity_bytes is not None:
            while self._nbytes > capacity_bytes and self._res:
                fp = next(iter(self._res))  # oldest = LRU order
                spilled += self._res[fp]
                self._evict(fp)
                self.pressure_evictions += 1
        return spilled

    # ------------------------------------------------------------- prefetch
    def prefetch(self, model_id: str, records: Sequence[TensorRecord],
                 now: float):
        """Affinity hint (DESIGN.md §12): the node starts promoting the
        model's tensors ABSENT from the host tier at `now` — that snapshot
        is what the background read covers, mirroring the real plane's
        spilled-set snapshot.  Replaces any stale hint for the model."""
        absent = frozenset(r.fingerprint for r in records
                           if r.fingerprint not in self._res)
        self._pending[model_id] = (now, absent)

    def cancel_prefetch(self, model_id: str) -> bool:
        """Withdraw a pending hint (the placement it belonged to expired or
        was re-routed): the background read stops crediting overlap to any
        later load.  Sim mirror of `Engine.cancel_prefetch`.  Returns True
        when a hint was actually pending."""
        return self._pending.pop(model_id, None) is not None

    def take_prefetch(self, model_id: str, now: float,
                      records: Sequence[TensorRecord] = ()
                      ) -> Optional[tuple[float, int]]:
        """Consume the model's pending hint.  Returns (elapsed, covered):
        seconds the background read has been running when the load lands,
        and the bytes of `records` the hint's snapshot covers that are
        STILL absent from the host tier (the only bytes the read can have
        hidden — tensors that spilled after the hint were never part of
        it).  None without a hint.  Call BEFORE `plan_fetch` admits the
        load's own store misses."""
        hint = self._pending.pop(model_id, None)
        if hint is None:
            return None
        t0, absent = hint
        elapsed = max(0.0, now - t0)
        if self.hint_ttl_s is not None and elapsed > self.hint_ttl_s:
            return None  # stale hint: its placement never followed through
        covered = sum(r.nbytes for r in records
                      if r.fingerprint in absent
                      and r.fingerprint not in self._res)
        return elapsed, covered

    # ---------------------------------------------------------------- aging
    def age(self, now: float) -> int:
        """TTL sweep: spill tensors idle longer than `keep_alive_s`.  Lazy —
        called from `plan_fetch` on each load, the only point whose pricing
        the cache state feeds.  Returns the number of expired tensors."""
        if self.keep_alive_s is None:
            return 0
        expired = [fp for fp, t in self._last.items()
                   if now - t > self.keep_alive_s and fp in self._res]
        for fp in expired:
            self._evict(fp)
            self.expirations += 1
        return len(expired)

    def plan_fetch(self, records: Sequence[TensorRecord],
                   now: Optional[float] = None) -> tuple[int, int]:
        """Resolve a load's missed tensors through the host tier.

        Host-resident records are touched (LRU recency); absent ones are
        promoted from the persistent store and admitted, LRU-evicting other
        tensors if the cap demands it — the records being fetched are
        themselves exempt from this round's eviction (they are pinned by the
        in-flight transfer).  With `now` given, TTL-expired tensors are aged
        out first and touched tensors get fresh timestamps.  Returns
        (host_hit_bytes, store_bytes).
        """
        if now is not None:
            self.age(now)
        host_bytes = 0
        store_bytes = 0
        fetched = set()
        for r in records:
            if r.fingerprint in self._res:
                self._res.move_to_end(r.fingerprint)
                host_bytes += r.nbytes
            else:
                self._res[r.fingerprint] = r.nbytes
                self._res.move_to_end(r.fingerprint)
                self._nbytes += r.nbytes
                store_bytes += r.nbytes
                self.bytes_fetched += r.nbytes
            if now is not None:
                self._last[r.fingerprint] = now
            fetched.add(r.fingerprint)
        if self.capacity_bytes is not None and self._nbytes > self.capacity_bytes:
            for fp in [fp for fp in self._res if fp not in fetched]:
                if self._nbytes <= self.capacity_bytes:
                    break
                self._evict(fp)
        return host_bytes, store_bytes

    def _evict(self, fp: str):
        size = self._res.pop(fp)
        self._last.pop(fp, None)
        self._nbytes -= size
        self.evictions += 1
        self.bytes_spilled += size
