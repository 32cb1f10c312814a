"""Cost model: transfer bandwidths, phase latencies, eviction cost (Eq. 2),
and load-time estimation (Eq. 3).

Two hardware profiles:
  * `paper_l40()` — calibrated to the paper's single-L40 testbed (Fig. 2/8),
    used by the benchmark simulations so the reproduced figures are comparable.
  * `tpu_v5e()` — the TPU target this repo adapts the system to; used by the
    roofline analysis (197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s/link ICI).

All times in seconds, sizes in bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class Hardware:
    name: str
    device_mem: float  # usable accelerator memory for the Unified Memory Pool
    h2d_bw: float  # host cache -> device (paper: PCIe; TPU: host DMA)
    store_bw: float  # persistent store -> host cache (SSD)
    d2d_bw: float  # on-device copy bandwidth (merge/compaction)
    flops: float  # dense bf16 peak
    hbm_bw: float  # device memory bandwidth
    ici_bw: float = 0.0  # per-link interconnect (TPU)


def paper_l40() -> Hardware:
    # Effective (not peak) rates, calibrated so SLLM's GPT-20B Load ~= 8 s
    # and Table-1 decode throughputs land in the reported range.
    return Hardware(name="l40", device_mem=45e9, h2d_bw=5.0e9, store_bw=3.2e9,
                    d2d_bw=300e9, flops=90e12, hbm_bw=700e9)


def tpu_v5e() -> Hardware:
    return Hardware(name="tpu_v5e", device_mem=16e9, h2d_bw=25e9, store_bw=3.2e9,
                    d2d_bw=400e9, flops=197e12, hbm_bw=819e9, ici_bw=50e9)


@dataclass
class PhaseCosts:
    """Multi-phase initialization latencies (§2.2), per optimization level.

    Flags mirror the paper's baselines: criu kills most of Init; medusa
    (offline materialization) kills Profile; Tangram reuses tensors in Load.
    """

    hw: Hardware
    criu: bool = False
    medusa: bool = False

    # calibration constants (fit to Fig. 2's GPT-20B breakdown)
    init_base: float = 4.5
    init_criu: float = 0.55
    profile_base: float = 1.3
    profile_per_gb: float = 0.045
    profile_medusa: float = 0.05
    kernel_launch: float = 0.45  # lazy CUDA kernel load during Prefill
    decode_step_overhead: float = 0.020
    # chaos-plane retry policy (DESIGN.md §15): the same capped exponential
    # backoff schedule `HostTensorStore.fetch` sleeps on the real plane
    retry_backoff_base: float = 0.01
    retry_backoff_cap: float = 0.08

    # ------------------------------------------------------------- phases
    def init_time(self, model_bytes: float) -> float:
        return self.init_criu if self.criu else self.init_base + 0.02 * model_bytes / 1e9

    def load_time(self, missing_bytes: float, *, in_host_cache: bool = True) -> float:
        """Eq. 3 with the SLLM overlapped pipeline: the slower medium wins."""
        bw = self.hw.h2d_bw if in_host_cache else min(self.hw.h2d_bw, self.hw.store_bw)
        return missing_bytes / bw

    def load_time_tiered(self, host_bytes: float, store_bytes: float) -> float:
        """Eq. 3 split by source tier (DESIGN.md §11): bytes resident in the
        host cache stream at `h2d_bw`; bytes spilled to the persistent store
        go through the overlapped store->host->device pipeline, where the
        slower medium wins (`min(h2d_bw, store_bw)`)."""
        slow = min(self.hw.h2d_bw, self.hw.store_bw)
        return host_bytes / self.hw.h2d_bw + store_bytes / slow

    # ----------------------------------------------- chaos-plane retries
    def retry_backoff_time(self, attempts: int = 1) -> float:
        """Wall seconds the capped exponential backoff sleeps across
        `attempts` retried reads (the schedule `HostTensorStore.fetch`
        executes: base, 2x base, ... capped)."""
        return sum(min(self.retry_backoff_cap,
                       self.retry_backoff_base * (2 ** k))
                   for k in range(max(0, attempts)))

    def store_retry_time(self, nbytes: float, attempts: int = 1) -> float:
        """Modeled cost of `attempts` transient store-read failures over an
        `nbytes` promotion: each failed attempt re-reads at `store_bw` and
        sleeps its backoff slot (DESIGN.md §15) — what the modeled fleet
        plane adds to `load_seconds` when its ``store.read`` point fires."""
        return (attempts * nbytes / self.hw.store_bw
                + self.retry_backoff_time(attempts))

    # -------------------------------------------- prefetch overlap (§12)
    def prefetch_hidden_bytes(self, host_bytes: float, store_bytes: float,
                              overlap_s: float) -> float:
        """Store-tier bytes whose promotion completes before the load would
        reach them (DESIGN.md §12).  The store read starts at hint time and
        keeps running for `overlap_s` wall seconds (queueing at the worker +
        Init) plus the time the load spends streaming host-resident bytes —
        every byte promoted inside that window behaves like a host hit."""
        window = max(0.0, overlap_s) + host_bytes / self.hw.h2d_bw
        return min(store_bytes, window * self.hw.store_bw)

    def load_time_prefetched(self, host_bytes: float, store_bytes: float,
                             overlap_s: float,
                             hidden_cap: Optional[float] = None) -> float:
        """Overlap-aware Eq. 3 (DESIGN.md §12): a prefetch hint issued
        `overlap_s` seconds of hideable work before the load's own h2d
        begins clips the store read by that window.  Hidden bytes stream at
        `h2d_bw` (they are host-resident when the load reaches them); the
        remainder still pays the overlapped `min(h2d_bw, store_bw)`
        pipeline.  The hinted read ALSO overlaps the h2d of host-resident
        bytes (the serial tiered pipeline never does), so with host bytes
        present this prices below `load_time_tiered` even at overlap 0;
        equality holds only at (host_bytes=0, overlap 0), and the price
        floors at the all-host load as the window grows.  `hidden_cap`
        bounds the hidden bytes to what the hint's snapshot actually
        covered (a stale hint cannot hide tensors that spilled after it
        fired)."""
        hidden = self.prefetch_hidden_bytes(host_bytes, store_bytes, overlap_s)
        if hidden_cap is not None:
            hidden = min(hidden, max(0.0, hidden_cap))
        slow = min(self.hw.h2d_bw, self.hw.store_bw)
        return ((host_bytes + hidden) / self.hw.h2d_bw
                + (store_bytes - hidden) / slow)

    # ----------------------------------------- predictive pre-warm (§14)
    def prewarm_cost(self, store_bytes: float,
                     displaced_bytes: float = 0.0) -> float:
        """Shared-resource seconds a speculative pre-warm takes from
        co-located tenants (DESIGN.md §14): the store-bandwidth slot its
        promotion occupies, plus the re-promotion debt of host bytes it
        displaces (each displaced byte must come back through the
        overlapped ``min(h2d_bw, store_bw)`` pipeline if its model
        re-arrives)."""
        slow = min(self.hw.h2d_bw, self.hw.store_bw)
        return store_bytes / self.hw.store_bw + displaced_bytes / slow

    def prewarm_net_benefit(self, saved_s: float, prob: float,
                            store_bytes: float,
                            displaced_bytes: float = 0.0) -> float:
        """Expected seconds a pre-warm wins: cold-start seconds saved if
        the predicted arrival lands (discounted by its probability) minus
        the resource seconds the speculation costs whether or not it does.
        The fleet pre-warms only when this is positive."""
        return prob * saved_s - self.prewarm_cost(store_bytes,
                                                  displaced_bytes)

    # ------------------------------------------- live KV migration (§16)
    def migrate_time(self, kv_bytes: float, model_bytes: float = 0.0,
                     replay_tokens: int = 0) -> float:
        """End-to-end decode-handoff price (DESIGN.md §16): snapshot the
        live KV pages to the host tier (d2h), ship the blob to the target's
        host tier over the store path (the same ChunkedTransfer/host-store
        machinery model loads ride), restore onto the target pool (h2d),
        then replay the <=K tokens the source generated during the snapshot
        window.  The target must hold the model's weights for replay, so
        callers add its (usually warm) load price separately."""
        d2h = kv_bytes / self.hw.h2d_bw
        ship = kv_bytes / min(self.hw.h2d_bw, self.hw.store_bw)
        h2d = kv_bytes / self.hw.h2d_bw
        replay = replay_tokens * self.decode_step_time(model_bytes)
        return d2h + ship + h2d + replay

    def migrate_stall(self, kv_bytes: float) -> float:
        """Seconds the SOURCE device stays occupied during a handoff: only
        the d2h snapshot holds its pool pages; transfer/restore/replay run
        on the host path and the target.  This is what an arrival waiting
        on the source actually queues behind when the scheduler chooses
        migrate over wait-out-the-decode."""
        return kv_bytes / self.hw.h2d_bw

    def merge_time(self, moved_bytes: float) -> float:
        return moved_bytes / self.hw.d2d_bw

    def profile_time(self, model_bytes: float) -> float:
        if self.medusa:
            return self.profile_medusa
        return self.profile_base + self.profile_per_gb * model_bytes / 1e9

    def prefill_time(self, model_params: float, prompt_tokens: int,
                     batch_size: int = 1) -> float:
        flops = 2.0 * model_params * prompt_tokens * batch_size
        mfu = 0.4
        return self.kernel_launch + flops / (self.hw.flops * mfu)

    def decode_step_time(self, model_bytes: float) -> float:
        """Memory-bound decode: weights streamed once per step + overhead."""
        return self.decode_step_overhead + model_bytes / self.hw.hbm_bw

    def decode_time(self, model_bytes: float, out_tokens: int) -> float:
        return out_tokens * self.decode_step_time(model_bytes)

    # --------------------------------------------------- Eq. 2 eviction cost
    def eviction_cost(self, tensor_bytes: float, miss_prob: float,
                      alpha: float = 1.0) -> float:
        return miss_prob * (tensor_bytes / self.hw.h2d_bw) * alpha


def estimate_load_time(model_bytes: float, reusable_bytes: float,
                       hw: Hardware, *, in_host_cache: bool = True) -> float:
    """Eq. 3: t_load = (S - S') / B with overlapped store->cache->device."""
    bw = hw.h2d_bw if in_host_cache else min(hw.h2d_bw, hw.store_bw)
    return max(0.0, model_bytes - reusable_bytes) / bw


def estimate_load_time_tiered(model_bytes: float, device_reusable: float,
                              host_resident: float, hw: Hardware) -> float:
    """Tier-aware Eq. 3: of the (S - S') bytes the device pool misses,
    `host_resident` stream at `h2d_bw` and the rest must come up from the
    persistent store at `min(h2d_bw, store_bw)`.  This is the t_load the
    affinity scheduler scores once per-node host caches are modeled — a
    device whose host tier already caches the missing tensors beats one
    that must promote them, even at equal device-pool reuse.

    Under cross-model dedup (DESIGN.md §17) every input is fingerprint-
    derived, so the estimate is dedup-aware for free: a variant's records
    carry its base's fingerprints for shared leaves, `device_reusable` /
    `host_resident` count those as resident wherever the BASE is warm, and
    the score steers the variant toward base-warm nodes with only its
    delta bytes left to move."""
    missing = max(0.0, model_bytes - device_reusable)
    host = min(max(0.0, host_resident), missing)
    store = missing - host
    return host / hw.h2d_bw + store / min(hw.h2d_bw, hw.store_bw)


def unique_bytes(records) -> int:
    """Byte footprint of a record set counting each fingerprint ONCE — the
    `S` a dedup-aware pool actually stores/moves.  Differs from
    `sum(r.nbytes)` only when fingerprints repeat within the set (tied
    weights under a content policy)."""
    seen: set = set()
    total = 0
    for r in records:
        if r.fingerprint not in seen:
            seen.add(r.fingerprint)
            total += r.nbytes
    return total
