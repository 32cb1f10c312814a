"""Typed stats snapshots with a stable ``as_dict()`` schema (DESIGN.md §17).

Every observable surface used to export counters its own way: the engine's
`DataLoadStats` attributes, the host tiers' bare counter attributes
(`HostTensorStore.evictions`, `SimHostCache.bytes_spilled`, ...), and the
fleet gateways' hand-assembled `summary()` dicts.  Consumers — the fig
benchmarks and `scripts/check_bench.py` — cherry-picked attribute names, so
a rename in one plane silently drifted the other.

This module is the one place those schemas live.  Providers expose a
`snapshot()` / `stats()` method returning a frozen dataclass from here;
consumers read `as_dict()`, whose keys are the dataclass field names and
therefore cannot drift from the typed surface.  It deliberately imports
nothing from the rest of the package (both planes and the models layer
import it).
"""
from __future__ import annotations

from dataclasses import dataclass, fields


def snapshot_dict(obj) -> dict:
    """``as_dict`` for any stats dataclass: field name -> value, with
    shallow copies of dict-valued fields so callers cannot mutate the
    provider's live counters through the snapshot."""
    out = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = dict(v) if isinstance(v, dict) else v
    return out


@dataclass(frozen=True)
class Snapshot:
    """Base for frozen counter snapshots: one stable dict schema."""

    def as_dict(self) -> dict:
        return snapshot_dict(self)


@dataclass(frozen=True)
class HostStoreStats(Snapshot):
    """Host-tier snapshot — ONE shape for both planes.

    `HostTensorStore` (real numpy buffers) and `SimHostCache` (byte ledger)
    fill the fields they track; plane-specific counters default to 0 so a
    consumer written against this schema reads either plane unchanged.
    """

    resident_bytes: int = 0
    pinned_bytes: int = 0
    leaves_stored: int = 0
    evictions: int = 0
    bytes_spilled: int = 0
    bytes_fetched: int = 0  # sim plane: store -> host promote traffic
    promotions: int = 0  # real plane: store -> host promotes
    expirations: int = 0
    read_retries: int = 0
    quarantines: int = 0
    pressure_evictions: int = 0


@dataclass(frozen=True)
class DedupStats(Snapshot):
    """Cross-model sharing ledger of one device pool (DESIGN.md §17).

    `unique_bytes` is what the pool actually holds (each fingerprint once);
    `logical_bytes` is what a no-dedup pool would hold (each sharer counted).
    `sharer_orphans` counts resident tensors with an EMPTY sharer set — a
    refcount bug, never a workload outcome — and is a hard CI invariant
    (`scripts/check_bench.py` fails any bench entry where it is non-zero).
    """

    unique_bytes: int = 0
    logical_bytes: int = 0
    shared_bytes: int = 0  # bytes of tensors with >= 2 sharers
    shared_tensors: int = 0
    sharer_orphans: int = 0


@dataclass(frozen=True)
class ClusterSummaryStats(Snapshot):
    """`core.cluster.summarize` schema (DESIGN.md §18): the whole-run sim
    rollup the fig benchmarks consume.  Field order IS the legacy dict's
    key order — `summarize()` now builds this and returns `as_dict()`, so
    the keys are bit-identical to the pre-§18 literal."""

    n: int = 0
    ttft_mean: float = 0.0
    ttft_p50: float = 0.0
    ttft_p99: float = 0.0
    load_mean: float = 0.0
    warm_frac: float = 0.0
    joined_frac: float = 0.0
    reuse_frac_mean: float = 0.0
    bytes_from_store_total: int = 0
    bytes_store_hidden_total: int = 0
    prefetched_frac: float = 0.0
    makespan: float = 0.0
    throughput_rps: float = 0.0


@dataclass(frozen=True)
class EngineFaultStats(Snapshot):
    """`Engine.fault_summary()` schema — the real plane's chaos ledger
    (DESIGN.md §15).  fig17 balances ``injected`` against the outcome
    counters; field order matches the legacy dict literal bit-for-bit."""

    injected: dict = None  # type: ignore[assignment]  # per-point counts
    store_read_errors: int = 0
    store_checksum_failures: int = 0
    store_quarantined: int = 0
    store_retries: int = 0
    store_quarantines: int = 0
    h2d_retries: int = 0
    h2d_stalls: int = 0
    transfer_timeouts: int = 0
    prefetch_errors: int = 0
    worker_restarts: int = 0
    join_failovers: int = 0
    load_errors: int = 0
    shutdown_join_timeouts: int = 0
    prefetch_pins_dropped: int = 0
    tensors_reinit: int = 0
    crashes: int = 0


@dataclass(frozen=True)
class ModeledFaultStats(Snapshot):
    """`ModeledEngine.fault_summary()` schema — the modeled plane tracks
    the subset of the ledger it can observe (priced retries + crashes)."""

    injected: dict = None  # type: ignore[assignment]
    store_retries: int = 0
    crashes: int = 0


@dataclass(frozen=True)
class ObsStats(Snapshot):
    """The bench entry's ``obs`` section (DESIGN.md §18): span-accounting
    identity + cost-model cross-check + tracer health.  check_bench
    hard-fails ``unattributed_frac > 0.02`` and any non-finite
    ``span_cost_ratio`` value on new entries."""

    n_requests: int = 0
    ttft_total: float = 0.0
    attributed_total: float = 0.0
    unattributed_frac: float = 0.0
    violations: int = 0  # requests whose own identity broke epsilon
    phase_seconds: dict = None  # type: ignore[assignment]
    span_cost_ratio: dict = None  # type: ignore[assignment]
    trace_events: int = 0
    dropped_events: int = 0


@dataclass(frozen=True)
class FleetStats(Snapshot):
    """Control-plane counters of a fleet gateway run (DESIGN.md §14–§16).

    The TTFT percentile surface stays with the `MetricsSink` (it owns the
    records); `FleetGateway.summary()` merges `sink.summary()` with this
    snapshot's `as_dict()`, so the schema the fig benchmarks and
    `check_bench.py` read is this class, not an ad-hoc dict literal.
    """

    expirations: int = 0
    prewarms: int = 0
    prewarm_hits: int = 0
    prewarm_wasted: int = 0
    pressure_evictions: int = 0
    dropped_requests: int = 0
    engine_crashes: int = 0
    engine_recoveries: int = 0
    requests_redriven: int = 0
    requests_interrupted: int = 0
    migrations: int = 0
    fault_counters: dict = None  # type: ignore[assignment]

    def as_dict(self) -> dict:
        out = snapshot_dict(self)
        if out["fault_counters"] is None:
            del out["fault_counters"]
        return out
