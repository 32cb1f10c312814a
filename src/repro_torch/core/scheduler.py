"""GPU-Affinity-Aware Scheduler (§3.4, Algorithm 2) + queueing-aware variant.

Given queued model requests and the per-device Reuse Store states, route each
request to the device with the lowest expected load time
t_load = (S - S') / B (Eq. 3).  The paper's score assumes one instance per
device; under concurrent multi-instance workers (DESIGN.md §8) a hot device
with the model resident can still be the *wrong* choice when its decode
pipeline is saturated, so the "eq3+queue" policy scores
t_load + expected_queue_delay(device) instead.  The pure-Eq.3 score is kept
as the named "eq3" policy for ablation (benchmarks/fig14_concurrency.py).
Baseline schedulers (random, first-fit) are provided for the Fig. 13
comparison.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Protocol, Sequence

from repro_torch.core.costmodel import (Hardware, estimate_load_time,
                                  estimate_load_time_tiered, unique_bytes)
from repro_torch.models.tensors import TensorRecord

#: Named affinity scoring policies (ablation knob; SimPolicy.queue_aware).
AFFINITY_POLICIES = ("eq3", "eq3+queue")


class DeviceView(Protocol):
    """What the controller can query about a candidate device (RPC in §5.7)."""

    device_id: str

    # model_id makes admission identity-aware: a device busy with the same
    # model shares its resident weights with a new placement, so capacity
    # checks must not double-count them (DESIGN.md §8/§10).
    def can_run(self, model_bytes: int, model_id: Optional[str] = None) -> bool: ...
    def reusable_bytes(self, records: Sequence[TensorRecord]) -> int: ...
    # Optional (queueing-aware scoring): expected seconds of queueing a new
    # instance would see on this device right now.
    # def expected_queue_delay(self, now: float) -> float: ...
    # Optional (tier-aware scoring, DESIGN.md §11): bytes of `records` the
    # node's HOST cache tier holds — misses beyond these must be promoted
    # from the persistent store at min(h2d_bw, store_bw).
    # def host_resident_bytes(self, records) -> int: ...
    # Optional (prefetch pipeline, DESIGN.md §12): placement chose this
    # device — start promoting the model's store-resident tensors now so
    # the read overlaps queueing/init instead of extending the load.
    # def hint_prefetch(self, model_id, records, now) -> None: ...
    # Optional (live KV migration, DESIGN.md §16): seconds until this
    # device frees up if its blocking long decode is MIGRATED elsewhere
    # (the source-side snapshot stall), or None when nothing is migratable
    # (idle, no target, or the remaining decode is shorter than the
    # handoff).  When offered and cheaper than waiting, the scheduler
    # scores it instead of expected_queue_delay and flags the entry.
    # def migration_offer(self, now) -> Optional[float]: ...


@dataclass
class ScheduleEntry:
    model_id: str
    device_id: str
    expected_load_seconds: float
    reuse_bytes: int
    # the queueing term was replaced by a migration offer: the device's
    # blocking decode hands off elsewhere instead of being waited out
    # (DESIGN.md §16); the consumer executes the handoff it priced.
    migrate: bool = False


def affinity_schedule(requests: Sequence[tuple[str, Sequence[TensorRecord], int]],
                      devices: list, hw: Hardware,
                      *, in_host_cache: bool = True, policy: str = "eq3",
                      now: float = 0.0) -> tuple[list[ScheduleEntry], list[str]]:
    """Algorithm 2.  requests: (model_id, tensor_records, model_bytes).

    policy: "eq3" scores pure load time (the paper); "eq3+queue" adds the
    device's expected queueing delay so hot devices stop absorbing every
    request for their resident models.  Returns (schedules,
    still_queued_model_ids).  Each chosen device is removed from the
    available pool — one NEW instance placement per device per round
    (concurrent workers may still accept several across rounds).

    Dedup-aware scoring (DESIGN.md §17) needs no extra plumbing: `records`
    carry content-capable fingerprints, so `reusable_bytes` /
    `host_resident_bytes` count a variant's base leaves as resident on any
    node warm with the base — the score routes variants toward their base.
    A request may pass `model_bytes=None` to mean "the record set's deduped
    footprint" (each fingerprint once).
    """
    assert policy in AFFINITY_POLICIES, policy
    avail = list(devices)
    schedules: list[ScheduleEntry] = []
    queued: list[str] = []
    for model_id, records, model_bytes in requests:
        if model_bytes is None:
            model_bytes = unique_bytes(records)
        best = None
        best_lat = float("inf")
        best_reuse = 0
        best_mig = False
        for dev in avail:
            if not dev.can_run(model_bytes, model_id):
                continue
            reuse = dev.reusable_bytes(records)
            host_fn = getattr(dev, "host_resident_bytes", None)
            if host_fn is not None:
                # tier-aware t_load: host-cached misses at h2d_bw, the rest
                # promoted from the persistent store at min(h2d_bw, store_bw)
                lat = estimate_load_time_tiered(model_bytes, reuse,
                                                host_fn(records), hw)
            else:
                lat = estimate_load_time(model_bytes, reuse, hw,
                                         in_host_cache=in_host_cache)
            mig = False
            if policy == "eq3+queue":
                delay_fn = getattr(dev, "expected_queue_delay", None)
                if delay_fn is not None:
                    delay = delay_fn(now)
                    # migrate vs queue (DESIGN.md §16): a device holding a
                    # long decode may offer to hand it off — the arrival
                    # then waits only for the source-side snapshot stall
                    offer_fn = getattr(dev, "migration_offer", None)
                    offer = offer_fn(now) if offer_fn is not None else None
                    if offer is not None and offer < delay:
                        delay, mig = offer, True
                    lat += delay
            if lat < best_lat:
                best, best_lat, best_reuse, best_mig = dev, lat, reuse, mig
        if best is None:
            queued.append(model_id)
        else:
            schedules.append(ScheduleEntry(model_id, best.device_id, best_lat,
                                           best_reuse, migrate=best_mig))
            avail.remove(best)
            # prefetch-on-affinity-hint (DESIGN.md §12): placement is the
            # earliest moment the target node is known, so the store->host
            # promotion starts HERE and overlaps queueing/init/h2d instead
            # of extending the load.  Optional protocol method — devices
            # without a prefetch pipeline (or with it disabled) ignore it.
            hint = getattr(best, "hint_prefetch", None)
            if hint is not None:
                hint(model_id, records, now)
    return schedules, queued


def random_schedule(requests, devices, rng) -> tuple[list[ScheduleEntry], list[str]]:
    """SLLM-CM baseline: random selection among feasible devices (§5.6)."""
    avail = list(devices)
    schedules, queued = [], []
    for model_id, records, model_bytes in requests:
        if model_bytes is None:
            model_bytes = unique_bytes(records)
        feasible = [d for d in avail if d.can_run(model_bytes, model_id)]
        if not feasible:
            queued.append(model_id)
            continue
        dev = feasible[rng.randrange(len(feasible))]
        schedules.append(ScheduleEntry(model_id, dev.device_id, float("nan"), 0))
        avail.remove(dev)
    return schedules, queued
