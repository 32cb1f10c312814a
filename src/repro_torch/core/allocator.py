"""Tensor Allocator: the paper's two-stage MCMDKP heuristic (§3.2.2).

Stage 1 — Minimal-Cost Eviction: greedily evict inactive resident tensors in
ascending eviction cost c_j = p_m * (s_j / b_m) * alpha_m (Eq. 2) until the
pool has enough total free bytes.

Stage 2 — Partitioned-Gain Packing (Algorithm 1): place the new tensors into
fragmented free space with minimal "merge" (compaction-copy) cost.  Subspaces
are recursively split at resident tensors (each split point no longer has to
move -> gain = its size); tensors are distributed with a Best-Fit-Decreasing
variant; unsplittable subspaces are compacted wholesale.

`strict_paper=True` reproduces the pseudocode's printed TryPacking feasibility
check (`t.size >= min(C1, C2)` fails) — the default fixes the evident intent
(fail only when the tensor fits in neither side).  See DESIGN.md §6.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from repro_torch.core.regions import Region, RegionList, RState


@dataclass(frozen=True)
class NewTensor:
    fingerprint: str
    size: int


@dataclass
class EvictionCandidate:
    fingerprint: str
    offset: int
    size: int
    cost: float  # c_j from Eq. 2


class AllocationError(Exception):
    pass


# ============================================================= Stage 1: MCE
def minimal_cost_eviction(regions: RegionList, candidates: list[EvictionCandidate],
                          need_bytes: int) -> list[EvictionCandidate]:
    """Pick the ascending-cost prefix of candidates freeing >= need_bytes.

    Pure planning — does not mutate the region list.  Raises AllocationError
    if even evicting every candidate cannot satisfy the request.
    """
    free = regions.free_bytes()
    if free >= need_bytes:
        return []
    chosen: list[EvictionCandidate] = []
    for cand in sorted(candidates, key=lambda c: (c.cost, c.fingerprint)):
        chosen.append(cand)
        free += cand.size
        if free >= need_bytes:
            return chosen
    raise AllocationError(
        f"cannot free {need_bytes}B: {free}B reachable after evicting all "
        f"{len(candidates)} inactive tensors")


# ===================================================== Stage 2: PGP (Algorithm 1)
@dataclass
class Placement:
    """One finalized subspace: compact it, then place `tensors` in its free block."""

    span: tuple[int, int]  # (start_offset, end_offset) of the subspace
    tensors: list[NewTensor]
    merge_bytes: int  # upper bound: movable allocated bytes in the span


@dataclass
class PGPlan:
    placements: list[Placement]
    merge_cost: int  # total estimated bytes to copy

    @property
    def placed(self) -> int:
        return sum(len(p.tensors) for p in self.placements)


def _free_cap(span: Sequence[Region]) -> int:
    return sum(r.size for r in span if r.state == RState.FREE)


def _alloc_in(span: Sequence[Region]) -> list[Region]:
    return [r for r in span if r.state != RState.FREE]


def try_packing(tensors: list[NewTensor], c1: int, c2: int,
                strict_paper: bool = False) -> Optional[tuple[list, list]]:
    """Algorithm 1 lines 17-27: split `tensors` (size-descending) across two
    subspaces by Best-Fit-Decreasing into the larger remaining capacity."""
    t1: list[NewTensor] = []
    t2: list[NewTensor] = []
    for t in tensors:
        if strict_paper:
            if t.size >= min(c1, c2):
                return None
            if c1 >= c2:
                t1.append(t); c1 -= t.size
            else:
                t2.append(t); c2 -= t.size
        else:
            if t.size > max(c1, c2):
                return None
            if c1 >= c2 and t.size <= c1:
                t1.append(t); c1 -= t.size
            elif t.size <= c2:
                t2.append(t); c2 -= t.size
            else:
                t1.append(t); c1 -= t.size
    return t1, t2


def partitioned_gain_packing(regions: RegionList, new_tensors: Sequence[NewTensor],
                             strict_paper: bool = False) -> PGPlan:
    """Build a placement plan for `new_tensors` over the current region list.

    Pinned regions split the pool into independent root subspaces.  Raises
    AllocationError when the tensors cannot fit even with full compaction
    (caller should evict more via Stage 1 and retry).
    """
    tensors = sorted(new_tensors, key=lambda t: (-t.size, t.fingerprint))

    # roots = maximal pinned-free spans
    roots: list[list[Region]] = []
    cur: list[Region] = []
    for r in regions.regions:
        if r.pinned:
            if cur:
                roots.append(cur)
                cur = []
        else:
            cur.append(r)
    if cur:
        roots.append(cur)
    roots = [s for s in roots if _free_cap(s) > 0]

    # initial BFD assignment of tensors across roots
    caps = [_free_cap(s) for s in roots]
    assign: list[list[NewTensor]] = [[] for _ in roots]
    for t in tensors:
        order = sorted(range(len(roots)), key=lambda i: -caps[i])
        for i in order:
            if t.size <= caps[i]:
                assign[i].append(t)
                caps[i] -= t.size
                break
        else:
            raise AllocationError(
                f"tensor {t.fingerprint} ({t.size}B) does not fit: "
                f"free={regions.free_bytes()}B largest root cap={max(caps, default=0)}B")

    placements: list[Placement] = []
    stack: list[tuple[list[Region], list[NewTensor]]] = list(zip(roots, assign))
    while stack:
        span, ts = stack.pop()
        if not ts:
            continue  # nothing to place -> no compaction, zero merge cost
        split_done = False
        # prefix sums make each split attempt O(1) instead of O(span)
        free_pref = [0]
        for r in span:
            free_pref.append(free_pref[-1]
                             + (r.size if r.state == RState.FREE else 0))
        total_free = free_pref[-1]
        # candidate split points in descending gain (= size) order; cap the
        # attempts — low-gain tails rarely succeed and cost O(|T|) each
        cands = sorted(((r.size, k) for k, r in enumerate(span)
                        if r.state != RState.FREE), key=lambda t: -t[0])[:32]
        for _, k in cands:
            packed = try_packing(ts, free_pref[k], total_free - free_pref[k + 1],
                                 strict_paper)
            if packed is not None:
                stack.append((span[:k], packed[0]))
                stack.append((span[k + 1:], packed[1]))
                split_done = True
                break
        if not split_done:
            merge = sum(r.size for r in _alloc_in(span))
            placements.append(Placement(
                span=(span[0].offset, span[-1].end), tensors=ts, merge_bytes=merge))

    return PGPlan(placements=placements,
                  merge_cost=sum(p.merge_bytes for p in placements))


def apply_plan(regions: RegionList, plan: PGPlan) -> tuple[int, dict[str, int], dict[str, int]]:
    """Execute a PGPlan: compact each placement span, then allocate tensors.

    Returns (bytes_actually_moved, relocations {owner: new_offset},
    tensor placements {fingerprint: offset}).
    """
    moved_total = 0
    relocations: dict[str, int] = {}
    placed: dict[str, int] = {}
    for p in plan.placements:
        lo_off, hi_off = p.span
        lo_idx, hi_idx = regions.span_bounds(lo_off, hi_off)
        moved, rel = regions.compact_span(lo_idx, hi_idx)
        moved_total += moved
        relocations.update(rel)
        # the span now ends with one contiguous free region; fill it
        for t in p.tensors:
            target = regions.find_free_in(lo_off, hi_off, t.size)
            assert target is not None, f"no room for {t.fingerprint} after compaction"
            reg = regions.alloc_at(target.offset, t.size, RState.TENSOR, t.fingerprint)
            placed[t.fingerprint] = reg.offset
    return moved_total, relocations, placed


# ======================================================= naive global merge
def global_merge_plan(regions: RegionList, new_tensors: Sequence[NewTensor]) -> PGPlan:
    """Baseline "GlobalMerge": compact the whole (unpinned) pool into one block.

    Used by the Fig. 10 baselines (Rand+GM / MCE+GM).
    """
    tensors = sorted(new_tensors, key=lambda t: -t.size)
    spans: list[list[Region]] = []
    cur: list[Region] = []
    for r in regions.regions:
        if r.pinned:
            if cur:
                spans.append(cur); cur = []
        else:
            cur.append(r)
    if cur:
        spans.append(cur)
    spans = [s for s in spans if _free_cap(s) > 0]
    caps = [_free_cap(s) for s in spans]
    assign: list[list[NewTensor]] = [[] for _ in spans]
    for t in tensors:
        order = sorted(range(len(spans)), key=lambda i: -caps[i])
        for i in order:
            if t.size <= caps[i]:
                assign[i].append(t); caps[i] -= t.size
                break
        else:
            raise AllocationError(f"GlobalMerge: {t.fingerprint} does not fit")
    placements = [
        Placement(span=(s[0].offset, s[-1].end), tensors=ts,
                  merge_bytes=sum(r.size for r in _alloc_in(s)))
        for s, ts in zip(spans, assign) if ts
    ]
    return PGPlan(placements, sum(p.merge_bytes for p in placements))
