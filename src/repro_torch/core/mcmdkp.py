"""MCMDKP (Eq. 1): exact brute-force oracle for tiny instances.

The paper formalizes tensor allocation as a Multi-Choice Multi-Dimensional
Knapsack Problem: for each resident tensor choose {keep, evict (cost c_j),
merge/move (cost m_j = s_j)} such that all new tensors obtain contiguous
space, minimizing total cost.  The oracle enumerates every (evict, move)
subset pair and checks geometric feasibility by exact bin packing of
(moved ∪ new) items into the gaps left by fixed regions — exponential, but
exact for the <= ~10-item instances used in tests.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.regions import RegionList, RState


@dataclass(frozen=True)
class Resident:
    fingerprint: str
    size: int
    evict_cost: float  # c_j
    evictable: bool = True
    movable: bool = True


def _bin_pack(items: tuple[int, ...], bins: tuple[int, ...]) -> bool:
    """Exact feasibility: can `items` be packed into `bins`? (branch & bound)"""
    items = tuple(sorted(items, reverse=True))

    def rec(items, bins):
        if not items:
            return True
        it, rest = items[0], items[1:]
        seen = set()
        for i, b in enumerate(bins):
            if b >= it and b not in seen:  # symmetry pruning on equal bins
                seen.add(b)
                nb = list(bins)
                nb[i] = b - it
                if rec(rest, tuple(nb)):
                    return True
        return False

    return rec(items, tuple(bins))


def oracle_min_cost(capacity: int, layout: Sequence[tuple[str, int]],
                    residents: dict[str, Resident],
                    new_sizes: Sequence[int]) -> Optional[float]:
    """Minimal total (evict + move) cost to host all `new_sizes`, or None.

    layout: ordered (owner|"", size) covering the pool; "" = free gap.
    Move cost for resident j = s_j (one device copy); evict cost = c_j.
    """
    occupied = [(name, size) for name, size in layout if name]
    best: Optional[float] = None
    occ_names = [n for n, _ in occupied]

    for evict_mask in itertools.product([0, 1], repeat=len(occupied)):
        if any(e and not residents[n].evictable for e, n in zip(evict_mask, occ_names)):
            continue
        evicted = {n for e, n in zip(evict_mask, occ_names) if e}
        cost_e = sum(residents[n].evict_cost for n in evicted)
        if best is not None and cost_e >= best:
            continue
        remaining = [n for n in occ_names if n not in evicted]
        for move_mask in itertools.product([0, 1], repeat=len(remaining)):
            if any(m and not residents[n].movable for m, n in zip(move_mask, remaining)):
                continue
            moved = {n for m, n in zip(move_mask, remaining) if m}
            cost = cost_e + sum(residents[n].size for n in moved)
            if best is not None and cost >= best:
                continue
            # fixed regions stay; gaps = maximal free runs between fixed regions
            gaps: list[int] = []
            run = 0
            for name, size in layout:
                if name and name not in evicted and name not in moved:
                    if run:
                        gaps.append(run)
                    run = 0
                else:
                    run += size
            if run:
                gaps.append(run)
            items = tuple(list(new_sizes) + [residents[n].size for n in moved])
            if _bin_pack(items, tuple(gaps)):
                best = cost
    return best


def layout_of(regions: RegionList) -> list[tuple[str, int]]:
    return [("" if r.state == RState.FREE else r.owner, r.size)
            for r in regions.regions]
