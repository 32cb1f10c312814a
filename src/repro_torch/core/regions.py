"""Region list: the Unified Memory Pool's view of the device address space.

The pool is a chain of contiguous regions, each FREE or allocated (TENSOR or
KV), mirroring §3.2 of the paper.  Regions are kept sorted by offset; freeing
coalesces with free neighbours.  KV regions belonging to a *running* instance
are pinned (never moved by compaction) — they act as hard boundaries for
Partitioned-Gain Packing subspaces.

Hot queries are indexed (DESIGN.md §10): a parallel sorted offset array makes
`_index_at` a dict lookup + bisect, free regions live in size buckets (bucket
b holds sizes in [2^(b-1), 2^b)) so best-fit probes O(log capacity) buckets
instead of scanning the chain, `free_bytes` is a running counter, and `find`
goes through an owner index.  Compaction paths (`compact_span`, `coalesce`)
rebuild the indexes wholesale — they already copy O(span) regions and only run
on the (rare) merge path, never per decode step.  `NaiveRegionList` preserves
the original O(n)-scan behaviour as the measured baseline for
benchmarks/fig15_fastpath.py.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from enum import Enum
from typing import Optional


class RState(str, Enum):
    FREE = "free"
    TENSOR = "tensor"
    KV = "kv"


@dataclass
class Region:
    offset: int
    size: int
    state: RState = RState.FREE
    owner: Optional[str] = None  # tensor fingerprint or model_id (KV)
    pinned: bool = False  # immovable (active KV)

    @property
    def end(self) -> int:
        return self.offset + self.size

    def __repr__(self):
        tag = {RState.FREE: "F", RState.TENSOR: "T", RState.KV: "K"}[self.state]
        pin = "!" if self.pinned else ""
        return f"[{tag}{pin} {self.offset}+{self.size}]"


class RegionList:
    """Sorted, fully-covering, coalesced region chain over [0, capacity)."""

    def __init__(self, capacity: int):
        assert capacity > 0
        self.capacity = capacity
        self.regions: list[Region] = [Region(0, capacity)]
        self._rebuild_index()

    # -------------------------------------------------------------- indexing
    def _rebuild_index(self):
        self._offsets: list[int] = [r.offset for r in self.regions]
        self._by_offset: dict[int, Region] = {r.offset: r for r in self.regions}
        self._free_total = 0
        self._free_buckets: dict[int, dict[int, Region]] = {}
        self._free_offsets: list[int] = []  # offset-sorted free regions
        self._owners: dict[str, dict[int, Region]] = {}
        for r in self.regions:
            if r.state == RState.FREE:
                self._free_total += r.size
                self._bucket_add(r)
            elif r.owner is not None:
                self._owners.setdefault(r.owner, {})[r.offset] = r

    @staticmethod
    def _bucket_of(size: int) -> int:
        return size.bit_length()

    def _bucket_add(self, r: Region):
        self._free_buckets.setdefault(self._bucket_of(r.size), {})[r.offset] = r
        bisect.insort(self._free_offsets, r.offset)

    def _bucket_remove(self, r: Region):
        b = self._bucket_of(r.size)
        bucket = self._free_buckets.get(b)
        if bucket is not None and r.offset in bucket:
            del bucket[r.offset]
            if not bucket:
                del self._free_buckets[b]
            i = bisect.bisect_left(self._free_offsets, r.offset)
            del self._free_offsets[i]

    def _owner_add(self, r: Region):
        if r.owner is not None:
            self._owners.setdefault(r.owner, {})[r.offset] = r

    def _owner_remove(self, r: Region):
        if r.owner is not None:
            owned = self._owners.get(r.owner)
            if owned is not None:
                owned.pop(r.offset, None)
                if not owned:
                    del self._owners[r.owner]

    # ------------------------------------------------------------- invariants
    def check(self):
        assert self.regions[0].offset == 0
        assert self.regions[-1].end == self.capacity
        for a, b in zip(self.regions, self.regions[1:]):
            assert a.end == b.offset, f"gap/overlap at {a} -> {b}"
            assert not (a.state == RState.FREE and b.state == RState.FREE), \
                f"uncoalesced free regions {a} {b}"
        # index consistency
        assert self._offsets == [r.offset for r in self.regions]
        assert all(self._by_offset[r.offset] is r for r in self.regions)
        free = [r for r in self.regions if r.state == RState.FREE]
        assert self._free_total == sum(r.size for r in free)
        indexed_free = {off for bucket in self._free_buckets.values()
                        for off in bucket}
        assert indexed_free == {r.offset for r in free}
        assert self._free_offsets == sorted(r.offset for r in free)
        owned = {(o, off) for o, d in self._owners.items() for off in d}
        assert owned == {(r.owner, r.offset) for r in self.regions
                         if r.state != RState.FREE and r.owner is not None}
        return True

    # ---------------------------------------------------------------- queries
    def _index_at(self, offset: int) -> int:
        assert offset in self._by_offset, f"no region at offset {offset}"
        return bisect.bisect_left(self._offsets, offset)

    def free_regions(self) -> list[Region]:
        return [r for r in self.regions if r.state == RState.FREE]

    def allocated_regions(self) -> list[Region]:
        return [r for r in self.regions if r.state != RState.FREE]

    def free_bytes(self) -> int:
        return self._free_total

    def used_bytes(self) -> int:
        return self.capacity - self.free_bytes()

    def largest_free(self) -> int:
        if not self._free_buckets:
            return 0
        top = self._free_buckets[max(self._free_buckets)]
        return max(r.size for r in top.values())

    def fragmentation(self) -> float:
        """1 - largest_free/total_free; 0 = one contiguous free block."""
        fb = self.free_bytes()
        return 0.0 if fb == 0 else 1.0 - self.largest_free() / fb

    def find(self, owner: str) -> Optional[Region]:
        owned = self._owners.get(owner)
        if not owned:
            return None
        return owned[min(owned)]  # match scan order: lowest offset first

    def span_bounds(self, lo_off: int, hi_off: int) -> tuple[int, int]:
        """(lo_idx, hi_idx) of the regions fully inside [lo_off, hi_off)."""
        lo = bisect.bisect_left(self._offsets, lo_off)
        hi = lo
        while hi < len(self.regions) and self.regions[hi].end <= hi_off:
            hi += 1
        assert hi > lo, f"span [{lo_off},{hi_off}) vanished"
        return lo, hi - 1

    def find_free_in(self, lo_off: int, hi_off: int,
                     min_size: int) -> Optional[Region]:
        """First free region of >= min_size fully inside [lo_off, hi_off)."""
        i = bisect.bisect_left(self._free_offsets, lo_off)
        while i < len(self._free_offsets):
            r = self._by_offset[self._free_offsets[i]]
            if r.offset >= hi_off:
                break
            if r.end <= hi_off and r.size >= min_size:
                return r
            i += 1
        return None

    # ------------------------------------------------------------- allocation
    def alloc_best_fit(self, size: int, state: RState, owner: str,
                       pinned: bool = False) -> Optional[Region]:
        """Smallest free region that fits; splits the remainder off."""
        best = self._best_fit(size)
        if best is None:
            return None
        return self.alloc_at(best.offset, size, state, owner, pinned)

    def _best_fit(self, size: int) -> Optional[Region]:
        """Probe size buckets upward from the request's own bucket; the first
        non-empty bucket holding a fitting region yields the best fit (every
        region in a higher bucket is bigger than every fit in a lower one)."""
        for b in sorted(self._free_buckets):
            if b < self._bucket_of(size):
                continue
            fits = [r for r in self._free_buckets[b].values() if r.size >= size]
            if fits:
                return min(fits, key=lambda r: (r.size, r.offset))
        return None

    def alloc_at(self, offset: int, size: int, state: RState, owner: str,
                 pinned: bool = False) -> Region:
        """Carve `size` bytes from the free region starting at `offset`."""
        i = self._index_at(offset)
        r = self.regions[i]
        assert r.state == RState.FREE and r.size >= size, f"bad alloc at {r}"
        self._bucket_remove(r)
        self._free_total -= r.size
        new = Region(offset, size, state, owner, pinned)
        tail = []
        if r.size > size:
            tail = [Region(offset + size, r.size - size)]
        self.regions[i : i + 1] = [new] + tail
        # index maintenance
        del self._by_offset[offset]
        self._by_offset[new.offset] = new
        self._owner_add(new)
        if tail:
            t = tail[0]
            self._offsets.insert(i + 1, t.offset)
            self._by_offset[t.offset] = t
            self._free_total += t.size
            self._bucket_add(t)
        return new

    def free(self, offset: int) -> Region:
        """Free the region starting at `offset`, coalescing neighbours."""
        i = self._index_at(offset)
        r = self.regions[i]
        assert r.state != RState.FREE
        self._owner_remove(r)
        r.state, r.owner, r.pinned = RState.FREE, None, False
        self._free_total += r.size
        # coalesce with right then left
        if i + 1 < len(self.regions) and self.regions[i + 1].state == RState.FREE:
            right = self.regions[i + 1]
            self._bucket_remove(right)
            del self._by_offset[right.offset]
            r.size += right.size
            del self.regions[i + 1]
            del self._offsets[i + 1]
        if i > 0 and self.regions[i - 1].state == RState.FREE:
            left = self.regions[i - 1]
            self._bucket_remove(left)
            del self._by_offset[r.offset]
            left.size += r.size
            del self.regions[i]
            del self._offsets[i]
            r = left
        self._bucket_add(r)
        return r

    # -------------------------------------------------------------- compaction
    def compact_span(self, lo_idx: int, hi_idx: int) -> tuple[int, dict[str, int]]:
        """Slide all movable allocated regions in regions[lo_idx:hi_idx+1] to the
        left edge of the span, producing one contiguous free region at the right.

        Returns (bytes_moved, {owner: new_offset}).  Pinned regions must not be
        inside the span (PGP treats them as subspace boundaries).  Index
        maintenance is O(span), not O(n): only the span's entries change, and
        the sole possible free-free adjacency afterwards is the span's new
        free tail against its right neighbour (the chain was coalesced before,
        so an all-free span was a single region and a no-op).
        """
        span = self.regions[lo_idx : hi_idx + 1]
        assert all(not r.pinned for r in span), "pinned region inside compaction span"
        base = span[0].offset
        total = sum(r.size for r in span)
        moved = 0
        relocations: dict[str, int] = {}
        new_span: list[Region] = []
        cur = base
        for r in span:
            if r.state != RState.FREE:
                if r.offset != cur:
                    moved += r.size
                    relocations[r.owner] = cur
                new_span.append(Region(cur, r.size, r.state, r.owner, r.pinned))
                cur += r.size
        free_size = base + total - cur
        if free_size:
            new_span.append(Region(cur, free_size))
        for r in span:
            del self._by_offset[r.offset]
            if r.state == RState.FREE:
                self._bucket_remove(r)
                self._free_total -= r.size
            else:
                self._owner_remove(r)
        self.regions[lo_idx : hi_idx + 1] = new_span
        self._offsets[lo_idx : hi_idx + 1] = [r.offset for r in new_span]
        for r in new_span:
            self._by_offset[r.offset] = r
            if r.state == RState.FREE:
                self._free_total += r.size
                self._bucket_add(r)
            else:
                self._owner_add(r)
        self._coalesce_pair(lo_idx + len(new_span) - 1)
        return moved, relocations

    def _coalesce_pair(self, i: int):
        """Merge regions[i] and regions[i+1] if both are free (O(1) index)."""
        if i < 0 or i + 1 >= len(self.regions):
            return
        a, b = self.regions[i], self.regions[i + 1]
        if a.state == RState.FREE and b.state == RState.FREE:
            self._bucket_remove(a)
            self._bucket_remove(b)
            del self._by_offset[b.offset]
            a.size += b.size
            del self.regions[i + 1]
            del self._offsets[i + 1]
            self._bucket_add(a)

    def coalesce(self):
        """Merge any adjacent free regions (O(n); compaction-path only)."""
        j = 0
        while j < len(self.regions) - 1:
            a, b = self.regions[j], self.regions[j + 1]
            if a.state == RState.FREE and b.state == RState.FREE:
                a.size += b.size
                del self.regions[j + 1]
            else:
                j += 1
        self._rebuild_index()

    def __repr__(self):
        return " ".join(repr(r) for r in self.regions)


class NaiveRegionList(RegionList):
    """The pre-index RegionList, byte-faithful: every query is an O(n) scan
    and the mutators are the original list-splice implementations — NO index
    structures are maintained (the ones built by __init__ go stale and are
    never read).  Kept as the measured baseline for
    benchmarks/fig15_fastpath.py and the indexed-vs-naive equivalence test —
    not for production use.
    """

    def check(self):
        assert self.regions[0].offset == 0
        assert self.regions[-1].end == self.capacity
        for a, b in zip(self.regions, self.regions[1:]):
            assert a.end == b.offset, f"gap/overlap at {a} -> {b}"
            assert not (a.state == RState.FREE and b.state == RState.FREE), \
                f"uncoalesced free regions {a} {b}"
        return True

    def _index_at(self, offset: int) -> int:
        lo = bisect.bisect_right([r.offset for r in self.regions], offset) - 1
        assert 0 <= lo < len(self.regions) and self.regions[lo].offset == offset, \
            f"no region at offset {offset}"
        return lo

    def free_bytes(self) -> int:
        return sum(r.size for r in self.free_regions())

    def largest_free(self) -> int:
        return max((r.size for r in self.free_regions()), default=0)

    def find(self, owner: str) -> Optional[Region]:
        for r in self.regions:
            if r.owner == owner and r.state != RState.FREE:
                return r
        return None

    def alloc_best_fit(self, size: int, state: RState, owner: str,
                       pinned: bool = False) -> Optional[Region]:
        best = None
        for r in self.regions:
            if r.state == RState.FREE and r.size >= size:
                if best is None or r.size < best.size:
                    best = r
        if best is None:
            return None
        return self.alloc_at(best.offset, size, state, owner, pinned)

    def alloc_at(self, offset: int, size: int, state: RState, owner: str,
                 pinned: bool = False) -> Region:
        i = self._index_at(offset)
        r = self.regions[i]
        assert r.state == RState.FREE and r.size >= size, f"bad alloc at {r}"
        new = Region(offset, size, state, owner, pinned)
        tail = []
        if r.size > size:
            tail = [Region(offset + size, r.size - size)]
        self.regions[i : i + 1] = [new] + tail
        return new

    def free(self, offset: int) -> Region:
        i = self._index_at(offset)
        r = self.regions[i]
        assert r.state != RState.FREE
        r.state, r.owner, r.pinned = RState.FREE, None, False
        if i + 1 < len(self.regions) and self.regions[i + 1].state == RState.FREE:
            r.size += self.regions[i + 1].size
            del self.regions[i + 1]
        if i > 0 and self.regions[i - 1].state == RState.FREE:
            self.regions[i - 1].size += r.size
            del self.regions[i]
            r = self.regions[i - 1]
        return r

    def compact_span(self, lo_idx: int, hi_idx: int) -> tuple[int, dict[str, int]]:
        span = self.regions[lo_idx : hi_idx + 1]
        assert all(not r.pinned for r in span), "pinned region inside compaction span"
        base = span[0].offset
        total = sum(r.size for r in span)
        moved = 0
        relocations: dict[str, int] = {}
        new_span: list[Region] = []
        cur = base
        for r in span:
            if r.state != RState.FREE:
                if r.offset != cur:
                    moved += r.size
                    relocations[r.owner] = cur
                new_span.append(Region(cur, r.size, r.state, r.owner, r.pinned))
                cur += r.size
        free_size = base + total - cur
        if free_size:
            new_span.append(Region(cur, free_size))
        self.regions[lo_idx : hi_idx + 1] = new_span
        self.coalesce()
        return moved, relocations

    def coalesce(self):
        j = 0
        while j < len(self.regions) - 1:
            a, b = self.regions[j], self.regions[j + 1]
            if a.state == RState.FREE and b.state == RState.FREE:
                a.size += b.size
                del self.regions[j + 1]
            else:
                j += 1

    def span_bounds(self, lo_off: int, hi_off: int) -> tuple[int, int]:
        idxs = [i for i, r in enumerate(self.regions)
                if r.offset >= lo_off and r.end <= hi_off]
        assert idxs, f"span [{lo_off},{hi_off}) vanished"
        return min(idxs), max(idxs)

    def find_free_in(self, lo_off: int, hi_off: int,
                     min_size: int) -> Optional[Region]:
        for r in self.regions:
            if (r.state == RState.FREE and r.offset >= lo_off
                    and r.end <= hi_off and r.size >= min_size):
                return r
        return None
