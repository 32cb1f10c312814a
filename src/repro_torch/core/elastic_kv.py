"""ElasticKV (§3.3): on-demand KV-cache block allocation from the Unified
Memory Pool.

Block tables map a request's Logical Block Numbers to globally unique
Physical Block Numbers; the Address Table maps PBNs to pool offsets.  The
optimizations from the paper are implemented exactly:
  * delayed release — completed requests' blocks go to a Free List, not back
    to the pool;
  * batched allocation — the engine calls `ensure()` once per step with every
    request's new length, and the allocator fetches pool regions holding many
    blocks at a time;
  * urgent reclamation — if the pool is out of space mid-decode, tensors of
    inactive models are MCE-evicted directly (no merging on the hot path).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.regions import RState
from repro_torch.core.reuse_store import ReuseStore


@dataclass(frozen=True)
class KVSnapshot:
    """One request's serialized live-KV state — the unit the migration path
    ships between engines (DESIGN.md §16).

    ``pages`` holds one opaque payload per logical block, in logical-block
    order, produced by the ``reader`` passed to :meth:`ElasticKV.snapshot`
    (the real plane reads device slab pages, the property tests read a
    byte-dict).  The snapshot carries its geometry so a restore onto a
    mismatched ElasticKV is rejected instead of silently corrupting pages.
    """

    req: str
    seq_len: int
    block_tokens: int
    kv_bytes_per_token: int
    pages: tuple

    @property
    def num_blocks(self) -> int:
        return len(self.pages)

    def nbytes(self) -> int:
        """Payload bytes the migration transfer must move (cost plane and
        host-tier accounting both price from this)."""
        return self.num_blocks * self.block_tokens * self.kv_bytes_per_token


@dataclass
class KVStats:
    pool_allocs: int = 0  # region fetches from the pool (slow path)
    freelist_allocs: int = 0  # blocks served from the free list
    blocks_allocated: int = 0
    urgent_reclaims: int = 0
    ensure_calls: int = 0

    @property
    def alloc_ops(self) -> int:
        return self.pool_allocs + self.freelist_allocs


class ElasticKV:
    """Per-instance KV manager bound to a worker's ReuseStore/pool."""

    def __init__(self, store: ReuseStore, model_id: str, *,
                 block_tokens: int = 16, kv_bytes_per_token: int,
                 blocks_per_region: int = 64):
        self.store = store
        self.model_id = model_id
        self.block_tokens = block_tokens
        self.block_bytes = block_tokens * kv_bytes_per_token
        self.blocks_per_region = blocks_per_region
        self.block_tables: dict[str, list[int]] = {}  # req -> [PBN]
        self.seq_lens: dict[str, int] = {}
        self.addr: dict[int, int] = {}  # PBN -> pool offset
        self.free_list: list[int] = []
        self.region_offsets: list[int] = []
        self._region_bytes = 0  # exact pool bytes held (regions vary in size)
        self._next_pbn = 0
        self.stats = KVStats()

    # -------------------------------------------------------------- planning
    def blocks_for(self, tokens: int) -> int:
        return -(-tokens // self.block_tokens)

    def reserved_bytes(self) -> int:
        return self._region_bytes

    def used_blocks(self) -> int:
        return sum(len(t) for t in self.block_tables.values())

    # ------------------------------------------------------------ allocation
    def _grow_pool(self, min_blocks: int):
        """Fetch regions from the pool (batched; pinned while instance runs).

        Prefers large regions (amortized allocation); under fragmentation it
        degrades gracefully to smaller multi-block regions — blocks need not
        be contiguous across regions, only within one (PagedAttention-style).
        """
        remaining = min_blocks
        while remaining > 0:
            blocks = min(remaining if remaining > self.blocks_per_region // 2
                         else remaining, self.blocks_per_region)
            reg = None
            while blocks >= 1:
                reg = self.store.pool.alloc_best_fit(
                    blocks * self.block_bytes, RState.KV,
                    f"kv:{self.model_id}", pinned=True)
                if reg is not None:
                    break
                blocks //= 2
            if reg is None:
                # nothing fits even one block: MCE-evict inactive tensors (§3.3)
                self.store.urgent_reclaim(remaining * self.block_bytes)
                self.stats.urgent_reclaims += 1
                blocks = 1
                reg = self.store.pool.alloc_best_fit(
                    self.block_bytes, RState.KV, f"kv:{self.model_id}", pinned=True)
                if reg is None and self.store.urgent_reclaim_contiguous(self.block_bytes):
                    reg = self.store.pool.alloc_best_fit(
                        self.block_bytes, RState.KV, f"kv:{self.model_id}", pinned=True)
                if reg is None:
                    raise MemoryError(
                        f"KV OOM: need {remaining * self.block_bytes}B, "
                        f"free={self.store.free_bytes()}B (fragmented)")
            self.region_offsets.append(reg.offset)
            self._region_bytes += reg.size
            base_pbn = self._next_pbn
            for i in range(blocks):
                self.addr[base_pbn + i] = reg.offset + i * self.block_bytes
                self.free_list.append(base_pbn + i)
            self._next_pbn += blocks
            self.stats.pool_allocs += 1
            remaining -= blocks

    def ensure(self, req_lens: dict[str, int]) -> dict[str, list[int]]:
        """Batched per-step allocation: grow each request's table to cover its
        new token count.  Returns the updated block tables.  Single pass over
        the batch (this runs once per block-mapping step in the engine and
        once per block of decode progress in the cluster sim)."""
        self.stats.ensure_calls += 1
        deficits = []
        total_deficit = 0
        for req, tokens in req_lens.items():
            self.seq_lens[req] = tokens
            have = len(self.block_tables.get(req, ()))
            want = self.blocks_for(tokens)
            if want > have:
                deficits.append((req, want - have))
                total_deficit += want - have
        if not deficits:
            return self.block_tables
        if total_deficit > len(self.free_list):
            self._grow_pool(total_deficit - len(self.free_list))
        self.stats.freelist_allocs += total_deficit
        self.stats.blocks_allocated += total_deficit
        for req, n in deficits:
            table = self.block_tables.setdefault(req, [])
            for _ in range(n):
                table.append(self.free_list.pop())
        return self.block_tables

    # ---------------------------------------------------------------- release
    def release(self, req: str):
        """Delayed release: blocks return to the Free List only."""
        for pbn in self.block_tables.pop(req, []):
            self.free_list.append(pbn)
        self.seq_lens.pop(req, None)

    def finish_instance(self):
        """Instance complete: return every KV region to the pool collectively."""
        for off in self.region_offsets:
            self.store.pool.free(off)
        self.region_offsets.clear()
        self._region_bytes = 0
        self.free_list.clear()
        self.block_tables.clear()
        self.addr.clear()
        self.seq_lens.clear()

    # ---------------------------------------------------------------- lookup
    def physical_addresses(self, req: str) -> list[int]:
        return [self.addr[pbn] for pbn in self.block_tables[req]]

    # ------------------------------------------------------------- migration
    def snapshot(self, req: str, reader=None) -> KVSnapshot:
        """Serialize one live request for migration (DESIGN.md §16).

        ``reader(pool_offset, lbn)`` returns the payload of the block at
        ``pool_offset`` (logical block ``lbn``); the payloads land in
        :attr:`KVSnapshot.pages` in logical order, so the restore side never
        needs the source's PBNs or pool layout.  Without a reader the pages
        are ``None`` placeholders (metadata-only snapshot — the modeled
        plane prices from geometry alone).  The request stays live on this
        KV; the caller releases it once the handoff commits.
        """
        table = self.block_tables[req]
        addrs = [self.addr[pbn] for pbn in table]
        pages = tuple(reader(off, lbn) if reader is not None else None
                      for lbn, off in enumerate(addrs))
        return KVSnapshot(req=req, seq_len=self.seq_lens[req],
                          block_tokens=self.block_tokens,
                          kv_bytes_per_token=(self.block_bytes
                                              // self.block_tokens),
                          pages=pages)

    def restore(self, req: str, snap: KVSnapshot, writer=None) -> list[int]:
        """Re-materialize a snapshot on THIS KV: allocate a fresh block
        table covering ``snap.seq_len`` tokens and write each page payload
        to its new pool offset via ``writer(pool_offset, payload)``.
        Returns the new block table.  Geometry must match the snapshot's —
        a block-size mismatch would silently shear pages across blocks.
        """
        if (snap.block_tokens != self.block_tokens
                or snap.block_tokens * snap.kv_bytes_per_token
                != self.block_bytes):
            raise ValueError(
                f"KV geometry mismatch: snapshot ({snap.block_tokens} tok x "
                f"{snap.kv_bytes_per_token} B/tok) vs pool "
                f"({self.block_tokens} tok, {self.block_bytes} B/block)")
        if req in self.block_tables:
            raise ValueError(f"request {req!r} already live on this KV")
        self.ensure({req: snap.seq_len})
        table = self.block_tables[req]
        if len(table) != snap.num_blocks:
            raise ValueError(
                f"snapshot holds {snap.num_blocks} blocks but "
                f"{snap.seq_len} tokens need {len(table)}")
        if writer is not None:
            for lbn, pbn in enumerate(table):
                writer(self.addr[pbn], snap.pages[lbn])
        return table
