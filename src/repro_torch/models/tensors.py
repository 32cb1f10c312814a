"""Bridge between model parameter trees and Tangram tensor records (port of
`repro/models/tensors.py`).

A parameter tree is nested dicts / lists / tuples of torch tensors.  Each
leaf becomes one named tensor; `flatten_params` walks the tree in the order
`jax.tree.leaves` walks the reference's tree (dict keys sorted, sequences in
index order), so records, host-store buffers and device buffers line up
leaf for leaf with the reference's.  Registration uses trees of ``meta``
tensors: shapes and dtypes without bytes, the role `jax.eval_shape` plays in
the reference.

Host buffers are CPU torch tensors (numpy has no bfloat16 without
ml_dtypes); `HostTensorStore(pin_memory=True)` keeps them in page-locked
memory so the engine's chunked h2d copies run asynchronously.  Record dtypes
use numpy-style names ("bfloat16", "float32") exactly as the reference's.
"""
from __future__ import annotations

import enum
import hashlib
import logging
import time as _time
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.stats import HostStoreStats

log = logging.getLogger(__name__)


class StoreError(RuntimeError):
    """A persistent-store read could not be satisfied (after retries)."""


class StoreReadError(StoreError):
    """Transient read failure — retryable with backoff."""


class StoreCorruptionError(StoreError):
    """Blob failed its crc32 integrity check — NOT retryable (the blob is
    corrupt in place); the caller must quarantine and re-materialize."""


@dataclass(frozen=True)
class TensorRecord:
    name: str  # tree path, e.g. "segments/0/1/attn/wq"
    shape: tuple[int, ...]
    dtype: str
    fingerprint: str
    nbytes: int


# ------------------------------------------------------------ tree plumbing
def flatten_params(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(leaf_path, leaf) pairs in `jax.tree.leaves` order: dict keys sorted,
    list/tuple entries by index, anything else is a leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_params(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out.extend(flatten_params(sub, f"{prefix}{i}/"))
        return out
    return [(prefix[:-1], tree)]


def tree_structure(tree):
    """The tree with every leaf replaced by None (the port's treedef)."""
    if isinstance(tree, dict):
        return {k: tree_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_structure(v) for v in tree)
    return None


def tree_unflatten(structure, leaves: Sequence[Any]):
    """Inverse of `flatten_params` over a `tree_structure` skeleton."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(structure)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def leaf_path(path) -> str:
    """Stable "/"-joined name of one tree path (a sequence of dict keys and
    list indices) — the record name sans the model-id prefix."""
    return "/".join(str(p) for p in path)


def dtype_name(dtype: torch.dtype) -> str:
    """numpy-style dtype name of a torch dtype ("bfloat16", "float32")."""
    return str(dtype).removeprefix("torch.")


def as_cpu_tensor(arr) -> torch.Tensor:
    """A CPU tensor of a tensor or of a numpy array of a numpy-native dtype."""
    if not isinstance(arr, torch.Tensor):
        arr = torch.from_numpy(np.ascontiguousarray(arr))
    return arr.detach().to("cpu")


def tensor_bytes(t: torch.Tensor) -> bytes:
    """The tensor's raw bytes in row-major order (any dtype, bf16 included)."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def fingerprint_of(model_id: str, name: str, shape, dtype, shard: str = "") -> str:
    h = hashlib.sha1(f"{model_id}|{name}|{tuple(shape)}|{dtype}|{shard}".encode())
    return h.hexdigest()[:16]


def content_fingerprint(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return hashlib.sha1(tensor_bytes(arr)).hexdigest()[:16]
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


class FingerprintPolicy(str, enum.Enum):
    """How a model's leaves derive their tensor identity (DESIGN.md §17)."""

    IDENTITY = "identity"
    CONTENT = "content"
    CONTENT_BASE_HINT = "content-with-base-hint"


def _segments_match(name: str, pattern: str) -> bool:
    """`pattern`'s "/"-segments appear as a contiguous run of `name`'s —
    "t1" matches "blk/t1" but NOT "blk/t10"; "attn/wq" matches
    "segments/0/attn/wq"."""
    ns, ps = name.split("/"), pattern.split("/")
    if len(ps) > len(ns):
        return False
    return any(ns[i:i + len(ps)] == ps for i in range(len(ns) - len(ps) + 1))


@dataclass(frozen=True)
class ModelSpec:
    """Declarative model identity: the one object registration flows carry.

    For `FingerprintPolicy.CONTENT_BASE_HINT`, `base_id` names the base model
    and `delta_names` the leaf subset (segment-wise patterns, see
    `is_delta`) that differs from it — every other leaf fingerprints under
    the base's identity and thus dedups with the base and all sibling
    variants in every tier.
    """

    model_id: str
    policy: FingerprintPolicy = FingerprintPolicy.IDENTITY
    base_id: Optional[str] = None
    delta_names: tuple[str, ...] = ()
    shard: str = ""

    def __post_init__(self):
        object.__setattr__(self, "policy", FingerprintPolicy(self.policy))
        object.__setattr__(self, "delta_names", tuple(self.delta_names))
        if self.policy is FingerprintPolicy.CONTENT_BASE_HINT:
            if not self.base_id:
                raise ValueError(
                    "content-with-base-hint requires base_id "
                    f"(model {self.model_id!r})")
            if self.base_id == self.model_id:
                raise ValueError(f"model {self.model_id!r} cannot be its "
                                 "own base")
        elif self.base_id is not None:
            raise ValueError(f"base_id set on {self.model_id!r} but policy "
                             f"is {self.policy.value!r}")

    def is_delta(self, name: str) -> bool:
        """Leaf `name` belongs to the variant's own (non-shared) subset."""
        return any(_segments_match(name, d) for d in self.delta_names)

    def leaf_fingerprint(self, name: str, shape, dtype,
                         leaf=None) -> str:
        if self.policy is FingerprintPolicy.CONTENT and _has_bytes(leaf):
            return content_fingerprint(leaf)
        if (self.policy is FingerprintPolicy.CONTENT_BASE_HINT
                and not self.is_delta(name)):
            # shared-with-base leaf: the base's identity IS the content
            # identity, derivable from shapes alone — no bytes needed
            return fingerprint_of(self.base_id, name, shape, dtype,
                                  self.shard)
        return fingerprint_of(self.model_id, name, shape, dtype, self.shard)


def _has_bytes(leaf) -> bool:
    """A real array (not a meta-tensor shape stand-in)."""
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_meta
    return isinstance(leaf, np.ndarray)


@dataclass(frozen=True)
class VariantSpec:
    """A fine-tune variant: base model + the leaf subset that differs."""

    variant_id: str
    base_id: str
    delta_names: tuple[str, ...]

    def to_model_spec(self, *, shard: str = "") -> ModelSpec:
        return ModelSpec(self.variant_id,
                         policy=FingerprintPolicy.CONTENT_BASE_HINT,
                         base_id=self.base_id,
                         delta_names=tuple(self.delta_names), shard=shard)


def tensor_records_for(spec: ModelSpec, params) -> list[TensorRecord]:
    """Flatten a parameter tree (real or meta tensors) to tensor records
    under `spec`'s fingerprint policy (every record comes from here)."""
    recs = []
    for name, leaf in flatten_params(params):
        shape = tuple(leaf.shape)
        dtype = dtype_name(leaf.dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * leaf.element_size()
        fp = spec.leaf_fingerprint(name, shape, dtype, leaf)
        recs.append(TensorRecord(name=f"{spec.model_id}/{name}", shape=shape,
                                 dtype=dtype, fingerprint=fp, nbytes=nbytes))
    return recs


def tensor_records(model: Union[ModelSpec, str], params, *,
                   shard: str = "") -> list[TensorRecord]:
    """Tensor records for `model` — a `ModelSpec`, or a bare model-id string
    (identity policy).  The reference's deprecated ``mode=`` keyword is not
    carried over."""
    if isinstance(model, ModelSpec):
        spec = model
        if shard and shard != spec.shard:
            spec = ModelSpec(spec.model_id, policy=spec.policy,
                             base_id=spec.base_id,
                             delta_names=spec.delta_names, shard=shard)
        return tensor_records_for(spec, params)
    return tensor_records_for(ModelSpec(model, shard=shard), params)


class PersistentStore:
    """Bottom tier of the model-store hierarchy: serialized checkpoint
    buffers keyed by fingerprint (DESIGN.md §11).

    Reads rebuild a CPU tensor from the serialized blob and — when
    `store_bw` is set — are throttled to `nbytes / store_bw` wall seconds.
    Every blob carries its crc32, verified on every read; a corrupt blob
    raises `StoreCorruptionError`.  `faults` is an optional `FaultInjector`
    consulted at the ``store.read`` point (keyed by fingerprint).
    """

    def __init__(self, *, store_bw: Optional[float] = None, faults=None):
        # fingerprint -> (raw bytes, torch dtype, shape, crc32)
        self._blobs: dict[str, tuple[bytes, torch.dtype, tuple[int, ...], int]] = {}
        self.store_bw = store_bw
        self.faults = faults  # FaultInjector or None (chaos plane)
        self._nbytes = 0
        self.bytes_written = 0  # cumulative spill traffic (host -> store)
        self.bytes_read = 0  # cumulative promote traffic (store -> host)
        self.read_errors = 0  # transient read failures raised (injected)
        self.checksum_failures = 0  # crc32 mismatches detected on read
        self.quarantined = 0  # blobs dropped as unrecoverable
        self.bytes_quarantined = 0  # bytes of those blobs

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._blobs

    def __len__(self) -> int:
        return len(self._blobs)

    def nbytes(self) -> int:
        return self._nbytes

    def put(self, fingerprint: str, arr):
        arr = as_cpu_tensor(arr)
        raw = tensor_bytes(arr)
        prev = self._blobs.get(fingerprint)
        if prev is not None:
            self._nbytes -= len(prev[0])
        self._blobs[fingerprint] = (raw, arr.dtype, tuple(arr.shape),
                                    zlib.crc32(raw))
        self._nbytes += len(raw)
        self.bytes_written += len(raw)

    def _read(self, fingerprint: str, raw: bytes, dtype: torch.dtype,
              shape: tuple[int, ...], crc: int) -> torch.Tensor:
        t0 = _time.perf_counter()
        if self.faults is not None:
            spec = self.faults.fire("store.read", key=fingerprint)
            if spec is not None:
                if spec.mode == "corrupt":
                    self.corrupt(fingerprint)
                    raw = self._blobs[fingerprint][0]
                else:
                    self.read_errors += 1
                    raise StoreReadError(
                        f"injected transient read error for {fingerprint}")
        if zlib.crc32(raw) != crc:
            self.checksum_failures += 1
            raise StoreCorruptionError(
                f"crc32 mismatch for {fingerprint} ({len(raw)} bytes)")
        arr = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        arr = arr.view(dtype).reshape(shape)
        self.bytes_read += len(raw)
        if self.store_bw:
            budget = len(raw) / self.store_bw
            remaining = budget - (_time.perf_counter() - t0)
            if remaining > 0:
                _time.sleep(remaining)
        return arr

    def get(self, fingerprint: str) -> torch.Tensor:
        raw, dtype, shape, crc = self._blobs[fingerprint]
        return self._read(fingerprint, raw, dtype, shape, crc)

    def pop(self, fingerprint: str) -> torch.Tensor:
        """Promoting read: return the tensor and drop the blob, so every
        fingerprint stays resolvable from exactly one tier.  The blob is
        dropped only AFTER the read verifies."""
        raw, dtype, shape, crc = self._blobs[fingerprint]
        arr = self._read(fingerprint, raw, dtype, shape, crc)
        del self._blobs[fingerprint]
        self._nbytes -= len(raw)
        return arr

    def corrupt(self, fingerprint: str) -> bool:
        """Flip one byte of a stored blob (chaos plane / tests)."""
        ent = self._blobs.get(fingerprint)
        if ent is None:
            return False
        raw, dtype, shape, crc = ent
        flipped = bytes([raw[0] ^ 0xFF]) + raw[1:]
        self._blobs[fingerprint] = (flipped, dtype, shape, crc)
        return True

    def quarantine(self, fingerprint: str) -> bool:
        """Drop an unrecoverable blob so the fingerprint becomes
        unresolvable — the engine's `init_fn` fallback re-materializes it."""
        ent = self._blobs.pop(fingerprint, None)
        if ent is None:
            return False
        self._nbytes -= len(ent[0])
        self.quarantined += 1
        self.bytes_quarantined += len(ent[0])
        log.warning("persistent store: quarantined blob %s (%d bytes)",
                    fingerprint, len(ent[0]))
        return True


class HostTensorStore:
    """Per-tensor host-side Model Store keyed by fingerprint (DESIGN.md §10).

    Same tiers, pins, LRU, keep-alive and retry policy as the reference;
    buffers are CPU torch tensors, page-locked when `pin_memory` is set (the
    engine sets it when its device is CUDA, so h2d chunks copy
    asynchronously).  Byte accounting is incremental.
    """

    def __init__(self, capacity_bytes: Optional[int] = None, *,
                 spill: Optional[PersistentStore] = None,
                 keep_alive_s: Optional[float] = None,
                 retry_max: int = 3, retry_base_s: float = 0.01,
                 retry_cap_s: float = 0.08, pin_memory: bool = False):
        self._bufs: "OrderedDict[str, torch.Tensor]" = OrderedDict()  # LRU order
        self.capacity_bytes = capacity_bytes
        self.spill = spill if spill is not None else PersistentStore()
        self.keep_alive_s = keep_alive_s
        self.retry_max = retry_max
        self.retry_base_s = retry_base_s
        self.retry_cap_s = retry_cap_s
        self.pin_memory = pin_memory
        self._last_access: dict[str, float] = {}  # fp -> monotonic seconds
        self._pins: dict[str, int] = {}  # fingerprint -> refcount
        self._nbytes = 0  # incremental: sum of resident buffer bytes
        self._pinned_nbytes = 0  # incremental: resident AND pinned bytes
        self.leaves_stored = 0  # cumulative leaves materialized into the store
        self.evictions = 0  # cumulative host -> store spills
        self.bytes_spilled = 0  # cumulative bytes of those spills
        self.promotions = 0  # cumulative store -> host promotes
        self.expirations = 0  # cumulative keep-alive-aged spills
        self.read_retries = 0  # transient spill-read errors retried
        self.quarantines = 0  # spill blobs given up on (corrupt/exhausted)
        self.pressure_evictions = 0  # spills forced by set_capacity_bytes

    def __contains__(self, fingerprint: str) -> bool:
        return fingerprint in self._bufs

    def __len__(self) -> int:
        return len(self._bufs)

    def resolvable(self, fingerprint: str) -> bool:
        """Fingerprint lives in SOME tier (host or persistent store)."""
        return fingerprint in self._bufs or fingerprint in self.spill

    def get(self, fingerprint: str) -> torch.Tensor:
        """Host-tier read; touches LRU recency.  KeyError on a host miss —
        use `fetch` to promote from the spill tier."""
        buf = self._bufs[fingerprint]
        self._bufs.move_to_end(fingerprint)
        self._touch(fingerprint)
        return buf

    def _touch(self, fingerprint: str):
        if self.keep_alive_s is not None:
            self._last_access[fingerprint] = _time.monotonic()

    def age(self, now: Optional[float] = None) -> int:
        """Keep-alive sweep: spill unpinned host-resident tensors idle longer
        than `keep_alive_s`.  Returns spill count."""
        if self.keep_alive_s is None:
            return 0
        if now is None:
            now = _time.monotonic()
        expired = [fp for fp in self._bufs
                   if (now - self._last_access.get(fp, now) > self.keep_alive_s
                       and not self.pinned(fp))]
        for fp in expired:
            self._spill_one(fp)
            self.expirations += 1
        return len(expired)

    def fetch(self, fingerprint: str) -> torch.Tensor:
        """Resolve from the hierarchy: host hit is a dict lookup; a spill-tier
        hit promotes the tensor back into the host cache.  Transient read
        errors retry with capped exponential backoff; corruption or
        exhausted retries quarantine the blob and raise `StoreError`."""
        if fingerprint in self._bufs:
            return self.get(fingerprint)
        attempt = 0
        while True:
            try:
                arr = self.spill.pop(fingerprint)
                break
            except StoreCorruptionError:
                self.spill.quarantine(fingerprint)
                self.quarantines += 1
                raise
            except StoreReadError as e:
                attempt += 1
                self.read_retries += 1
                if attempt > self.retry_max:
                    self.spill.quarantine(fingerprint)
                    self.quarantines += 1
                    raise StoreError(
                        f"read of {fingerprint} failed after "
                        f"{attempt} attempts") from e
                _time.sleep(min(self.retry_cap_s,
                                self.retry_base_s * (2 ** (attempt - 1))))
        self.promotions += 1
        return self._admit(fingerprint, arr)

    def put(self, fingerprint: str, arr) -> bool:
        """Admit one materialized leaf (a tensor, or a numpy array of a
        numpy-native dtype).  A fingerprint already resolvable in either tier
        is skipped; returns whether the leaf was newly stored."""
        if self.resolvable(fingerprint):
            return False
        self._admit(fingerprint, as_cpu_tensor(arr))
        self.leaves_stored += 1
        return True

    def put_tree(self, records: Sequence[TensorRecord], params) -> int:
        """Store every leaf of `params` under its record's fingerprint.
        Returns the number of leaves newly materialized."""
        leaves = [leaf for _, leaf in flatten_params(params)]
        assert len(leaves) == len(records), "record/leaf count mismatch"
        return sum(self.put(r.fingerprint, leaf)
                   for r, leaf in zip(records, leaves))

    # ------------------------------------------------------------- pinning
    def pin(self, fingerprint: str):
        """Refcount-pin: a pinned tensor is never spilled."""
        n = self._pins.get(fingerprint, 0)
        self._pins[fingerprint] = n + 1
        if n == 0 and fingerprint in self._bufs:
            self._pinned_nbytes += self._bufs[fingerprint].nbytes

    def unpin(self, fingerprint: str):
        n = self._pins.get(fingerprint, 0)
        if n <= 1:
            self._pins.pop(fingerprint, None)
            if n == 1 and fingerprint in self._bufs:
                self._pinned_nbytes -= self._bufs[fingerprint].nbytes
            self._enforce_cap()  # released bytes become evictable NOW
        else:
            self._pins[fingerprint] = n - 1

    def pinned(self, fingerprint: str) -> bool:
        return self._pins.get(fingerprint, 0) > 0

    # ------------------------------------------------------ tenant pressure
    def set_capacity_bytes(self, capacity_bytes: Optional[int]) -> int:
        """Resize the host-tier byte budget; pinned tensors are exempt.
        Returns the bytes spilled."""
        before = self.bytes_spilled
        ev0 = self.evictions
        self.capacity_bytes = capacity_bytes
        self._enforce_cap()
        self.pressure_evictions += self.evictions - ev0
        return self.bytes_spilled - before

    # ------------------------------------------------------------ eviction
    def evict(self, fingerprint: str) -> bool:
        """Spill one host-resident tensor to the persistent tier.  Refuses
        (returns False) for pinned or non-resident fingerprints."""
        if fingerprint not in self._bufs or self.pinned(fingerprint):
            return False
        self._spill_one(fingerprint)
        return True

    def _spill_one(self, fingerprint: str):
        buf = self._bufs.pop(fingerprint)
        self._last_access.pop(fingerprint, None)
        self._nbytes -= buf.nbytes
        self.spill.put(fingerprint, buf)
        self.evictions += 1
        self.bytes_spilled += buf.nbytes

    def _enforce_cap(self):
        if self.capacity_bytes is None:
            return
        while (self._nbytes > self.capacity_bytes
               and self._nbytes > self._pinned_nbytes):
            victim = next((fp for fp in self._bufs if not self.pinned(fp)),
                          None)  # oldest unpinned = LRU order
            if victim is None:
                return  # only pinned bytes remain: over-cap is allowed
            self._spill_one(victim)

    def _admit(self, fingerprint: str, arr: torch.Tensor) -> torch.Tensor:
        if self.pin_memory and not arr.is_pinned():
            arr = arr.pin_memory()
        self._bufs[fingerprint] = arr
        self._bufs.move_to_end(fingerprint)
        self._touch(fingerprint)
        self._nbytes += arr.nbytes
        if self.pinned(fingerprint):
            self._pinned_nbytes += arr.nbytes
        self._enforce_cap()
        return arr

    # ---------------------------------------------------------------- stats
    def nbytes(self) -> int:
        return self._nbytes

    def pinned_nbytes(self) -> int:
        return self._pinned_nbytes

    def unpinned_nbytes(self) -> int:
        return self._nbytes - self._pinned_nbytes

    def snapshot(self) -> HostStoreStats:
        """Typed counter snapshot (the `repro_torch.stats` schema)."""
        return HostStoreStats(
            resident_bytes=self._nbytes,
            pinned_bytes=self._pinned_nbytes,
            leaves_stored=self.leaves_stored,
            evictions=self.evictions,
            bytes_spilled=self.bytes_spilled,
            promotions=self.promotions,
            expirations=self.expirations,
            read_retries=self.read_retries,
            quarantines=self.quarantines,
            pressure_evictions=self.pressure_evictions)


def spec_records(model: Union[ModelSpec, str], cfg, *,
                 shard: str = "") -> list[TensorRecord]:
    """Tensor records from config alone (no allocation): meta tensors."""
    from repro_torch.models.api import build_model

    return tensor_records(model, build_model(cfg).param_specs(), shard=shard)
