"""Single-host serving engine: the *data plane* of Tangram (port of
`repro/serving/engine.py`, main path).

Holds real device tensors for pool-resident models (retaining the device
tensor IS the reuse mechanism, as under JAX — DESIGN.md §2), a real paged KV
slab indexed by ElasticKV's physical block numbers, and decodes through the
E-Attention paged kernel (`kernels/paged_attention.py`, CUDA on the card).

Fast paths (DESIGN.md §10), as in the reference:
  * **Tensor-granular loading** — `Engine.load` materializes only missed
    leaves into the host Model Store (pinned CPU tensors on CUDA) and
    streams exactly the missed tensors host→device through a chunked
    pipeline: each chunk is copied from the pinned host tensor straight into
    its row slice of a preallocated device tensor on a dedicated copy
    stream, with at most `depth` chunks in flight (CUDA events).
  * **Sync-free decode** — per-sequence lengths are mirrored host-side, so a
    decode step reads nothing back from the device: block tables are
    re-uploaded (pinned staging buffer, asynchronous h2d) only on steps where
    ElasticKV maps a new block, prefill KV lands in the slab as ONE in-place
    `index_copy_`, and `Engine.decode_many` fuses same-model instances into
    one dispatch.

Where the reference donates buffers to a jitted scatter, the port updates
the shared slab in place.  `SharedKVSlab.grow` reallocates, so every holder
re-reads `slab.k_pages` / `slab.v_pages` at each use.

The control plane's engine surface is ported too: `crash`, `fault_summary`,
`prewarm`, `host_resident_bytes`, `host_free_bytes` and `set_host_capacity`
(the `serverless` gateways and `core.engine_api` call them).  One rule is
the port's own: what the pool evicts leaves the card.  `load` frees the
evicted buffers once the pool has made room, and `release` and
`finish_instance` free those a model in use kept (the reference holds every
evicted buffer until a caller runs `sync_evictions`).  On CUDA, `crash`
drains the copy stream, joins the prefetch worker and drops every device
reference (live instances' included) before it swaps the state, so the
card's memory comes back.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with ``device="cuda"`` and no card the engine raises.
Not ported yet: `migrate_out` / `migrate_in` and `register_variant`.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time as _time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import PhaseCosts, paper_l40
from repro_torch.core.elastic_kv import ElasticKV
from repro_torch.core.faults import FaultInjector
from repro_torch.core.reuse_store import LoadReport, ReuseStore
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model, lm
from repro_torch.models import common as cmod
from repro_torch.models import layers as Lmod
from repro_torch.models.common import resolve_device, rms_norm
from repro_torch.models.tensors import (HostTensorStore, ModelSpec, PersistentStore,
                                        StoreError, TensorRecord, tensor_records,
                                        tree_structure, tree_unflatten)
from repro_torch.obs import NULL_TRACER, BoundedLog
from repro_torch.stats import EngineFaultStats, snapshot_dict

log = logging.getLogger(__name__)


class TransferError(RuntimeError):
    """A host→device chunk transfer failed (after its bounded retries)."""


class TransferTimeout(TransferError):
    """The chunked transfer blew its wall-clock deadline (stalled h2d)."""


class WorkerDeath(RuntimeError):
    """Injected prefetch-worker death (chaos plane): kills the worker loop;
    the supervisor restarts it and the in-flight job fails over."""


@dataclass
class RegisteredModel:
    model_id: str
    cfg: ModelConfig
    records: list[TensorRecord]
    init_fn: Callable[[], Any]  # materializes the full param tree (once, ever)
    treedef: Any  # tree structure matching `records` leaf order
    # identity policy the records were fingerprinted under (DESIGN.md §17);
    # None only for pre-§17 constructions that bypassed register_model
    spec: Optional[ModelSpec] = None


@dataclass
class DataLoadStats:
    """Data-plane accounting for one `Engine.load` call.

    The per-tier counters expose the three-way load path (DESIGN.md §11):
    every record lands in exactly one of device-pool hit / host-cache hit /
    store promote, so `bytes_device_hit + bytes_host_hit + bytes_store`
    equals the model's total bytes on every load after the first (on the
    first-ever cold load, never-seen leaves are materialized by `init_fn`
    and counted by `leaves_materialized` instead).
    """

    leaves_materialized: int = 0  # init_fn leaves newly written to host store
    init_seconds: float = 0.0  # host materialization wall time
    tensors_device_hit: int = 0  # device-pool tier: buffer already resident
    bytes_device_hit: int = 0
    tensors_host_hit: int = 0  # host tier: h2d transfer only
    bytes_host_hit: int = 0
    tensors_store: int = 0  # store tier: promote (store_bw) then h2d
    bytes_store: int = 0
    store_seconds: float = 0.0  # store -> host promotion wall time
    # prefetch pipeline (DESIGN.md §12): promotions a joined hint already
    # paid for before this load reached the store tier.  They surface as
    # host hits above; total store traffic for the load is therefore
    # bytes_store + bytes_prefetched (overlap, not avoidance).
    tensors_prefetched: int = 0
    bytes_prefetched: int = 0
    prefetch_wait_seconds: float = 0.0  # time blocked joining the hint
    tensors_h2d: int = 0
    bytes_h2d: int = 0
    chunks_h2d: int = 0
    transfer_seconds: float = 0.0  # chunked-pipeline wall time (blocked)
    # param-tree assembly (unflatten over resident buffers): the engine's
    # equivalent of the paper's Profile phase memory-plan step.  Reported
    # separately so the real plane's TTFT split has the same vocabulary as
    # the sim plane (queue/init/load/profile/prefill).
    profile_seconds: float = 0.0
    total_seconds: float = 0.0
    # chaos-plane outcomes for THIS load (DESIGN.md §15); the engine-lifetime
    # ledger lives in `Engine.fault_summary()`
    store_retries: int = 0  # transient store reads retried with backoff
    tensors_quarantined: int = 0  # store blobs given up on (corrupt/exhausted)
    tensors_reinit: int = 0  # quarantined tensors re-materialized via init_fn
    h2d_retries: int = 0  # failed h2d chunks retried
    transfer_timeouts: int = 0  # chunked-transfer deadline hits (retried)
    prefetch_failover: bool = False  # joined a dead/failed hint, went inline

    def as_dict(self) -> dict[str, Any]:
        """Stable field->value snapshot (repro.stats convention): the one
        serialization benchmarks/report sinks consume."""
        return snapshot_dict(self)


@dataclass
class FaultStats:
    """Engine-lifetime fault/recovery ledger (DESIGN.md §15).

    Every chaos-plane injection must surface here (or in the tier stores'
    own counters, merged by `Engine.fault_summary`): fig17 balances
    injected == handled + quarantined + failed-over, so nothing may be
    swallowed.  `store_retries`/`store_quarantines` accumulate the host
    tier's counters across `Engine.crash()` (which replaces the store
    objects); the live totals are the sum of both.
    """

    h2d_retries: int = 0  # failed h2d chunks retried (incl. final failures)
    h2d_stalls: int = 0  # injected chunk stalls absorbed
    transfer_timeouts: int = 0  # transfer deadline hits
    prefetch_errors: int = 0  # promotions that raised (job degraded)
    worker_restarts: int = 0  # prefetch worker deaths -> supervisor restarts
    join_failovers: int = 0  # loads that joined a dead/failed hint, went inline
    load_errors: int = 0  # Engine.load unwinds (pin hygiene path)
    shutdown_join_timeouts: int = 0  # close() left a hung worker behind
    prefetch_pins_dropped: int = 0  # in-flight hints' pins released at crash()
    tensors_reinit: int = 0  # quarantined tensors re-materialized
    store_retries: int = 0  # host-tier read retries folded in at crash()
    store_quarantines: int = 0  # host-tier quarantines folded in at crash()


class ChunkedTransfer:
    """Chunked host→device transfer pipeline.

    Large tensors are split into ~`chunk_bytes` row slices, each copied from
    the host tensor straight into its row slice of a device tensor allocated
    up front; at most `depth` chunks are in flight at once.  On CUDA the
    copies run on a dedicated stream (asynchronous from pinned host memory)
    and `depth` waits on per-chunk CUDA events; `transfer` returns with that
    stream synchronized, so the caller's wall time is real h2d time.  Chunk
    counts (`rows_per`, `chunks_h2d`) are computed exactly as the reference
    computes them.

    Failure-hardened as in the reference: each chunk copy retries up to
    `max_retries` times on `TransferError`, and with `timeout_s` set the
    whole call has a wall-clock deadline.  `faults` is the optional injector
    consulted per chunk attempt (``h2d.chunk``).
    """

    def __init__(self, *, device="cuda", chunk_bytes: int = 16 << 20, depth: int = 2,
                 max_retries: int = 2, timeout_s: Optional[float] = None,
                 faults: Optional[FaultInjector] = None,
                 fault_stats: Optional[FaultStats] = None,
                 tracer=NULL_TRACER, track: str = "h2d"):
        assert depth >= 1
        self.device = resolve_device(device)
        self.chunk_bytes = chunk_bytes
        self.depth = depth
        self.max_retries = max_retries
        self.timeout_s = timeout_s
        self.faults = faults
        self.fault_stats = fault_stats
        self.tracer = tracer
        self.track = track
        self._stream: Optional[torch.cuda.Stream] = None  # created on first use

    def _copy_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def drain(self):
        """Wait for every chunk queued on the copy stream (no-op on the CPU
        and before the first transfer)."""
        if self._stream is not None:
            self._stream.synchronize()

    def _put(self, dst: torch.Tensor, host_slice: torch.Tensor,
             stats: Optional[DataLoadStats]):
        """One chunk's h2d with bounded retries (each attempt re-consults
        the injector, so the occurrence schedule is over put ATTEMPTS)."""
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    spec = self.faults.fire("h2d.chunk")
                    if spec is not None:
                        if spec.mode == "stall":
                            if self.fault_stats is not None:
                                self.fault_stats.h2d_stalls += 1
                            _time.sleep(spec.delay_s)
                        else:
                            raise TransferError("injected h2d chunk failure")
                if self.tracer.enabled:
                    with self.tracer.span("h2d.chunk", track=self.track,
                                          cat="h2d"):
                        dst.copy_(host_slice, non_blocking=True)
                        return
                dst.copy_(host_slice, non_blocking=True)
                return
            except TransferError as e:
                attempt += 1
                if self.fault_stats is not None:
                    self.fault_stats.h2d_retries += 1
                if stats is not None:
                    stats.h2d_retries += 1
                if attempt > self.max_retries:
                    raise
                log.warning("h2d chunk failed (attempt %d/%d): %s",
                            attempt, self.max_retries, e)

    def transfer(self, items: Sequence[tuple[str, torch.Tensor]],
                 stats: Optional[DataLoadStats] = None) -> dict[str, torch.Tensor]:
        cuda = self.device.type == "cuda"
        # destinations are allocated on the caller's stream, which the copy
        # stream then waits on: a block the allocator recycled from earlier
        # work on that stream is not overwritten while still being read
        out = {fp: torch.empty(host.shape, dtype=host.dtype, device=self.device)
               for fp, host in items}
        stream = self._copy_stream() if cuda else None
        if cuda:
            stream.wait_stream(torch.cuda.current_stream(self.device))
        inflight: deque[torch.cuda.Event] = deque()
        deadline = (_time.perf_counter() + self.timeout_s
                    if self.timeout_s is not None else None)

        def push():
            if cuda:
                ev = torch.cuda.Event()
                ev.record(stream)
                inflight.append(ev)
                while len(inflight) > self.depth:
                    inflight.popleft().synchronize()
            if deadline is not None and _time.perf_counter() > deadline:
                if self.fault_stats is not None:
                    self.fault_stats.transfer_timeouts += 1
                if stats is not None:
                    stats.transfer_timeouts += 1
                raise TransferTimeout(
                    f"chunked transfer exceeded {self.timeout_s:.1f}s")

        ctx = torch.cuda.stream(stream) if cuda else contextlib.nullcontext()
        try:
            with ctx:
                for fp, host in items:
                    dst = out[fp]
                    nrows = host.shape[0] if host.dim() else 0
                    if host.nbytes <= self.chunk_bytes or nrows < 2:
                        self._put(dst, host, stats)
                        push()
                        nchunks = 1
                    else:
                        rows_per = max(1, int(self.chunk_bytes //
                                              max(1, host.nbytes // nrows)))
                        nchunks = 0
                        for s in range(0, nrows, rows_per):
                            self._put(dst[s : s + rows_per], host[s : s + rows_per],
                                      stats)
                            push()
                            nchunks += 1
                    if stats is not None:
                        stats.tensors_h2d += 1
                        stats.bytes_h2d += host.nbytes
                        stats.chunks_h2d += nchunks
        finally:
            if cuda:
                stream.synchronize()
        return out


@dataclass(eq=False)  # identity semantics: the scheduler holds THIS job
class PrefetchJob:
    """One hinted model's store->host promotion batch.

    ``deadlines`` parallels ``fingerprints``: for each spilled tensor, the
    bytes the joining load's chunked h2d traversal must move BEFORE it
    reaches that tensor (its promotion deadline, in bytes).  The worker
    promotes the globally earliest deadline across all in-flight jobs, so
    when several hints race one store the un-hidden tail of each load
    shrinks — FIFO whole-model order would finish one model's read while
    another load's first tensor (deadline 0) sat unpromoted."""

    model_id: str
    fingerprints: list[str]
    deadlines: list[float] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    owns_pin: bool = False  # the hint (not a load) created the model pin
    promoted: list = field(default_factory=list)  # (fp, nbytes) actually read
    tensors_promoted: int = 0
    bytes_promoted: int = 0
    cancelled: bool = False
    started: bool = False  # the worker promoted (or is promoting) a tensor
    urgent: bool = False  # a load joined: drain this job ahead of deadlines
    failed: bool = False  # promotion raised / worker died: joiners fail over
    cursor: int = 0  # next fingerprint index

    def __post_init__(self):
        if len(self.deadlines) != len(self.fingerprints):
            # direct submit() without deadlines: submission order stands in
            self.deadlines = [float(i) for i in range(len(self.fingerprints))]

    def next_deadline(self) -> float:
        return self.deadlines[self.cursor]

    def exhausted(self) -> bool:
        return self.cursor >= len(self.fingerprints)


class Prefetcher:
    """Background store->host promotion pipeline (DESIGN.md §12).

    One daemon worker per engine (spawned lazily on the first hint) drains
    per-model `PrefetchJob`s against the engine's tiered model store, so the
    store_bw-limited read runs DURING queueing/init/h2d of already-resident
    tensors instead of extending `Engine.load`.

    Scheduling is bytes-until-deadline priority, NOT whole-model FIFO: each
    pending tensor's deadline is the h2d prefix bytes its load must move
    before needing it (computed by `Engine.prefetch` in the chunked-transfer
    traversal order), and the worker always promotes the globally earliest
    deadline across every in-flight job.  When several hints race one
    store, the reads interleave so every load's earliest-needed tensors
    land first and the un-hidden tail shrinks fleet-wide.  A job a load has
    JOINED is urgent — drained ahead of all deadlines, since its load is
    now blocked on `job.done`.

    Safety contract: the hinted model is refcount-pinned in the host store
    BEFORE its job is enqueued (promoted bytes cannot be LRU-spilled or aged
    out from under the coming load), and every store mutation happens under
    the engine's store lock at per-tensor granularity — a concurrent
    `Engine.load` of another model interleaves between tensor promotions,
    never mid-promotion.  `Engine.load` JOINS an in-flight job (waits on its
    event and accounts its bytes) instead of re-reading the store tier.
    """

    def __init__(self, engine: "Engine"):
        self.engine = engine
        self._cv = threading.Condition()
        self._active: list[PrefetchJob] = []  # jobs with pending tensors
        self._jobs: dict[str, PrefetchJob] = {}  # model_id -> in-flight job
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._paused = False  # test seam: freeze scheduling, not submission
        self.hints = 0  # cumulative prefetch() calls
        self.joins = 0  # loads that joined an in-flight/completed job
        self.bytes_promoted = 0  # cumulative bytes moved store -> host
        self.errors = 0  # promotions that raised (job degraded to inline)
        self.restarts = 0  # worker deaths the supervisor recovered from
        self.join_timeouts = 0  # close() joins that left the worker running
        self.join_timeout_s = 5.0  # close() join budget before declaring hung
        # (model, fp) in promotion order — bounded ring with counted drops
        # (DESIGN.md §18; the old inline `del promote_log[:2048]` is gone)
        self.promote_log: BoundedLog = BoundedLog(4096)

    def close(self):
        """Stop the worker thread (idempotent).  Pending jobs complete their
        events un-promoted so no joiner can hang; the thread releases its
        engine reference — an engine that issued hints is collectable after
        `Engine.close()`.  A worker still alive after the join budget (hung
        mid-read) is COUNTED and warned about, not silently leaked."""
        with self._cv:
            self._stop = True
            for job in self._active:
                job.done.set()
            self._active.clear()
            self._cv.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=self.join_timeout_s)
            if thread.is_alive():
                self.join_timeouts += 1
                fs = getattr(self.engine, "fault_stats", None)
                if fs is not None:
                    fs.shutdown_join_timeouts += 1
                log.warning(
                    "prefetch worker still running %.1fs after close() — "
                    "leaked a hung daemon thread (engine %s)",
                    self.join_timeout_s,
                    getattr(self.engine, "engine_id", "?"))

    def pause(self):
        """Freeze deadline scheduling between tensor promotions
        (submissions still queue; URGENT jobs — ones a load has joined —
        still drain, so a pause can never deadlock `Engine.load` or
        `cancel_prefetch`).  Test seam: lets several hints accumulate so
        the deadline interleaving is deterministic to assert."""
        with self._cv:
            self._paused = True

    def resume(self):
        with self._cv:
            self._paused = False
            self._cv.notify_all()

    def submit(self, model_id: str, fingerprints: Sequence[str],
               owns_pin: bool,
               deadlines: Optional[Sequence[float]] = None) -> PrefetchJob:
        """Enqueue a promotion job (collapses onto an in-flight job for the
        same model — a duplicate hint must not double-read the store)."""
        with self._cv:
            self.hints += 1
            prev = self._jobs.get(model_id)
            if prev is not None and not prev.done.is_set():
                return prev
            if prev is not None:
                # replacing a completed-but-never-joined job: its pin was
                # never released, so ownership transfers to the new job
                # (dropping it here would leak the pin forever)
                owns_pin = owns_pin or prev.owns_pin
            job = PrefetchJob(model_id, list(fingerprints),
                              list(deadlines or ()), owns_pin=owns_pin)
            self._jobs[model_id] = job
            if not job.fingerprints or self._stop:
                job.done.set()  # nothing store-resident (or closed): pin only
                return job
            self._active.append(job)
            self._ensure_worker()
            self._cv.notify()
        return job

    def _ensure_worker(self):
        """Spawn (or respawn) the supervised worker thread.  Caller holds
        the condition lock.  A thread that died OUTSIDE the supervisor's
        recovery (only possible for non-Exception unwinds) is replaced here
        on the next submission, so a single death can never disable
        prefetching permanently."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._supervise, daemon=True, name="tangram-prefetcher")
        self._thread.start()

    def take(self, model_id: str) -> Optional[PrefetchJob]:
        """Claim the model's job for a joining load (deregisters it; the
        caller waits on `job.done` and accounts its bytes).

        A job the worker has not STARTED is withdrawn instead of waited on:
        behind other models' throttled promotions, waiting would serialize
        this load after reads it never asked for — the unhinted inline path
        is never slower, so the load falls back to it (head-of-line bypass;
        the hint's pin transfers either way).  A STARTED job is marked
        urgent instead: its remaining tensors jump every other job's
        deadlines, because a real load is now blocked on them."""
        with self._cv:
            job = self._jobs.pop(model_id, None)
            if job is None:
                return None
            if not job.started and not job.done.is_set():
                self._retire(job)  # never started: nothing promoted
                job.cancelled = True
                job.done.set()
            elif not job.done.is_set():
                job.urgent = True
                self._cv.notify()
            return job

    # ------------------------------------------------------------ worker
    def _retire(self, job: PrefetchJob):
        if job in self._active:
            self._active.remove(job)

    def _pick(self, urgent_only: bool = False) -> Optional[PrefetchJob]:
        """Earliest-deadline-first over every runnable job (urgent jobs
        first — their loads are blocked).  Retires cancelled/exhausted jobs
        on the way.  `urgent_only` still serves joined loads while the
        scheduler is paused — a pause must never deadlock an `Engine.load`
        blocked on a started job's event.  Caller holds the condition
        lock."""
        best = None
        for job in list(self._active):
            if job.cancelled or job.exhausted():
                self._retire(job)
                self._finish(job)
                continue
            if urgent_only and not job.urgent:
                continue
            if best is None or ((not best.urgent, best.next_deadline())
                                > (not job.urgent, job.next_deadline())):
                best = job
        return best

    def _finish(self, job: PrefetchJob):
        job.done.set()  # idempotent; bytes accounted per-tensor in _run

    def _supervise(self):
        """Worker supervision loop (DESIGN.md §15): an injected (or real)
        `WorkerDeath` unwinds `_run`, is counted as a restart, and the loop
        re-enters — the prefetch pipeline survives its worker dying.  The
        dying iteration's job fails over (its joiners go inline); every
        other queued job is picked up by the restarted worker."""
        while True:
            try:
                self._run()
                return  # clean _stop exit
            except Exception as e:
                with self._cv:
                    if self._stop:
                        return
                    self.restarts += 1
                fs = getattr(self.engine, "fault_stats", None)
                if fs is not None:
                    fs.worker_restarts += 1
                log.warning("prefetch worker died (%s: %s) — restarting",
                            type(e).__name__, e)

    def _run(self):
        while True:
            with self._cv:
                job = None
                while not self._stop:
                    job = self._pick(urgent_only=self._paused)
                    if job is not None:
                        break
                    self._cv.wait()
                if self._stop:
                    return
                job.started = True
                fp = job.fingerprints[job.cursor]
                job.cursor += 1
            eng = self.engine
            # getattr: tests drive the Prefetcher with duck-typed engine
            # stubs that predate the chaos and obs planes
            faults = getattr(eng, "faults", None)
            fault_stats = getattr(eng, "fault_stats", None)
            tracer = getattr(eng, "tracer", NULL_TRACER)
            try:
                if faults is not None:
                    spec = faults.fire("prefetch.worker",
                                       key=job.model_id)
                    if spec is not None:
                        raise WorkerDeath(
                            f"injected worker death on {job.model_id}/{fp}")
                # per-tensor lock scope: the store_bw-throttled read happens
                # inside, so a concurrent load waits at most one tensor
                with eng._store_lock:
                    if (fp in eng.persistent_store
                            and fp not in eng.host_store):
                        tb = _time.perf_counter() if tracer.enabled else 0.0
                        arr = eng.host_store.fetch(fp)
                        job.promoted.append((fp, arr.nbytes))
                        job.tensors_promoted += 1
                        job.bytes_promoted += arr.nbytes
                        # cumulative counter advances per TENSOR (the worker
                        # is its only writer): a close() mid-job cannot lose
                        # the partial read's bytes
                        self.bytes_promoted += arr.nbytes
                        self.promote_log.append((job.model_id, fp))
                        if tracer.enabled:
                            # worker-thread emit: the tracer's lock makes
                            # this safe against a concurrent load's spans
                            tracer.emit("prefetch.promote", tb,
                                        _time.perf_counter(),
                                        track=getattr(eng, "_track",
                                                      "prefetch"),
                                        cat="prefetch",
                                        args={"model": job.model_id})
            except WorkerDeath:
                # kills THIS worker: the job fails over (finally fires its
                # event so joiners go inline) and the supervisor restarts
                job.failed = True
                job.cancelled = True
                raise
            except Exception as e:
                # a failed promotion must not kill the worker: un-promoted
                # tensors are still store-resolvable, the joining load reads
                # them inline, and later hints keep working.  Typed + counted
                # + logged — never silently swallowed.
                self.errors += 1
                if fault_stats is not None:
                    fault_stats.prefetch_errors += 1
                log.warning("prefetch promotion of %s/%s failed (%s: %s) — "
                            "job degrades to inline", job.model_id, fp,
                            type(e).__name__, e)
                job.failed = True
                job.cancelled = True  # skip the job's remaining tensors
            finally:
                # the event MUST fire even when a promotion raises (a
                # joining load would otherwise hang forever)
                with self._cv:
                    if job.cancelled or job.exhausted():
                        self._retire(job)
                        self._finish(job)



class SharedKVSlab:
    """One paged K/V buffer per KV geometry, shared by every resident
    instance.  A physical page is keyed by the *pool offset* ElasticKV
    assigned to the block, so concurrently-decoding models' sequences
    interleave pages without coordination — the Unified Memory Pool already
    guarantees the offsets are disjoint."""

    def __init__(self, k_pages: torch.Tensor, v_pages: torch.Tensor):
        self.k_pages = k_pages  # (L, P, T, K, hd)
        self.v_pages = v_pages
        self.page_map: dict[int, int] = {}  # pool offset -> page index
        self.free_pages: list[int] = []
        self._next_fresh = 0

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]

    def live_pages(self) -> int:
        return len(self.page_map)

    def page_of(self, offset: int) -> int:
        idx = self.page_map.get(offset)
        if idx is None:
            if self.free_pages:
                idx = self.free_pages.pop()
            else:
                if self._next_fresh >= self.num_pages:
                    # sharing must not shrink capacity below what separate
                    # per-instance slabs provided: grow the backing buffers
                    self.grow(max(1, self.num_pages * 2))
                idx = self._next_fresh
                self._next_fresh += 1
            self.page_map[offset] = idx
        return idx

    def release(self, offsets):
        """Instance finished: its pages return to the slab free list."""
        for off in offsets:
            idx = self.page_map.pop(off, None)
            if idx is not None:
                self.free_pages.append(idx)

    def grow(self, num_pages: int):
        """Reallocate with more pages (existing pages keep their indices);
        holders must re-read `k_pages` / `v_pages`."""
        if num_pages <= self.num_pages:
            return
        L, _, T, K, hd = self.k_pages.shape
        pad = num_pages - self.num_pages
        zeros = self.k_pages.new_zeros((L, pad, T, K, hd))
        self.k_pages = torch.cat([self.k_pages, zeros], dim=1)
        self.v_pages = torch.cat([self.v_pages, zeros], dim=1)


class Engine:
    """One worker's inference engine over a Unified Memory Pool."""

    def __init__(self, capacity_bytes: int, *, costs: Optional[PhaseCosts] = None,
                 block_tokens: int = 16, chunk_bytes: int = 16 << 20,
                 transfer_depth: int = 2,
                 host_cache_bytes: Optional[int] = None,
                 store_bw: Optional[float] = None,
                 host_keep_alive_s: Optional[float] = None,
                 engine_id: str = "engine0",
                 faults: Optional[FaultInjector] = None,
                 transfer_timeout_s: Optional[float] = None,
                 tracer=None, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported engine device {self.device}")
        self.engine_id = engine_id
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._track = f"eng:{engine_id}"
        self.store = ReuseStore(capacity_bytes, costs or PhaseCosts(paper_l40()))
        self.block_tokens = block_tokens
        self.models: dict[str, RegisteredModel] = {}
        self.faults = faults
        if faults is not None and self.tracer.enabled:
            self.faults.observer = (
                lambda point, idx, key, mode: self.tracer.record_fault(
                    point, args={"idx": idx, "key": key, "mode": mode,
                                 "engine": engine_id}))
        self.fault_stats = FaultStats()
        self.crashes = 0  # Engine.crash() invocations (fleet chaos events)
        if transfer_timeout_s is None and faults is not None:
            transfer_timeout_s = 30.0
        self.transfer_timeout_s = transfer_timeout_s
        self.join_timeout_s: Optional[float] = 30.0
        # three-tier model store (DESIGN.md §11); host buffers are pinned
        # when the device is CUDA so chunk copies run asynchronously
        self.persistent_store = PersistentStore(store_bw=store_bw,
                                                faults=faults)
        self.host_store = HostTensorStore(host_cache_bytes,
                                          spill=self.persistent_store,
                                          keep_alive_s=host_keep_alive_s,
                                          pin_memory=self.device.type == "cuda")
        self._host_pins: set[str] = set()  # model_ids holding host-tier pins
        self._store_lock = threading.RLock()
        self.prefetcher = Prefetcher(self)
        self._xfer = ChunkedTransfer(device=self.device, chunk_bytes=chunk_bytes,
                                     depth=transfer_depth,
                                     timeout_s=self.transfer_timeout_s,
                                     faults=faults,
                                     fault_stats=self.fault_stats,
                                     tracer=self.tracer, track=self._track)
        self._tensors: dict[str, torch.Tensor] = {}  # fingerprint -> live buffer
        self._params_cache: dict[str, Any] = {}  # model_id -> assembled tree
        self._slabs: dict[tuple, SharedKVSlab] = {}  # KV geometry -> slab
        self._fused: dict[tuple, tuple] = {}  # group -> cached fused state
        self._instances_of: dict[str, int] = {}  # model_id -> live instances
        self._live_instances: dict[str, list["Instance"]] = {}
        self.last_load: Optional[DataLoadStats] = None

    # ------------------------------------------------------------- registry
    def register_model(self, spec: ModelSpec | str, cfg: ModelConfig,
                       init_fn: Optional[Callable[[], Any]] = None):
        """Register a model under an explicit identity `spec` (DESIGN.md
        §17).  Records come from the model's meta-tensor parameter tree, so
        no weights are materialized here; CONTENT fingerprints therefore
        fall back to identity at registration, as in the reference.  The
        default `init_fn` draws the port's own weights into host memory
        (the host tier) from a crc32-seeded generator.  A bare string means identity policy."""
        spec = spec if isinstance(spec, ModelSpec) else ModelSpec(str(spec))
        model = build_model(cfg)
        if init_fn is None:
            # stable digest, NOT hash(): PYTHONHASHSEED randomizes str hashes
            seed = zlib.crc32(spec.model_id.encode()) & 0xFFFF
            init_fn = lambda: model.init(torch.Generator().manual_seed(seed),
                                         device="cpu")
        tree = model.param_specs()
        records = tensor_records(spec, tree)
        self.store.register_model(spec)
        self.models[spec.model_id] = RegisteredModel(
            spec.model_id, cfg, records, init_fn, tree_structure(tree), spec=spec)

    def register(self, model_id: str, cfg: ModelConfig,
                 init_fn: Optional[Callable[[], Any]] = None):
        """Identity-policy shim for the pre-§17 call shape."""
        self.register_model(ModelSpec(model_id), cfg, init_fn)

    def records_of(self, model_id: str) -> list[TensorRecord]:
        return self.models[model_id].records

    # ------------------------------------------------------------------ load
    def load(self, model_id: str, *, now: float = 0.0,
             overlap_s: float = 0.0) -> LoadReport:
        """Tensor-granular three-way load over the tiered model store.

        Every record resolves through exactly one path (DESIGN.md §11):
          * device-pool hit — the device tensor is already resident, no bytes
            move at all;
          * host hit — the fast path: stream the host buffer through
            the chunked h2d pipeline;
          * store promote-then-transfer — the tensor was LRU-spilled to the
            persistent tier: promote it back into the host cache (paying
            the store_bw-limited read), then h2d.
        `init_fn` still runs at most once per model EVER — a spilled tensor
        is resolvable, so materialization only covers never-seen leaves.
        The model's records are refcount-pinned in the host store for as
        long as it stays active, so LRU eviction can never race the
        in-flight `ChunkedTransfer` (or a co-loading model's spills).
        A pending `prefetch` hint is JOINED (DESIGN.md §12): the load waits
        for the in-flight promotion instead of re-reading the store, so the
        tensors it covered resolve as host hits and only the un-hidden tail
        of the store read shows up in wall time.
        `overlap_s` is the modeled hideable window forwarded to the cost
        plane's `ReuseStore.load_model` (the `LoadableEngine` protocol
        shares one load signature across both planes); the data plane's own
        overlap is the real prefetch join above, so it is not re-applied
        here.
        """
        reg = self.models[model_id]
        report = self.store.load_model(model_id, reg.records, now=now,
                                       overlap_s=overlap_s)
        # free what the pool just evicted before the misses are allocated,
        # so the card holds no more than the pool
        self.sync_evictions(keep_active=True)
        stats = DataLoadStats()
        t0 = _time.perf_counter()
        job = self.prefetcher.take(model_id)
        if job is not None:
            # join the in-flight hint instead of re-reading the store: the
            # hint already pinned the model, so waiting BEFORE our own pin
            # is safe and we block only for the part of the read the
            # hint->load window did not hide (no lock contention with the
            # worker's throttled per-tensor reads).  The wait is BOUNDED: a
            # dead/failed/wedged job fails this load over to the inline path
            # (un-promoted tensors are still store-resolvable) instead of
            # wedging it (DESIGN.md §15).
            tw = _time.perf_counter()
            joined = job.done.wait(timeout=self.join_timeout_s)
            stats.prefetch_wait_seconds = _time.perf_counter() - tw
            if self.tracer.enabled:
                self.tracer.emit("prefetch.join", tw,
                                 tw + stats.prefetch_wait_seconds,
                                 track=self._track, cat="prefetch",
                                 args={"model": model_id})
            if not joined or job.failed:
                self.fault_stats.join_failovers += 1
                stats.prefetch_failover = True
                log.warning("load of %s: prefetch hint %s — inline fallback",
                            model_id,
                            "failed" if job.failed else "join timed out")
            with self._store_lock:
                # credit only promotions STILL host-resident: a stale job
                # (model released + re-spilled since it completed) must not
                # count bytes this load will re-read inline as bytes_store.
                # (Safe even for a failed job: partial promotions were made
                # under this same lock and DO serve this load as host hits.)
                live = [(fp, n) for fp, n in job.promoted
                        if fp in self.host_store]
            stats.tensors_prefetched = len(live)
            stats.bytes_prefetched = sum(n for _, n in live)
            self.prefetcher.joins += 1
        with self._store_lock:
            self.host_store.age()  # keep-alive churn lands before resolution
            was_pinned = model_id in self._host_pins
            self._pin_model(model_id)  # eviction must not race this load
        try:
            self._load_tensors(reg, stats)
        except Exception as e:
            # failed load must not leak pins forever: drop our own pin, and
            # a consumed hint's pin too (its job can no longer be cancelled).
            # Typed + counted + logged (DESIGN.md §15) — the unwind is a
            # visible fault, not a silent one.
            self.fault_stats.load_errors += 1
            log.warning("load of %s failed (%s: %s)", model_id,
                        type(e).__name__, e)
            if not was_pinned or (job is not None and job.owns_pin):
                self._unpin_model(model_id)
            raise
        stats.total_seconds = _time.perf_counter() - t0
        # the report's tier split must reflect what the data plane actually
        # did (the engine's ReuseStore models no host cache of its own):
        # store-promoted bytes re-price the modeled load time at store_bw;
        # materialized leaves count as host-side, like a checkpoint read
        # min-clamp: planes can briefly disagree when the store re-admits a
        # tensor whose device buffer never dropped (test-only eviction paths)
        report.bytes_from_store = min(stats.bytes_store,
                                      report.bytes_transferred)
        report.bytes_from_host = (report.bytes_transferred
                                  - report.bytes_from_store)
        report.load_seconds = self.store.costs.load_time_tiered(
            report.bytes_from_host, report.bytes_from_store)
        self.last_load = stats
        if self.tracer.enabled:
            # measured load wall vs the cost plane's tiered prediction —
            # the real-plane half of the span/cost cross-check (§18)
            self.tracer.emit("load", t0, t0 + stats.total_seconds,
                             track=self._track, cat="engine",
                             args={"model": model_id,
                                   "pred": report.load_seconds})
        return report

    def _load_tensors(self, reg: RegisteredModel, stats: DataLoadStats):
        # tensors whose device buffer is absent (store misses, plus any buffer
        # dropped by sync_evictions that the store re-admitted); deduped by
        # fingerprint — tied weights under a content policy move ONCE and
        # later occurrences resolve off the same buffer (counted as device
        # hits, matching the cost plane's hit-by-admission accounting)
        to_move = []
        moving: set[str] = set()
        for r in reg.records:
            if r.fingerprint in self._tensors or r.fingerprint in moving:
                stats.tensors_device_hit += 1
                stats.bytes_device_hit += r.nbytes
            else:
                moving.add(r.fingerprint)
                to_move.append(r)
        if to_move:
            with self._store_lock:
                host_hits = [r for r in to_move
                             if r.fingerprint in self.host_store]
                spilled = [r for r in to_move
                           if r.fingerprint not in self.host_store
                           and r.fingerprint in self.persistent_store]
            if len(host_hits) + len(spilled) < len(to_move):
                tm = _time.perf_counter()
                params = reg.init_fn()  # full materialization: once, ever
                with self._store_lock:
                    stats.leaves_materialized = self.host_store.put_tree(
                        reg.records, params)
                stats.init_seconds = _time.perf_counter() - tm
                del params
                if self.tracer.enabled:
                    self.tracer.emit("init", tm, tm + stats.init_seconds,
                                     track=self._track, cat="engine",
                                     args={"model": reg.model_id})
            stats.tensors_host_hit = len(host_hits)
            stats.bytes_host_hit = sum(r.nbytes for r in host_hits)
            if spilled:
                ts = _time.perf_counter()
                retries0 = self.host_store.read_retries
                quarantined: list[TensorRecord] = []
                promoted_bytes = 0
                for r in spilled:  # store_bw-limited promotion, pinned above
                    try:
                        with self._store_lock:
                            self.host_store.fetch(r.fingerprint)
                        promoted_bytes += r.nbytes
                    except StoreError as e:
                        # fetch already retried/backed-off and quarantined
                        # the blob (DESIGN.md §15) — collect for the init_fn
                        # fallback below instead of failing the load
                        log.warning("store promote of %s (%s) unrecoverable "
                                    "(%s: %s) — re-materializing",
                                    r.name, r.fingerprint,
                                    type(e).__name__, e)
                        quarantined.append(r)
                stats.store_retries = (self.host_store.read_retries
                                       - retries0)
                stats.store_seconds = _time.perf_counter() - ts
                if self.tracer.enabled:
                    self.tracer.emit("store.read", ts,
                                     ts + stats.store_seconds,
                                     track=self._track, cat="engine",
                                     args={"model": reg.model_id,
                                           "bytes": promoted_bytes,
                                           "retries": stats.store_retries})
                stats.tensors_store = len(spilled) - len(quarantined)
                stats.bytes_store = promoted_bytes
                if quarantined:
                    # quarantine-then-reinit fallback: the blobs are gone
                    # from every tier, so re-materialize — put_tree skips
                    # still-resolvable leaves, only the quarantined ones
                    # (and nothing else) are re-stored
                    stats.tensors_quarantined = len(quarantined)
                    tm = _time.perf_counter()
                    params = reg.init_fn()
                    with self._store_lock:
                        stats.leaves_materialized += self.host_store.put_tree(
                            reg.records, params)
                    stats.init_seconds += _time.perf_counter() - tm
                    del params
                    stats.tensors_reinit = len(quarantined)
                    self.fault_stats.tensors_reinit += len(quarantined)
                    if self.tracer.enabled:
                        self.tracer.emit("init", tm, _time.perf_counter(),
                                         track=self._track, cat="engine",
                                         args={"model": reg.model_id,
                                               "reinit": len(quarantined)})
            tt = _time.perf_counter()
            with self._store_lock:  # snapshot host buffers for the pipeline
                items = [(r.fingerprint, self.host_store.get(r.fingerprint))
                         for r in to_move]
            # bounded whole-transfer retry: chunk-level errors retry inside
            # ChunkedTransfer; a TransferTimeout (or exhausted chunk budget)
            # re-runs the pipeline once before the load truly fails
            h2d_snapshot = (stats.tensors_h2d, stats.bytes_h2d,
                            stats.chunks_h2d)
            try:
                moved = self._xfer.transfer(items, stats)
            except TransferError as e:
                log.warning("chunked transfer failed (%s: %s) — retrying "
                            "once", type(e).__name__, e)
                (stats.tensors_h2d, stats.bytes_h2d,
                 stats.chunks_h2d) = h2d_snapshot  # don't double-count
                moved = self._xfer.transfer(items, stats)
            stats.transfer_seconds = _time.perf_counter() - tt
            if self.tracer.enabled:
                self.tracer.emit("h2d", tt, tt + stats.transfer_seconds,
                                 track=self._track, cat="engine",
                                 args={"model": reg.model_id,
                                       "bytes": stats.bytes_h2d,
                                       "chunks": stats.chunks_h2d})
            self._tensors.update(moved)
        if to_move or reg.model_id not in self._params_cache:
            # assemble the param tree from resident buffers (no copies) —
            # measured as the Profile phase of the TTFT split
            tp = _time.perf_counter()
            self._params_cache[reg.model_id] = tree_unflatten(
                reg.treedef, [self._tensors[r.fingerprint] for r in reg.records])
            stats.profile_seconds = _time.perf_counter() - tp
            if self.tracer.enabled:
                self.tracer.emit("profile", tp, tp + stats.profile_seconds,
                                 track=self._track, cat="engine",
                                 args={"model": reg.model_id})

    # -------------------------------------------------------------- prefetch
    # -------------------------------------------------------------- prefetch
    def prefetch(self, model_id: str, *, now: float = 0.0) -> PrefetchJob:
        """Affinity hint (DESIGN.md §12): the scheduler placed a request for
        `model_id` here — start promoting its store-resident tensors into
        the host tier NOW, so the store_bw read overlaps queueing/init/h2d
        instead of extending the coming `Engine.load` (which joins the job).
        `now` is the caller's trace-clock stamp — accepted for protocol
        parity with the modeled fleet engine; the data plane's promotion
        runs on the wall clock, so it is not consulted here.

        The model's records are refcount-pinned immediately (host-resident
        bytes survive cap pressure and keep-alive aging until the load
        lands); the pin is released by the usual `release`/last
        `finish_instance`, or by `cancel_prefetch` for an abandoned hint.
        """
        reg = self.models[model_id]
        with self._store_lock:
            self.host_store.age()  # expired entries are exactly what we fetch
            owns_pin = model_id not in self._host_pins
            self._pin_model(model_id)
            spilled: list[str] = []
            deadlines: list[float] = []
            prefix = 0.0  # h2d bytes the load moves before this tensor
            for r in reg.records:
                if r.fingerprint in self._tensors:
                    continue  # device hit: the load never touches this tensor
                if (r.fingerprint not in self.host_store
                        and r.fingerprint in self.persistent_store):
                    # deadline = bytes the chunked pipeline streams ahead of
                    # this tensor: the worker promotes smaller-prefix tensors
                    # first, fleet-wide (bytes-until-deadline priority)
                    spilled.append(r.fingerprint)
                    deadlines.append(prefix)
                prefix += r.nbytes
        return self.prefetcher.submit(model_id, spilled, owns_pin,
                                      deadlines=deadlines)

    def close(self):
        """Release the engine's background resources (the prefetch worker).
        Idempotent; an engine that issued hints holds a daemon thread that
        references it, so long-lived processes churning engines should
        close them."""
        self.prefetcher.close()

    # ----------------------------------------------------------- chaos plane
    def crash(self):
        """Simulated engine/process crash (DESIGN.md §15): volatile state is
        LOST — device pool, host tier, live buffers, param caches, KV slabs,
        pins — while the persistent store (the durable tier) survives.  The
        engine rejoins with cold tiers at the CURRENT host-capacity budget;
        host-only tensors that never spilled become unresolvable and
        re-materialize via `init_fn` on the next load.  The host tier's
        fault counters are folded into `fault_stats` first so the chaos
        ledger survives the object swap.

        On the card the state swap must free the memory: the prefetch worker
        is joined and the copy stream drained first (no chunk is in flight),
        and every live instance drops its slab, tables and lengths, so no
        reference outlives the crash even where a caller still holds the
        instance."""
        self.crashes += 1
        if self.tracer.enabled:
            self.tracer.record_fault("engine.crash",
                                     args={"engine": self.engine_id})
        self.fault_stats.store_retries += self.host_store.read_retries
        self.fault_stats.store_quarantines += self.host_store.quarantines
        # in-flight hints own host-tier pins that nothing releases once their
        # prefetcher dies: drop and count them
        with self._store_lock:
            orphaned = [mid for mid, job in self.prefetcher._jobs.items()
                        if job.owns_pin and mid in self._host_pins
                        and mid not in self.store.active_models]
            for mid in orphaned:
                self._unpin_model(mid)
            self.fault_stats.prefetch_pins_dropped += len(orphaned)
        self.prefetcher.close()
        self._xfer.drain()
        for insts in self._live_instances.values():
            for inst in insts:
                inst._drop_device_state()
        self.store = ReuseStore(self.store.pool.capacity, self.store.costs)
        self.host_store = HostTensorStore(
            self.host_store.capacity_bytes, spill=self.persistent_store,
            keep_alive_s=self.host_store.keep_alive_s,
            pin_memory=self.host_store.pin_memory)
        self._host_pins = set()
        self._tensors = {}
        self._params_cache = {}
        self._slabs = {}
        self._fused = {}
        self._instances_of = {}
        self._live_instances = {}
        self.last_load = None
        self.prefetcher = Prefetcher(self)
        log.warning("engine %s crashed: tiers cold, persistent store intact",
                    self.engine_id)

    def fault_summary(self) -> dict[str, Any]:
        """The engine's chaos ledger: injected faults (per point) plus every
        handled/quarantined/failed-over outcome (the reference's schema)."""
        fs, ps, hs = (self.fault_stats, self.persistent_store,
                      self.host_store)
        return EngineFaultStats(
            injected=(self.faults.ledger() if self.faults is not None
                      else {}),
            store_read_errors=ps.read_errors,
            store_checksum_failures=ps.checksum_failures,
            store_quarantined=ps.quarantined,
            store_retries=fs.store_retries + hs.read_retries,
            store_quarantines=fs.store_quarantines + hs.quarantines,
            h2d_retries=fs.h2d_retries,
            h2d_stalls=fs.h2d_stalls,
            transfer_timeouts=fs.transfer_timeouts,
            prefetch_errors=fs.prefetch_errors,
            worker_restarts=fs.worker_restarts,
            join_failovers=fs.join_failovers,
            load_errors=fs.load_errors,
            shutdown_join_timeouts=fs.shutdown_join_timeouts,
            prefetch_pins_dropped=fs.prefetch_pins_dropped,
            tensors_reinit=fs.tensors_reinit,
            crashes=self.crashes,
        ).as_dict()

    def cancel_prefetch(self, model_id: str):
        """Withdraw an abandoned hint: stop the in-flight promotion and drop
        the hint's pin (no-op after a load already joined the job).  If a
        load raced us to the model in the meantime (it is active in the
        store), the pin now belongs to that load's lifecycle — keep it."""
        job = self.prefetcher.take(model_id)
        if job is None:
            return
        job.cancelled = True
        job.done.wait()  # the worker may be mid-tensor: let it finish cleanly
        with self._store_lock:
            if job.owns_pin and model_id not in self.store.active_models:
                self._unpin_model(model_id)

    def _pin_model(self, model_id: str):
        with self._store_lock:
            if model_id in self._host_pins:
                return
            self._host_pins.add(model_id)
            for r in self.models[model_id].records:
                self.host_store.pin(r.fingerprint)

    def _unpin_model(self, model_id: str):
        with self._store_lock:
            if model_id not in self._host_pins:
                return
            self._host_pins.discard(model_id)
            for r in self.models[model_id].records:
                self.host_store.unpin(r.fingerprint)

    def release(self, model_id: str):
        self.store.release(model_id)
        self._unpin_model(model_id)  # host copies become LRU-evictable
        self.sync_evictions(keep_active=True)

    def retain(self, model_id: str):
        """Keep-alive retain (serverless control plane): the lifecycle
        manager decided this model stays WARM after its last instance
        finished — re-activate it in the store (never an eviction victim)
        and re-pin its host copies (exempt from cap pressure and aging)
        until `release` scales it to zero."""
        self.store.activate(model_id)
        self._pin_model(model_id)

    def prewarm(self, model_id: str, *, now: float = 0.0) -> LoadReport:
        """Predictive pre-warm (DESIGN.md §14): load the model AHEAD of its
        predicted arrival and retain it, so the re-arrival finds a warm
        instance."""
        rep = self.load(model_id, now=now)
        self.retain(model_id)
        return rep

    def host_resident_bytes(self, records: Sequence[TensorRecord]) -> int:
        """Tier-aware affinity scoring feed (DeviceView protocol): bytes of
        `records` the DEVICE pool misses that the host Model Store holds."""
        with self._store_lock:
            return sum(r.nbytes for r in records
                       if r.fingerprint not in self._tensors
                       and r.fingerprint in self.host_store)

    def host_free_bytes(self) -> Optional[int]:
        """Free bytes in the host Model Store budget (None = unbounded)."""
        with self._store_lock:
            if self.host_store.capacity_bytes is None:
                return None
            return max(0, self.host_store.capacity_bytes
                       - self.host_store.nbytes())

    def set_host_capacity(self, capacity_bytes: Optional[int]) -> int:
        """Tenant-pressure feed: resize the host Model Store budget under
        the store lock.  Pinned models are exempt.  Returns bytes spilled."""
        with self._store_lock:
            return self.host_store.set_capacity_bytes(capacity_bytes)

    def finish_instance(self, model_id: str):
        """Instance-path release, refcounted: the model stays ACTIVE in the
        store (never evictable) until its LAST live instance finishes —
        several same-model instances are a first-class pattern
        (`decode_many` fuses them)."""
        n = self._instances_of.get(model_id, 0) - 1
        if n > 0:
            self._instances_of[model_id] = n
            return
        self._instances_of.pop(model_id, None)
        self.store.release(model_id)
        self._unpin_model(model_id)
        self.sync_evictions(keep_active=True)

    def drop_device_copies(self, model_id: str):
        """Release the model and evict its device buffers, so the next load
        must resolve through the host/store tiers.  Benchmark and test hook
        (fig15's pressure sweep, the load-tier matrix) — the serving path
        never force-evicts; it lets MCE pick victims.  Owner-scoped via
        `drop_model`: a content-fingerprint tensor shared with (and owned
        by) another resident model stays."""
        self.release(model_id)
        self.store.drop_model(model_id)
        self.sync_evictions()

    def sync_evictions(self, *, keep_active: bool = False):
        """Drop data-plane buffers for tensors the store has evicted.

        With `keep_active` a model in use keeps all of its buffers:
        `ReuseStore.load_model` activates the model only after allocating its
        misses, so the allocation may evict the model's own resident hits,
        which its instances still read (they go once the model is
        released)."""
        live = set(self.store.tensor_map)
        active = self.store.active_models if keep_active else set()
        keep = live | {r.fingerprint for m in active for r in self.models[m].records}
        for fp in [fp for fp in self._tensors if fp not in keep]:
            del self._tensors[fp]
        for mid in list(self._params_cache):
            if mid not in active and any(r.fingerprint not in live
                                         for r in self.models[mid].records):
                del self._params_cache[mid]

    def params_of(self, model_id: str):
        return self._params_cache[model_id]

    # ------------------------------------------------------------ h2d helper
    def h2d(self, arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """Upload a host array.  On CUDA it goes through a fresh pinned
        staging buffer and an asynchronous copy: no host sync, and the caller
        may mutate `arr` right away (host mirrors are updated in place)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cpu":
            return src.to(dtype=dtype, copy=True)
        staging = torch.empty(src.shape, dtype=dtype, pin_memory=True)
        staging.copy_(src)
        return staging.to(self.device, non_blocking=True)

    # -------------------------------------------------------------- instance
    def kv_slab(self, cfg: ModelConfig, num_pages: int) -> SharedKVSlab:
        """The shared slab for this model's KV geometry (created or grown on
        demand).  Instances of different models with equal geometry share."""
        L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
        T = self.block_tokens
        key = (L, T, K, hd, cfg.dtype)
        slab = self._slabs.get(key)
        if slab is None:
            shape = (L, num_pages, T, K, hd)
            slab = SharedKVSlab(
                torch.zeros(shape, dtype=cfg.torch_dtype, device=self.device),
                torch.zeros(shape, dtype=cfg.torch_dtype, device=self.device))
            self._slabs[key] = slab
        else:
            slab.grow(num_pages)
        return slab

    def start_instance(self, model_id: str, *, max_blocks_per_seq: int = 64,
                       num_pages: int = 128,
                       attn_mode: str = "kernel") -> "Instance":
        """attn_mode: "kernel" decodes through the E-Attention paged kernel
        (its plain version for CPU tensors); "ref" is the caller's explicit
        choice of the plain PyTorch version on any device."""
        if attn_mode not in ("kernel", "ref"):
            raise ValueError(f"attn_mode {attn_mode!r}")
        reg = self.models[model_id]
        kv = ElasticKV(self.store, model_id, block_tokens=self.block_tokens,
                       kv_bytes_per_token=max(reg.cfg.kv_bytes_per_token(), 1),
                       blocks_per_region=16)
        self._instances_of[model_id] = self._instances_of.get(model_id, 0) + 1
        inst = Instance(self, reg, kv, num_pages=num_pages,
                        max_blocks_per_seq=max_blocks_per_seq,
                        attn_mode=attn_mode)
        self._live_instances.setdefault(model_id, []).append(inst)
        return inst

    def decode_many(self, steps: Sequence[tuple["Instance", torch.Tensor]]
                    ) -> list[torch.Tensor]:
        """One interleaved engine step: advance each running instance by one
        decode step over the shared KV slab(s).  Same-model instances on one
        slab are FUSED into a single dispatch (their batches concatenate
        along B; per-row numerics are unchanged).  Returns per-instance
        logits."""
        tb = _time.perf_counter() if self.tracer.enabled else 0.0
        out: list[Optional[torch.Tensor]] = [None] * len(steps)
        groups: dict[tuple, list[int]] = {}
        for i, (inst, _tok) in enumerate(steps):
            assert inst.engine is self, "instance belongs to another engine"
            if inst.paged:
                groups.setdefault((inst.reg.model_id, id(inst.slab),
                                   inst.attn_mode), []).append(i)
            else:
                groups.setdefault(("__solo__", i), []).append(i)
        for key, idxs in groups.items():
            if len(idxs) == 1:
                i = idxs[0]
                out[i] = steps[i][0].decode(steps[i][1])
                continue
            out_slices = self._decode_fused([steps[i] for i in idxs])
            for i, logits in zip(idxs, out_slices):
                out[i] = logits
        if self.tracer.enabled:
            self.tracer.emit("decode.step", tb, _time.perf_counter(),
                             track=self._track, cat="decode",
                             args={"instances": len(steps)})
        return out  # type: ignore[return-value]

    def _decode_fused(self, group: list[tuple["Instance", torch.Tensor]]
                      ) -> list[torch.Tensor]:
        """One dispatch for several same-model instances over one slab.

        The fused block tables and lengths live on device across steps: they
        are rebuilt (one h2d each) only when a member instance mapped a new
        KV block or stepped outside the fusion group.
        """
        insts = [inst for inst, _ in group]
        slab = insts[0].slab
        params = self.params_of(insts[0].reg.model_id)
        cfg = insts[0].reg.cfg
        for inst in insts:
            inst._advance_tables()  # host-side bookkeeping; h2d only
        key = tuple(inst._uid for inst in insts)
        versions = tuple((inst.table_uploads, inst._step) for inst in insts)
        cached = self._fused.get(key)
        if cached is not None and cached[0] == versions:
            tables, lengths = cached[1], cached[2]
        else:
            width = max(inst._tables_np.shape[1] for inst in insts)
            tables = self.h2d(np.concatenate(
                [np.pad(inst._tables_np,
                        ((0, 0), (0, width - inst._tables_np.shape[1])))
                 for inst in insts]), torch.int32)
            # the host mirrors are authoritative: one h2d upload
            lengths = self.h2d(
                np.concatenate([inst._host_lens for inst in insts]), torch.int32)
        tokens = torch.cat([tok for _, tok in group])
        logits, new_lens = _paged_decode_step(
            params, cfg, tokens, tables, lengths,
            slab.k_pages, slab.v_pages, attn=insts[0].attn_mode)
        outs = []
        o = 0
        for inst, tok in group:
            B = tok.shape[0]
            inst._host_lens += 1
            inst._step += 1
            inst._lengths_stale = True  # refreshed from the mirror on demand
            outs.append(logits[o : o + B])
            o += B
        while len(self._fused) >= 64:  # bound churned group compositions
            self._fused.pop(next(iter(self._fused)))
        self._fused[key] = (
            tuple((inst.table_uploads, inst._step) for inst in insts),
            tables, new_lens)
        return outs


def _is_paged_family(cfg: ModelConfig) -> bool:
    # full-attention homogeneous stacks decode through the paged kernel;
    # SWA models use the ring cache (window masking), state models their state
    return (cfg.family in ("dense", "moe", "vlm")
            and all(k == "attn" for k in cfg.pattern)
            and len(cfg.segments) == 1)


class Instance:
    """A running model instance: prefill once, decode with paged KV.

    Lengths are tracked twice, deliberately: `_host_lens` (numpy) is the
    authoritative host-side copy driving ElasticKV bookkeeping, `_lengths`
    (device) feeds the kernels and is advanced on device by each step — so
    the decode loop never reads anything back from the device.
    """

    _uids = itertools.count()  # stable ids for the fused cache

    def __init__(self, engine: Engine, reg: RegisteredModel, kv: ElasticKV, *,
                 num_pages: int, max_blocks_per_seq: int,
                 attn_mode: str = "kernel"):
        self.engine = engine
        self.reg = reg
        self.kv = kv
        self.model = build_model(reg.cfg)
        self.attn_mode = attn_mode
        self.paged = _is_paged_family(reg.cfg)
        self.max_blocks = max_blocks_per_seq
        self.slab: Optional[SharedKVSlab] = None
        if self.paged:
            self.slab = engine.kv_slab(reg.cfg, num_pages)
        self._cache = None  # state-family fallback cache
        self._tables: Optional[torch.Tensor] = None  # device block tables
        self._tables_np: Optional[np.ndarray] = None  # host mirror
        self._nblk: Optional[np.ndarray] = None  # mapped blocks per sequence
        self._lengths: Optional[torch.Tensor] = None  # device per-seq lengths
        self._host_lens: Optional[np.ndarray] = None  # authoritative host copy
        self.table_uploads = 0  # h2d table refreshes (block-mapping steps)
        self._step = 0  # advances on every prefill/decode (fused-cache key)
        self._lengths_stale = False  # device lengths behind the host mirror
        self._tables_stale = False  # device tables behind the host mirror
        self._uid = next(Instance._uids)  # id()-reuse-proof fused-cache key

    def _pages(self, pbns) -> list[int]:
        """Map this instance's ElasticKV PBNs to shared-slab page indices via
        their pool offsets (disjoint across co-resident instances)."""
        return [self.slab.page_of(self.kv.addr[p]) for p in pbns]

    # ---------------------------------------------------------------- prefill
    def prefill(self, batch: dict, *, lengths: Optional[Sequence[int]] = None
                ) -> torch.Tensor:
        """Traced entry point — see `_prefill_impl` for the semantics."""
        eng = self.engine
        if eng.tracer.enabled:
            with eng.tracer.span("prefill", track=eng._track, cat="engine",
                                 args={"model": self.reg.model_id}):
                return self._prefill_impl(batch, lengths=lengths)
        return self._prefill_impl(batch, lengths=lengths)

    def _prefill_impl(self, batch: dict, *,
                      lengths: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Run the prompt; populate paged KV (or state cache).

        `lengths`: optional per-sequence prompt lengths (<= padded S) for
        mixed-length batches; positions past a sequence's length hold padding
        whose K/V the paged kernel masks out.  Returns logits at each
        sequence's LAST REAL position, (B, V).
        """
        eng = self.engine
        params = eng.params_of(self.reg.model_id)
        tokens = batch["tokens"]
        B, S = tokens.shape
        lens = (np.full((B,), S, np.int64) if lengths is None
                else np.asarray(lengths, np.int64))
        assert lens.shape == (B,) and lens.min() >= 1 and lens.max() <= S
        cap = -(-S // self.kv.block_tokens) * self.kv.block_tokens
        logits, cache = self.model.prefill(params, batch, cache_cap=max(cap, S))
        last = logits[torch.arange(B, device=logits.device),
                      eng.h2d(lens - 1, torch.int64)]
        self._host_lens = lens.copy()
        self._lengths = eng.h2d(lens, torch.int32)
        self._step += 1
        if not self.paged:
            self._cache = cache
            return last

        # allocate block tables for the prompt, then scatter dense KV -> pages
        self.kv.ensure({f"seq{b}": int(lens[b]) for b in range(B)})
        T = self.kv.block_tokens
        nblk = -(-S // T)
        self._tables_np = np.zeros((B, self.max_blocks), np.int32)
        self._nblk = np.zeros((B,), np.int64)
        per_seq = [self._pages(self.kv.block_tables[f"seq{b}"])
                   for b in range(B)]  # may grow the slab: map pages FIRST
        # page id P (out of range) marks padding entries: the scatter drops
        # them.  num_pages must be read AFTER the mapping above.
        page_ids = np.full((B, nblk), self.slab.num_pages, np.int32)
        for b, pages in enumerate(per_seq):
            self._tables_np[b, : len(pages)] = pages
            self._nblk[b] = len(pages)
            page_ids[b, : len(pages)] = pages
        self._tables = eng.h2d(self._tables_np, torch.int32)
        self._tables_stale = False

        # cache is [segment0][unit0] = {"k": (L, B, cap, K, hd), ...}
        k_all = cache[0][0]["k"]
        v_all = cache[0][0]["v"]
        L = k_all.shape[0]
        kc = k_all[:, :, : nblk * T].reshape(L, B, nblk, T, *k_all.shape[3:])
        vc = v_all[:, :, : nblk * T].reshape(L, B, nblk, T, *v_all.shape[3:])
        _scatter_prefill_kv(self.slab, kc, vc, page_ids, eng.h2d)
        return last

    # -------------------------------------------------------- table plumbing
    def _advance_tables(self):
        """Host-side per-step bookkeeping BEFORE the decode step.

        Grows ElasticKV tables for sequences whose next token starts a new
        block, and marks the device block tables for re-upload only on those
        steps.  Never reads from the device.
        """
        T = self.kv.block_tokens
        if not (self._host_lens % T == 0).any():
            return  # no sequence crosses a block boundary this step
        self.kv.ensure({f"seq{b}": int(self._host_lens[b]) + 1
                        for b in range(len(self._host_lens))})
        for b in np.nonzero(self._host_lens % T == 0)[0]:
            pbns = self.kv.block_tables[f"seq{b}"]
            for i in range(int(self._nblk[b]), len(pbns)):
                self._tables_np[b, i] = self.slab.page_of(self.kv.addr[pbns[i]])
            self._nblk[b] = len(pbns)
        # upload lazily: fused steps rebuild their own table from the host
        # mirrors and never read the per-instance device copy
        self._tables_stale = True
        self.table_uploads += 1

    # ----------------------------------------------------------------- decode
    def decode(self, token: torch.Tensor) -> torch.Tensor:
        """One decode step for every sequence. token: (B,) -> logits (B, V).

        Reads nothing back from the device: lengths advance on device, host
        bookkeeping runs off the numpy mirrors, and uploads go through pinned
        staging buffers (`chip_smoke.py` runs this under
        ``torch.cuda.set_sync_debug_mode("error")``).
        """
        eng = self.engine
        params = eng.params_of(self.reg.model_id)
        self._step += 1
        if self._lengths_stale:  # fused steps advance only the host mirror
            self._lengths = eng.h2d(self._host_lens, torch.int32)
            self._lengths_stale = False
        if not self.paged:
            logits, self._cache = self.model.decode(params, token,
                                                    self._lengths, self._cache)
            self._lengths = self._lengths + 1
            self._host_lens += 1
            return logits

        self._advance_tables()
        if self._tables_stale:
            self._tables = eng.h2d(self._tables_np, torch.int32)
            self._tables_stale = False
        logits, self._lengths = _paged_decode_step(
            params, self.reg.cfg, token, self._tables, self._lengths,
            self.slab.k_pages, self.slab.v_pages, attn=self.attn_mode)
        self._host_lens += 1
        return logits

    def decode_legacy(self, token: torch.Tensor) -> torch.Tensor:
        """Pre-fast-path decode step: one host sync (`int(lengths[0])`) plus a
        full device→host block-table round trip and Python rebuild per step,
        assuming all-equal sequence lengths.  Kept ONLY as the measured
        baseline and for bit-for-bit equivalence tests — do not call from
        serving paths.
        """
        eng = self.engine
        params = eng.params_of(self.reg.model_id)
        if not self.paged:
            return self.decode(token)
        self._step += 1
        if self._lengths_stale:
            self._lengths = eng.h2d(self._host_lens, torch.int32)
            self._lengths_stale = False
        if self._tables_stale:
            self._tables = eng.h2d(self._tables_np, torch.int32)
            self._tables_stale = False
        B = token.shape[0]
        new_len = int(self._lengths[0]) + 1  # device->host sync per step
        self.kv.ensure({f"seq{b}": new_len for b in range(B)})
        tables_np = self._tables.cpu().numpy().copy()  # device->host round trip
        for b in range(B):
            pages = self._pages(self.kv.block_tables[f"seq{b}"])
            tables_np[b, : len(pages)] = pages
            self._nblk[b] = len(pages)
        self._tables_np = tables_np
        self._tables = eng.h2d(tables_np, torch.int32)
        logits, self._lengths = _paged_decode_step(
            params, self.reg.cfg, token, self._tables, self._lengths,
            self.slab.k_pages, self.slab.v_pages, attn=self.attn_mode)
        self._host_lens += 1
        return logits

    def _drop_device_state(self):
        """Engine crash: forget every device tensor this instance holds (the
        instance is dead; the engine's state is being swapped out)."""
        self.slab = None
        self._cache = None
        self._tables = self._lengths = None

    def finish(self):
        if self.slab is not None:
            # pages go back to the shared slab BEFORE the pool offsets are
            # released (another instance may claim them immediately after)
            self.slab.release(list(self.kv.addr.values()))
        for b in list(self.kv.block_tables):
            self.kv.release(b)
        self.kv.finish_instance()
        for key in [k for k in self.engine._fused if self._uid in k]:
            del self.engine._fused[key]
        live = self.engine._live_instances.get(self.reg.model_id)
        if live is not None and self in live:
            live.remove(self)
            if not live:
                del self.engine._live_instances[self.reg.model_id]
        self.engine.finish_instance(self.reg.model_id)


# ------------------------------------------------------------ prefill scatter
def _scatter_prefill_kv(slab: SharedKVSlab, kc, vc, page_ids: np.ndarray, h2d):
    """Scatter a prefill's dense KV into slab pages in place, in one
    `index_copy_` per buffer.

    kc/vc: (L, B, nblk, T, K, hd); page_ids: (B, nblk) host array of
    physical pages, with out-of-range ids (== num_pages) marking padding
    entries of shorter sequences; they are dropped on the host, as the
    reference's scatter mode "drop" does.
    """
    L = kc.shape[0]
    flat = page_ids.reshape(-1)
    keep = np.nonzero(flat < slab.num_pages)[0]
    src = h2d(keep, torch.int64)
    dst = h2d(flat[keep], torch.int64)
    kc = kc.reshape(L, flat.shape[0], *kc.shape[3:])
    vc = vc.reshape(L, flat.shape[0], *vc.shape[3:])
    slab.k_pages.index_copy_(1, dst, kc.index_select(1, src))
    slab.v_pages.index_copy_(1, dst, vc.index_select(1, src))


# ---------------------------------------------------------------- paged decode
def _paged_decode_step(params, cfg: ModelConfig, token, tables, lengths,
                       k_pages, v_pages, *, attn: str = "kernel"):
    """One decode step over paged KV for homogeneous attention models.

    k/v_pages: (L, P, T, K, hd), updated in place: each sequence's new K/V
    goes to the page ElasticKV mapped for its position (= its current
    length), then attention runs through the E-Attention paged kernel per
    layer with `lengths + 1`.  Returns (logits, lengths + 1) — lengths
    advance on device so the caller never syncs.
    """
    if cfg.is_moe:
        raise NotImplementedError("MoE decode is not ported yet — see ROADMAP queue 1")
    B = token.shape[0]
    _, P, T, K, hd = k_pages.shape
    pos = lengths  # next position = current per-sequence length
    h = params["embed"][token][:, None, :]  # (B, 1, D)
    seg_params = params["segments"][0]
    positions = pos[:, None]
    mrope = pos[None, :, None].expand(3, B, 1) if cfg.mrope_sections else None
    rp = mrope if cfg.mrope_sections else positions

    b_idx = torch.arange(B, device=token.device)
    pbn = tables[b_idx, (pos // T).long()]  # (B,) physical page per sequence
    row = pbn.long() * T + (pos % T).long()  # row in a layer's (P*T, K, hd) view
    new_lens = lengths + 1
    attn_fn = kops.paged_attention if attn == "kernel" else kops.paged_attention_ref

    for l in range(k_pages.shape[0]):
        p = lm._index_tree(seg_params, l)[0]
        hn = rms_norm(h, p["ln1"], cfg.norm_eps)
        q, knew, vnew = Lmod._project_qkv(p["attn"], hn, cfg)
        q = cmod.apply_rope(q, rp, cfg.rope_theta, cfg.mrope_sections)
        knew = cmod.apply_rope(knew, rp, cfg.rope_theta, cfg.mrope_sections)
        kp_l, vp_l = k_pages[l], v_pages[l]
        kp_l.view(P * T, K, hd).index_copy_(0, row, knew[:, 0])
        vp_l.view(P * T, K, hd).index_copy_(0, row, vnew[:, 0])
        o = attn_fn(q[:, 0], kp_l, vp_l, tables, new_lens)
        h = h + Lmod._out_proj(o, p["attn"]["wo"])[:, None, :]
        hm = rms_norm(h, p["ln2"], cfg.norm_eps)
        h = h + Lmod.mlp_forward(p["mlp"], hm)
    logits = lm.unembed(params, cfg, h)[:, 0]
    return logits, new_lens
