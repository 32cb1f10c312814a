"""The compiled decode steps: CUDA graphs of the engine's two decode steps,
shared by every instance of a model on one engine (port-only).

- The paged step, `_paged_decode_step`; the reference's counterpart is
  ``jax.jit`` on `repro/serving/engine.py` `_paged_decode_step`, one
  compiled, buffer-donating program a step.
- The non-paged step of the state families (`Model.decode`: SWA rings,
  recurrence states, Whisper's decoder); the reference's counterpart is the
  ``jax.lax.scan`` over each segment's layers (`repro/models/lm.py`
  `decode_step`, `repro/models/encdec.py` `decode_step`), which runs as one
  compiled XLA program a segment even outside ``jit``.  The reference
  traces and compiles that scan again on every call (a fresh body closure
  each step); a graph here is captured once per key and replayed.

A step is a function of a flat list of input tensors returning a flat list
of output tensors.  A graph is keyed by what ``jax.jit`` specialises on
(the static arguments, and the shape and dtype of every input tensor and of
every tensor the step reads or writes in place) and by what a graph bakes
in and a jit does not: the params tree it read, by the engine's generation
number for that tree, and the storage of the tensors it reads in place (the
paged step's KV slab), which the key holds, so neither can alias a later
tree or slab.  Instances of one model read one tree (and one slab), so they
share a key.  The first call for a key runs eagerly and is the answer; the
second captures and replays; later calls replay.

A replay copies the caller's inputs into the graph's static input buffers
on the current stream (device to device: the step never reads the device
back), replays, adds the launches the capture's wrappers counted
(`ops.count_launches`), and returns clones of the static outputs: the next
replay of the key, which may be another instance's, overwrites them, as
the reference returns fresh arrays.  An output that is one of the step's
inputs, unchanged (Whisper's cross-attention caches), is handed back as the
caller's own tensor, found at capture by identity, never as the static
buffer.

A key lives as long as the params tree it read stays assembled, as the
reference's jit cache outlives the instances that filled it: a model's
next request over the same tree replays from its first step.  A graph
holds raw pointers, not tensors, so the engine drops a model's keys
wherever its params tree is re-assembled or deleted, where the slab grows,
and at close and crash (`StepGraphs.drop`).  What live keys hold (private
pools and static input buffers) is device memory outside the ReuseStore's
capacity, bounded by `GRAPH_LIMIT` keys and `GRAPH_BUDGET` bytes, the least
recently used key freed first.  A dropped graph's private pool goes back
to the caching allocator, whose next ``empty_cache`` returns it to the
card.  A capture or replay that fails raises: nothing falls back to the
eager step.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.kernels import ops as kops

GRAPH_LIMIT = 64  # live keys per engine, as the engine bounds its fused-state cache
# Device bytes the live keys of one engine may hold (`StepGraphs.held_bytes`).
# On an H100 at full width the largest key is mamba2-2.7b's (a 396 MB private
# pool plus its ~170 MB state cache as static inputs); the four state
# families' keys (mamba2, recurrentgemma-9b, whisper-tiny, mixtral-8x7b's
# ring) hold about 0.8 GB together; llama3.2-1b's paged key at B 4 holds
# 47 MB of pool.  1 GiB holds every key a serving mix of those models keeps
# at once, and beside 15-25 GB ReuseStore pools on an 80 GB card it leaves
# the pool's room untouched.  A key larger than the budget on its own still
# captures and replays; it is freed when the next key is captured.
GRAPH_BUDGET = 1 << 30


def shape_key(static: tuple, tensors: Sequence[torch.Tensor]) -> tuple:
    """What ``jax.jit`` specialises a step on: its static arguments and each
    array argument's shape and dtype (the params' shapes follow from the
    config among the static arguments)."""
    return tuple(static) + tuple((tuple(t.shape), t.dtype) for t in tensors)


class CudaGraphCapture:
    """Captures a step into a `torch.cuda.CUDAGraph` without a host sync.

    The capture runs on a side stream that waits on the current stream
    through an event, in ``thread_local`` mode, so the engine's prefetch
    thread and copy stream may allocate and copy meanwhile.  It avoids the
    `torch.cuda.graph` context manager, whose entry synchronizes the
    device and empties the allocator's cache: a decode loop runs under
    ``torch.cuda.set_sync_debug_mode("error")``.  cuBLAS keeps a workspace
    per (handle, stream); clearing the workspaces before and after the
    capture puts the side stream's in the graph's pool and leaves no
    pointer into that pool behind once the graph is dropped."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._stream: Optional[torch.cuda.Stream] = None

    def __call__(self, fn: Callable[[], Any]) -> tuple[torch.cuda.CUDAGraph, Any, int]:
        """Returns the graph, `fn`'s outputs (static: each replay rewrites
        them) and the bytes the graph's private pool reserved."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side = self._stream
        current = torch.cuda.current_stream(self.device)
        ready = torch.cuda.Event()
        ready.record(current)
        side.wait_event(ready)
        before = torch.cuda.memory_stats(self.device).get("reserved_bytes.all.current", 0)
        graph = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = fn()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
        finally:
            torch._C._cuda_clearCublasWorkspaces()
        current.wait_stream(side)
        pool = torch.cuda.memory_stats(self.device)["reserved_bytes.all.current"] - before
        return graph, out, pool


@dataclass(eq=False)
class StepGraph:
    """One key's state: seen once (`graph` None), or captured."""

    model_id: str
    slab: Any  # the engine's SharedKVSlab the graph reads and writes, or None
    baked: tuple = ()  # tensors read in place: held, so their storage outlives the key
    graph: Any = None
    inputs: tuple = ()  # static input buffers
    outputs: tuple = ()  # static outputs
    passed: tuple = ()  # per output: the index of the input it is, or None
    launches: dict = field(default_factory=dict)  # kernel launches a replay makes
    pool_bytes: int = 0
    held_bytes: int = 0  # the private pool and the static input buffers
    capture_seconds: float = 0.0


class StepGraphs:
    """An engine's captured decode steps.

    `capture(fn)` returns ``(graph, outputs, pool_bytes)`` where
    ``graph.replay()`` reruns the captured work into `outputs` and
    ``graph.reset()`` frees it (`CudaGraphCapture`; tests inject a double
    that runs the eager step).  Keys are kept in least-recently-used order:
    past `limit` keys or `budget` held bytes the least recently called goes
    first (`limit` and `budget` other than the module's constants are for
    tests)."""

    def __init__(self, capture: Callable, limit: int = GRAPH_LIMIT,
                 budget: int = GRAPH_BUDGET):
        self.capture = capture
        self.limit = limit
        self.budget = budget
        self._graphs: dict[tuple, StepGraph] = {}  # least recently called first
        self.shapes: set[tuple] = set()  # every specialisation called: jit's cache entries
        self.eager_steps = 0
        self.captures = 0
        self.replays = 0
        self.dropped = 0  # captured graphs freed
        self.evicted = 0  # of those, freed past the limit or the budget
        self.capture_seconds = 0.0
        self.pool_bytes_captured = 0  # over every capture

    def __len__(self) -> int:
        return sum(g.graph is not None for g in self._graphs.values())

    def live(self, model_id: Optional[str] = None) -> list[StepGraph]:
        """The captured graphs (of `model_id`)."""
        return [g for g in self._graphs.values() if g.graph is not None
                and (model_id is None or g.model_id == model_id)]

    def pool_bytes(self) -> int:
        """Device bytes the live graphs' private pools reserved: memory
        outside the ReuseStore's capacity."""
        return sum(g.pool_bytes for g in self.live())

    def held_bytes(self) -> int:
        """Device bytes the live keys hold: their private pools and static
        input buffers (what `budget` bounds)."""
        return sum(g.held_bytes for g in self.live())

    def static_bytes(self) -> int:
        """Device bytes the live keys' static tensors requested: their input
        buffers and the outputs a replay writes (in their private pools),
        each storage once; an output that is the caller's own input is not
        the key's."""
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for g in self.live()
                    for t in g.inputs + tuple(o for o, j in zip(g.outputs, g.passed)
                                              if j is None)}
        return sum(storages.values())

    def step(self, model_id: str, fn: Callable, static: tuple,
             inputs: Sequence[torch.Tensor], *, tree: int, baked: Sequence[torch.Tensor] = (),
             slab: Any = None) -> tuple:
        """``fn(*inputs)``, a tuple of tensors, for `model_id`'s step over
        the params tree numbered `tree` (the engine's generation number of
        the assembled tree): eager on a key's first call, captured on its
        second, replayed after.  `static`: the step's static arguments;
        `baked`: tensors `fn` reads or writes in place, not copied (their
        storage is part of the key); `slab`: what `drop(slab=)` matches."""
        shape = shape_key(static, (*inputs, *baked))
        key = shape + (tree, *(t.data_ptr() for t in baked))
        self.shapes.add(shape)
        g = self._graphs.pop(key, None)
        if g is None:
            while len(self._graphs) >= self.limit:
                self._evict(next(iter(self._graphs)))
            self._graphs[key] = StepGraph(model_id, slab, tuple(baked))
            self.eager_steps += 1
            return tuple(fn(*inputs))
        self._graphs[key] = g  # now the most recently called
        if g.graph is None:
            self._capture(g, fn, inputs)
            self._fit(g)
        for dst, src in zip(g.inputs, inputs):
            dst.copy_(src)
        g.graph.replay()
        kops.count_launches(g.launches)
        self.replays += 1
        return tuple(out.clone() if j is None else inputs[j]
                     for out, j in zip(g.outputs, g.passed))

    def _capture(self, g: StepGraph, fn: Callable, inputs: Sequence[torch.Tensor]):
        g.inputs = tuple(t.clone() for t in inputs)
        t0 = time.perf_counter()
        (g.graph, outputs, g.pool_bytes), g.launches = kops.launches_of(
            lambda: self.capture(lambda: tuple(fn(*g.inputs))))
        g.outputs = tuple(outputs)
        g.passed = tuple(next((j for j, t in enumerate(g.inputs) if out is t), None)
                         for out in g.outputs)
        g.held_bytes = g.pool_bytes + sum(t.nbytes for t in g.inputs)
        g.capture_seconds = time.perf_counter() - t0
        self.captures += 1
        self.capture_seconds += g.capture_seconds
        self.pool_bytes_captured += g.pool_bytes

    def _fit(self, kept: StepGraph):
        """Free the least recently called captured keys until the live ones
        hold at most `budget` bytes; `kept`, just captured, stays even
        alone over it."""
        over = self.held_bytes() - self.budget
        for key, g in list(self._graphs.items()):
            if over <= 0:
                break
            if g.graph is not None and g is not kept:
                over -= g.held_bytes
                self._evict(key)

    def _evict(self, key: tuple):
        g = self._graphs.pop(key)
        self.evicted += g.graph is not None
        self._free(g)

    def drop(self, *, model_id: Optional[str] = None, slab: Any = None):
        """Forget the keys of `model_id` (its params tree moved), or of
        `slab` (it grew); with neither, all."""
        for key in [key for key, g in self._graphs.items()
                    if (model_id is None and slab is None) or g.model_id == model_id
                    or (slab is not None and g.slab is slab)]:
            self._free(self._graphs.pop(key))

    def _free(self, g: StepGraph):
        if g.graph is not None:
            g.graph.reset()
            self.dropped += 1
        g.graph, g.inputs, g.outputs, g.passed, g.baked = None, (), (), (), ()
