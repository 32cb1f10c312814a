"""The compiled paged decode step: CUDA graphs of `_paged_decode_step`,
shared by every instance of a model on one engine (port-only; the
reference's counterpart is ``jax.jit`` on `repro/serving/engine.py`
`_paged_decode_step`, one compiled, buffer-donating program a step).

A graph is keyed by what ``jax.jit`` specialises on (`cfg`, `attn`, and
the shapes and dtypes of the token, the block tables, the lengths and the
KV slab: B, the table width N and the page count P) and by what a graph
bakes in and a jit does not: the identity of the params tree it read and
the slab's storage.  Instances of one model read one tree and one slab, so
they share a key.  The first call for a key runs eagerly and is the
answer; the second captures and replays; later calls replay.

A replay copies the caller's token, tables and lengths into the graph's
static input buffers on the current stream (device to device: the step
never reads the device back), replays, adds the launches the capture's
wrappers counted (`ops.count_launches`), and returns clones of the static
outputs: the next replay of the key, which may be another instance's,
overwrites them, as the reference returns fresh arrays.

A graph holds raw pointers, not tensors.  The engine drops a model's
graphs wherever its params tree is written or deleted, where its last
instance finishes, where the slab grows, and at close and crash
(`StepGraphs.drop`); a dropped graph's private memory pool goes back to
the caching allocator, whose next ``empty_cache`` returns it to the card.
A capture or replay that fails raises: nothing falls back to the eager
step.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.kernels import ops as kops

GRAPH_LIMIT = 64  # live keys per engine, as the engine bounds its fused-state cache


def shape_key(cfg, attn: str, *tensors: torch.Tensor) -> tuple:
    """What ``jax.jit`` specialises `_paged_decode_step` on: the static
    arguments and each array argument's shape and dtype (the params' shapes
    follow from `cfg`)."""
    return (cfg, attn) + tuple((tuple(t.shape), t.dtype) for t in tensors)


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
    slab: Any  # the engine's SharedKVSlab the graph reads and writes
    graph: Any = None
    inputs: tuple = ()  # static token, tables, lengths
    outputs: tuple = ()  # static logits, lengths + 1
    launches: dict = field(default_factory=dict)  # kernel launches a replay makes
    pool_bytes: int = 0


class StepGraphs:
    """An engine's captured decode steps.

    `step_fn` is the eager step, ``step_fn(params, cfg, token, tables,
    lengths, k_pages, v_pages, attn=...) -> (logits, lengths + 1)``;
    `capture(fn)` returns ``(graph, outputs, pool_bytes)`` where
    ``graph.replay()`` reruns the captured work into `outputs` and
    ``graph.reset()`` frees it (`CudaGraphCapture`; tests inject a double
    that runs the eager step)."""

    def __init__(self, step_fn: Callable, capture: Callable, limit: int = GRAPH_LIMIT):
        self.step_fn = step_fn
        self.capture = capture
        self.limit = limit
        self._graphs: dict[tuple, StepGraph] = {}
        self.shapes: set[tuple] = set()  # every specialisation called: jit's cache entries
        self.eager_steps = 0
        self.captures = 0
        self.replays = 0
        self.dropped = 0  # captured graphs freed
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

    def step(self, model_id: str, params, cfg, slab, token, tables, lengths, attn: str):
        k_pages, v_pages = slab.k_pages, slab.v_pages
        shape = shape_key(cfg, attn, token, tables, lengths, k_pages, v_pages)
        key = shape + (id(params), k_pages.data_ptr(), v_pages.data_ptr())
        self.shapes.add(shape)
        g = self._graphs.get(key)
        if g is None:
            while len(self._graphs) >= self.limit:
                self._free(self._graphs.pop(next(iter(self._graphs))))
            self._graphs[key] = StepGraph(model_id, slab)
            self.eager_steps += 1
            return self.step_fn(params, cfg, token, tables, lengths, k_pages, v_pages,
                                attn=attn)
        if g.graph is None:
            self._capture(g, params, cfg, token, tables, lengths, k_pages, v_pages, attn)
        for dst, src in zip(g.inputs, (token, tables, lengths)):
            dst.copy_(src)
        g.graph.replay()
        kops.count_launches(g.launches)
        self.replays += 1
        logits, new_lens = g.outputs
        return logits.clone(), new_lens.clone()

    def _capture(self, g: StepGraph, params, cfg, token, tables, lengths, k_pages, v_pages,
                 attn):
        g.inputs = (token.clone(), tables.clone(), lengths.clone())
        tok, tab, lens = g.inputs
        t0 = time.perf_counter()
        (g.graph, g.outputs, g.pool_bytes), g.launches = kops.launches_of(
            lambda: self.capture(lambda: self.step_fn(params, cfg, tok, tab, lens, k_pages,
                                                      v_pages, attn=attn)))
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0
        self.pool_bytes_captured += g.pool_bytes

    def drop(self, *, model_id: Optional[str] = None, slab: Any = None):
        """Forget the keys of `model_id` (its params tree moved or its last
        instance finished), or of `slab` (it grew); with neither, all."""
        for key in [key for key, g in self._graphs.items()
                    if (model_id is None and slab is None) or g.model_id == model_id
                    or (slab is not None and g.slab is slab)]:
            self._free(self._graphs.pop(key))

    def _free(self, g: StepGraph):
        if g.graph is not None:
            g.graph.reset()
            self.dropped += 1
        g.graph, g.inputs, g.outputs = None, (), ()
