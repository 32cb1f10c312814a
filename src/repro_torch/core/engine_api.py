"""Shared engine load protocol: one request/report surface for both planes.

`Engine.load` (real data plane, serving/engine.py) and `ModeledEngine.load`
(cost plane, serverless/fleet.py) grew from the same idea but diverged in
signature — the modeled plane took an `overlap_s` kwarg the real plane did
not, so the fleet gateways had to know which plane they were driving.  This
module pins the contract both planes implement (DESIGN.md §17):

    load(model_id, *, now=0.0, overlap_s=0.0) -> LoadReport

`LoadRequest` is the declarative form of one load; `submit_load` is the one
call site shape the gateways use, so a future signature change breaks the
protocol test instead of silently drifting one plane.

`now` is the modeled clock (real plane: forwarded to keep-alive aging and
the prefetch ledger); `overlap_s` is hideable wall seconds between placement
and the load's own h2d starting (the modeled plane prices prefetch overlap
with it; the real plane measures its overlap from the prefetch join and
accepts the field for parity).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, Sequence, runtime_checkable

from repro_torch.core.reuse_store import LoadReport
from repro_torch.models.tensors import TensorRecord


@dataclass(frozen=True)
class LoadRequest:
    """One declarative load: which model, when, and how much of the load's
    lead-in window (queueing/init) a background promotion may hide."""

    model_id: str
    now: float = 0.0
    overlap_s: float = 0.0


@runtime_checkable
class LoadableEngine(Protocol):
    """The surface both planes expose to a fleet gateway.

    Structural (`runtime_checkable`) so tests assert conformance without a
    shared base class — the planes stay import-independent.
    """

    engine_id: str

    def records_of(self, model_id: str) -> Sequence[TensorRecord]: ...

    def load(self, model_id: str, *, now: float = 0.0,
             overlap_s: float = 0.0) -> LoadReport: ...

    def prefetch(self, model_id: str, *, now: float = 0.0) -> None: ...

    def cancel_prefetch(self, model_id: str) -> None: ...

    def retain(self, model_id: str) -> None: ...

    def release(self, model_id: str) -> None: ...

    def set_host_capacity(self, capacity_bytes) -> int: ...

    def host_resident_bytes(self, records: Sequence[TensorRecord]) -> int: ...

    def host_free_bytes(self) -> int: ...

    def crash(self) -> None: ...

    def fault_summary(self) -> dict: ...


def submit_load(engine: LoadableEngine, req: LoadRequest) -> LoadReport:
    """The single gateway->engine load call site (both fleet gateways route
    through here), so the planes cannot drift apart in signature again."""
    return engine.load(req.model_id, now=req.now, overlap_s=req.overlap_s)
