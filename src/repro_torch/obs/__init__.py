"""Observability plane (DESIGN.md §18): span tracing, metrics, export.

One instrumentation surface for BOTH planes.  The tracer is clock-injected
— the real data plane stamps spans with ``time.perf_counter`` walls, the
modeled/sim plane passes explicit virtual trace-clock timestamps — so a
request's phase timeline has one vocabulary everywhere, and the
span-accounting identity (Σ child phase spans == reported TTFT, unattributed
time ≈ 0) can be asserted on any run.

Deliberately imports nothing from the rest of the package except
``repro.stats`` (which itself imports nothing): every layer — core, serving,
serverless, benchmarks — may import this one without cycles.
"""
from repro_torch.obs.accounting import (cost_model_ratios, obs_stats,
                                  request_accounting, trace_request)
from repro_torch.obs.export import chrome_trace, write_chrome_trace
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               percentile)
from repro_torch.obs.ring import BoundedLog
from repro_torch.obs.tracer import (NULL_TRACER, FlightRecorder, SpanEvent,
                              Tracer)

__all__ = [
    "BoundedLog",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_TRACER",
    "SpanEvent",
    "Tracer",
    "chrome_trace",
    "cost_model_ratios",
    "obs_stats",
    "percentile",
    "request_accounting",
    "trace_request",
    "write_chrome_trace",
]
