"""Serverless control plane (DESIGN.md §13).

The layer above per-request placement: a trace-driven workload generator
with a co-located-tenant pressure feed (`workload`), a per-model instance
lifecycle manager with pluggable keep-alive policies (`lifecycle`), a
request gateway with TTFT-breakdown metrics (`gateway`), and a multi-engine
fleet gateway with affinity routing and predictive pre-warm (`fleet`,
DESIGN.md §14).  The cluster simulator (`SimPolicy.lifecycle`,
`POLICIES["tangram-serverless"]`) and the real engine
(`launch/serve.py --trace [--n-engines N]`) both run under it.
"""
from repro_torch.serverless.gateway import (Gateway, MetricsSink,  # noqa: F401
                                      TTFTRecord, percentile,
                                      run_serverless_sim)
from repro_torch.serverless.fleet import (EngineNode, FleetGateway,  # noqa: F401
                                    ModeledEngine, ModeledFleetGateway)
from repro_torch.serverless.lifecycle import (AdaptiveHistogram, FixedTTL,  # noqa: F401
                                        InstanceState, LifecycleManager,
                                        make_keep_alive)
from repro_torch.serverless.workload import (ARRIVALS, FaultEvent,  # noqa: F401
                                       PressureEvent, burst_trace,
                                       chaos_schedule, diurnal_trace,
                                       make_trace, poisson_trace,
                                       pressure_walk, pressure_wave)
