"""Tangram core: the paper's primary contribution.

Unified Memory Pool (regions), two-stage MCMDKP allocator (MCE + PGP),
tensor-level Reuse Store, ElasticKV on-demand KV allocation, GPU-affinity
scheduling, and the controller/worker cluster simulation.
"""
from repro_torch.core.allocator import (AllocationError, EvictionCandidate,  # noqa: F401
                                  NewTensor, PGPlan, apply_plan,
                                  global_merge_plan, minimal_cost_eviction,
                                  partitioned_gain_packing, try_packing)
from repro_torch.core.cluster import (POLICIES, ClusterSim, RequestResult,  # noqa: F401
                                SimPolicy, SimWorker, WorkerInstance, summarize)
from repro_torch.core.costmodel import (Hardware, PhaseCosts, estimate_load_time,  # noqa: F401
                                  estimate_load_time_tiered, paper_l40,
                                  tpu_v5e)
from repro_torch.core.elastic_kv import ElasticKV, KVStats  # noqa: F401
from repro_torch.core.hostcache import SimHostCache  # noqa: F401
from repro_torch.core.regions import Region, RegionList, RState  # noqa: F401
from repro_torch.core.reuse_store import LoadReport, ReuseStore, TensorEntry  # noqa: F401
from repro_torch.core.scheduler import (AFFINITY_POLICIES, ScheduleEntry,  # noqa: F401
                                  affinity_schedule, random_schedule)
from repro_torch.core.trace import (DATASETS, LOCALITY, PAPER_MODELS, Request,  # noqa: F401
                              SimModel, access_intervals, generate_trace,
                              generate_multi_tenant_trace, percentile,
                              synthetic_tensor_sizes)
