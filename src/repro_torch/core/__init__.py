"""Tangram core (port): the modules the serving engine's main path needs.

Unified Memory Pool (regions), the MCE/PGP allocator, the tensor-level Reuse
Store, ElasticKV, the cost model and the fault injector — copies of the
reference files.  The cluster simulation, scheduler, trace generator and
host-cache model of `repro.core` are not ported yet.
"""
from repro_torch.core.allocator import (AllocationError, EvictionCandidate,  # noqa: F401
                                        NewTensor, PGPlan, apply_plan,
                                        global_merge_plan, minimal_cost_eviction,
                                        partitioned_gain_packing, try_packing)
from repro_torch.core.costmodel import (Hardware, PhaseCosts, estimate_load_time,  # noqa: F401
                                        estimate_load_time_tiered, paper_l40,
                                        tpu_v5e)
from repro_torch.core.elastic_kv import ElasticKV, KVStats  # noqa: F401
from repro_torch.core.regions import Region, RegionList, RState  # noqa: F401
from repro_torch.core.reuse_store import LoadReport, ReuseStore, TensorEntry  # noqa: F401
