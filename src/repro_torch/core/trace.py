"""Serverless workload generator (§5.1): Azure-trace-style arrivals with
Gamma-distributed inter-arrival times and tunable model-access locality.

Locality levels follow the paper exactly:
  L1: CV = 0.25, no consecutive same-model requests
  L2: CV = 0.5,  consecutive run lengths halved
  L3: CV = 1.0,  original consecutive runs
  L4: CV = 2.0,  original consecutive runs (burstier arrivals)

The paper's model pool (§5.1): 30% of models 1-3B, 60% 4-13B, 10% 14-30B,
drawn from OPT / LLaMA / Qwen / Yi / GPT families.  Dataset length profiles
match the four evaluation datasets.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Optional, Sequence


@dataclass(frozen=True)
class SimModel:
    model_id: str
    params: float  # parameter count
    n_tensors: int  # tensor-level granularity (dozens per model)
    alpha: float = 1.0  # latency sensitivity (Eq. 2)
    kv_bytes_per_token: int = 0

    @property
    def bytes(self) -> int:
        return int(self.params * 2)  # bf16/fp16


def _kv(layers: int, kv_heads: int, head_dim: int, dtype_bytes: int = 2) -> int:
    return 2 * layers * kv_heads * head_dim * dtype_bytes  # K and V


# The paper's eight evaluation models (Table 1 / Fig. 8).
PAPER_MODELS: list[SimModel] = [
    SimModel("gpt20B", 20.0e9, 44 + 4, kv_bytes_per_token=_kv(44, 64, 96)),
    SimModel("opt13B", 13.0e9, 40 + 4, kv_bytes_per_token=_kv(40, 40, 128)),
    SimModel("yi9B", 8.8e9, 48 + 4, kv_bytes_per_token=_kv(48, 4, 128)),
    SimModel("llama8B", 8.0e9, 32 + 4, kv_bytes_per_token=_kv(32, 8, 128)),
    SimModel("opt6.7B", 6.7e9, 32 + 4, kv_bytes_per_token=_kv(32, 32, 128)),
    SimModel("llama3B", 3.2e9, 28 + 4, kv_bytes_per_token=_kv(28, 8, 128)),
    SimModel("qwen3B", 3.1e9, 36 + 4, kv_bytes_per_token=_kv(36, 2, 128)),
    SimModel("opt1.3B", 1.3e9, 24 + 4, kv_bytes_per_token=_kv(24, 32, 64)),
]

# dataset -> (prompt lognormal (mu, sigma), output lognormal (mu, sigma))
DATASETS = {
    "sharegpt": ((6.2, 0.8), (5.5, 0.7)),
    "gsm8k": ((5.5, 0.5), (5.3, 0.5)),
    "alpaca": ((4.4, 0.6), (4.8, 0.6)),
    "humaneval": ((5.0, 0.4), (5.2, 0.6)),
}

LOCALITY = {  # level -> (CV, run_scale)
    "L1": (0.25, 0.0),
    "L2": (0.5, 0.5),
    "L3": (1.0, 1.0),
    "L4": (2.0, 1.0),
}


@dataclass(frozen=True)
class Request:
    time: float
    model_id: str
    dataset: str
    prompt_tokens: int
    output_tokens: int
    batch_size: int


# The ONE percentile convention now lives with the metrics registry
# (DESIGN.md §18); re-exported here because core.cluster.summarize and the
# serverless MetricsSink historically import it from this module.
from repro_torch.obs.metrics import percentile  # noqa: E402,F401


def synthetic_tensor_sizes(model: SimModel, rng: random.Random) -> list[int]:
    """Split a model's bytes into realistic per-tensor sizes: a few large
    (embeddings) + many medium (layer weights), 256-byte aligned."""
    n = model.n_tensors
    weights = [rng.uniform(6.0, 10.0)] * 2 + [rng.uniform(0.5, 1.5) for _ in range(n - 2)]
    total_w = sum(weights)
    sizes = [max(256, int(model.bytes * w / total_w) // 256 * 256) for w in weights]
    sizes[0] += model.bytes - sum(sizes)  # exact total
    return sizes


def synthetic_variant_records(vspec, base_records):
    """Cost-plane record set for a fine-tune variant (DESIGN.md §17).

    Mirrors what `tensor_records_for` does on the data plane: leaves the
    variant shares with its base keep the BASE record's fingerprint (one
    resident copy serves every sibling in whatever tier it lives), while
    delta leaves get variant-scoped fingerprints.  `vspec` is a
    `repro.models.tensors.VariantSpec`; synthetic base records name their
    leaves ``t0..tN``, so delta patterns are e.g. ``("t2", "t3")``.
    """
    spec = vspec.to_model_spec()
    recs = []
    for r in base_records:
        leaf = r.name.split("/", 1)[1] if "/" in r.name else r.name
        if spec.is_delta(leaf):
            fp = f"{vspec.variant_id}/{leaf}"
        else:
            fp = r.fingerprint  # shared with the base, bit for bit
        recs.append(type(r)(name=f"{vspec.variant_id}/{leaf}", shape=r.shape,
                            dtype=r.dtype, fingerprint=fp, nbytes=r.nbytes))
    return recs


def generate_trace(*, n_requests: int, models: Sequence[SimModel] = tuple(PAPER_MODELS),
                   locality: str = "L3", mean_interarrival: float = 20.0,
                   batch_size: int = 1, seed: int = 0,
                   popularity_zipf: float = 1.1,
                   max_output_tokens: int = 2048) -> list[Request]:
    cv, run_scale = LOCALITY[locality]
    rng = random.Random(seed)

    # Zipf popularity over models (locality source #1: skewed access)
    ranks = list(range(1, len(models) + 1))
    rng.shuffle(ranks)
    pop = [1.0 / (r ** popularity_zipf) for r in ranks]
    total = sum(pop)
    pop = [p / total for p in pop]

    # model id sequence with consecutive runs (locality source #2)
    seq: list[int] = []
    while len(seq) < n_requests:
        i = rng.choices(range(len(models)), weights=pop)[0]
        if run_scale == 0.0:
            if seq and seq[-1] == i:
                continue  # L1: never consecutive
            run = 1
        else:
            base_run = max(1, int(rng.expovariate(1 / 3.0)) + 1)  # mean ~3-4
            run = max(1, int(base_run * run_scale))
        seq.extend([i] * run)
    seq = seq[:n_requests]

    # Gamma inter-arrival with the requested CV: shape k = 1/CV^2
    k = 1.0 / (cv * cv)
    theta = mean_interarrival / k
    t = 0.0
    out: list[Request] = []
    ds_names = list(DATASETS)
    for idx in seq:
        t += rng.gammavariate(k, theta)
        ds = rng.choice(ds_names)
        (pm, ps), (om, osig) = DATASETS[ds]
        prompt = max(8, int(rng.lognormvariate(pm, ps)))
        output = max(4, int(rng.lognormvariate(om, osig)))
        out.append(Request(time=t, model_id=models[idx].model_id, dataset=ds,
                           prompt_tokens=min(prompt, 4096),
                           output_tokens=min(output, max_output_tokens),
                           batch_size=batch_size))
    return out


def generate_multi_tenant_trace(*, n_requests: int,
                                models: Sequence[SimModel] = tuple(PAPER_MODELS),
                                locality: str = "L3",
                                mean_interarrival: float = 20.0,
                                burst_every: int = 40, burst_size: int = 8,
                                burst_models: int = 2, burst_window: float = 2.0,
                                batch_size: int = 1, seed: int = 0,
                                max_output_tokens: int = 256) -> list[Request]:
    """Multi-tenant concurrency scenario: a base trace with overlapping bursts.

    Every `burst_every` base requests, `burst_size` near-simultaneous
    requests arrive within `burst_window` seconds, spread round-robin over
    the `burst_models` most popular models of the base trace — so the same
    device sees several models demanding decode at once (same-model burst
    when burst_models == 1: the hot-model stampede the queueing-aware
    affinity score exists for).  Returns the merged, time-sorted trace.
    """
    base = generate_trace(n_requests=n_requests, models=models,
                          locality=locality,
                          mean_interarrival=mean_interarrival,
                          batch_size=batch_size, seed=seed,
                          max_output_tokens=max_output_tokens)
    from collections import Counter

    hot = [m for m, _ in Counter(r.model_id for r in base)
           .most_common(max(1, burst_models))]
    rng = random.Random(seed + 101)
    ds_names = list(DATASETS)
    bursts: list[Request] = []
    for anchor in range(burst_every - 1, len(base), burst_every):
        t0 = base[anchor].time
        for j in range(burst_size):
            ds = rng.choice(ds_names)
            (pm, ps), (om, osig) = DATASETS[ds]
            prompt = max(8, int(rng.lognormvariate(pm, ps)))
            output = max(4, int(rng.lognormvariate(om, osig)))
            bursts.append(Request(
                time=t0 + rng.uniform(0.0, burst_window),
                model_id=hot[j % len(hot)], dataset=ds,
                prompt_tokens=min(prompt, 4096),
                output_tokens=min(output, max_output_tokens),
                batch_size=batch_size))
    return sorted(base + bursts, key=lambda r: r.time)


def access_intervals(trace: Sequence[Request]) -> dict[str, list[int]]:
    """Fig. 4a: per-model distribution of intervening requests between
    consecutive accesses to the same model."""
    last_seen: dict[str, int] = {}
    intervals: dict[str, list[int]] = {}
    for i, r in enumerate(trace):
        if r.model_id in last_seen:
            intervals.setdefault(r.model_id, []).append(i - last_seen[r.model_id] - 1)
        last_seen[r.model_id] = i
    return intervals
