"""Arrival traces of a cell, made from its traffic file.

A frozen copy, changed where noted, of the Poisson / Zipf generator in
`src/repro_torch/serverless/workload.py` (`_popularity`, `poisson_trace`):
the benchmark keeps its own so that a change to the program cannot change
the traffic it is measured on.  The changes:

  * the popularity ranks are the traffic file's order of models, not
    shuffled by a seed;
  * every block of ``block`` requests takes one fixed set of exponential
    gaps (their quantiles at the file's rate) and one fixed count of
    requests per model (the Zipf shares of the block, largest remainders
    first), put in an order drawn from the file's ``order_seed``.

Every run of a cell so replays one trace, and the run's seed draws only the
weights and the prompts.  At 4/5 of the knee the queue makes a tail of the
time to first token follow the order of the arrivals and of the models (a
switch costs a load): on one H100, six seeds of `moe-duo.chat` whose orders
came from the run's seed spread its 90th percentile by 28 %, where two runs
of one seed differ by 0.1-4 %.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Iterator, Sequence


@dataclass(frozen=True)
class Arrival:
    time: float  # seconds on the trace clock
    model_id: str


def popularity(n: int, zipf: float) -> list[float]:
    """Zipf shares of ranks 1..n (the original's `_popularity`, unshuffled)."""
    pop = [1.0 / (r ** zipf) for r in range(1, n + 1)]
    total = sum(pop)
    return [p / total for p in pop]


def block_counts(shares: Sequence[float], block: int) -> list[int]:
    """`block` requests split by `shares`, largest remainders first."""
    raw = [s * block for s in shares]
    counts = [math.floor(x) for x in raw]
    order = sorted(range(len(raw)), key=lambda i: (counts[i] - raw[i], i))
    for i in order[: block - sum(counts)]:
        counts[i] += 1
    return counts


def exponential_gaps(rate: float, block: int) -> list[float]:
    """The `block` quantiles of an exponential law of mean 1 / rate, at the
    midpoints of equal slices of probability."""
    return [-math.log(1.0 - (j + 0.5) / block) / rate for j in range(block)]


def arrivals(traffic: dict, start: float = 0.0) -> Iterator[Arrival]:
    """The cell's trace after `start`, without end: the window takes as
    many arrivals as it serves."""
    models = list(traffic["ranks"])
    block = traffic["block"]
    gaps = exponential_gaps(traffic["rate_per_s"], block)
    counts = block_counts(popularity(len(models), traffic["zipf"]), block)
    picks = [m for m, c in zip(models, counts) for _ in range(c)]
    rng = random.Random(traffic["order_seed"])
    t = start
    while True:
        g, p = gaps[:], picks[:]
        rng.shuffle(g)
        rng.shuffle(p)
        for gap, model in zip(g, p):
            t += gap
            yield Arrival(t, model)


def warmup(traffic: dict, spacing_s: float) -> list[Arrival]:
    """Each model served `warmup_rounds` times, in rank order, `spacing_s`
    apart on the trace clock (far enough that none of them queues)."""
    models = list(traffic["ranks"])
    n = traffic["warmup_rounds"] * len(models)
    return [Arrival(spacing_s * (i + 1), models[i % len(models)]) for i in range(n)]


def mix(seed: int, *parts: int) -> int:
    """A 63-bit seed for a part of the run (a model's weights, a prompt),
    from the run's seed, which may be larger than 32 bits."""
    h = seed & ((1 << 64) - 1)
    for p in parts:
        h = (h * 0x9E3779B97F4A7C15 + p + 1) & ((1 << 64) - 1)
        h ^= h >> 29
    return h & ((1 << 63) - 1)
