"""Percentiles and spreads, as the benchmark reports them.

`percentile` is a frozen copy of `repro_torch.obs.metrics.percentile`
(re-exported as `repro_torch.core.trace.percentile`): sorted values, index
``min(n - 1, int(n * q))``, 0.0 on empty input.  `spread` is the spread
the benchmark's bounds are set from: the distance between the first and
the third quartile of `statistics.quantiles(values, n=4)`, as a share of
the median.
"""
from __future__ import annotations

import statistics
from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    xs = sorted(xs)
    if not xs:
        return 0.0
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def spread(values: Sequence[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
