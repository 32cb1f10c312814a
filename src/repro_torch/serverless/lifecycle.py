"""Instance lifecycle manager: cold/warm/live states and keep-alive policies.

The serverless layer the paper's evaluation assumes but the repo previously
left to callers: after a model's last in-flight request drains, SOMETHING
must decide how long the idle instance stays warm before scaling to zero.
That decision sets the cold-start rate — and through it the TTFT tail — so
it is a policy object here, not a constant:

  * ``zero``       scale-to-zero-always: terminate the instant the instance
                   idles (the pure pay-per-use baseline; every re-arrival is
                   a cold start unless it joins a running batch);
  * ``fixed:T``    fixed TTL of T seconds (the industry default, and what
                   the cluster sim hard-coded as ``SimPolicy.keep_alive``);
  * ``adaptive``   histogram-adaptive keep-alive à la Serverless in the
                   Wild: per-model inter-arrival histograms pick a TTL that
                   covers the p-th percentile gap, clamped to
                   [min_ttl, max_ttl]; models whose typical gap exceeds the
                   window scale down fast instead of squatting on memory.

``LifecycleManager`` is plane-agnostic: the cluster simulator consults it
for idle TTLs (``SimPolicy.lifecycle``) and the real-engine ``Gateway``
drives ``Engine.retain``/``release`` from the same decisions.  Every
transition is appended to an event log so golden tests can pin the whole
decision sequence replay-exactly.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Optional


class InstanceState(enum.Enum):
    COLD = "cold"  # no instance anywhere: next request pays the full start
    WARM = "warm"  # idle instance in keep-alive: next request skips loading
    LIVE = "live"  # at least one in-flight request is decoding


# --------------------------------------------------------------- policies
class FixedTTL:
    """Constant keep-alive.  ``FixedTTL(0)`` is scale-to-zero-always."""

    def __init__(self, ttl_s: float):
        assert ttl_s >= 0.0
        self.ttl_s = ttl_s

    def observe(self, model_id: str, gap_s: float):  # no state to learn
        pass

    def ttl(self, model_id: str) -> float:
        return self.ttl_s

    def predict_gap(self, model_id: str, min_gap_s: float = 0.0):
        """Fixed TTLs carry no arrival model: nothing to predict, so the
        fleet's predictive pre-warm is a structural no-op under them."""
        return None


class AdaptiveHistogram:
    """Histogram-adaptive keep-alive (Serverless in the Wild, ATC'20).

    Each model keeps a bucketed histogram of its inter-arrival gaps.  The
    TTL is the ``percentile``-th gap times a safety ``margin``, clamped to
    [min_ttl, max_ttl] — long enough that the typical re-arrival finds the
    instance warm.  Two deliberate edges:

      * fewer than ``min_samples`` observations -> ``default_ttl`` (a new
        model gets the benefit of the doubt, not scale-to-zero);
      * the percentile lands in the overflow bucket (gaps beyond the
        histogram window) -> ``min_ttl``: the model's re-arrivals are so
        far apart that keeping it warm buys nothing, so release the memory
        to co-located tenants quickly.
    """

    def __init__(self, *, bucket_s: float = 5.0, window_s: float = 240.0,
                 percentile: float = 0.95, margin: float = 1.25,
                 min_ttl: float = 2.0, max_ttl: float = 300.0,
                 default_ttl: float = 60.0, min_samples: int = 4):
        assert 0.0 < percentile <= 1.0
        self.bucket_s = bucket_s
        self.n_buckets = max(1, int(math.ceil(window_s / bucket_s)))
        self.percentile = percentile
        self.margin = margin
        self.min_ttl = min_ttl
        self.max_ttl = max_ttl
        self.default_ttl = default_ttl
        self.min_samples = min_samples
        # model -> [n_buckets counts] + overflow count at index n_buckets
        self._hist: dict[str, list[int]] = {}
        self._count: dict[str, int] = {}

    def observe(self, model_id: str, gap_s: float):
        hist = self._hist.setdefault(model_id,
                                     [0] * (self.n_buckets + 1))
        idx = min(int(gap_s / self.bucket_s), self.n_buckets)
        hist[idx] += 1
        self._count[model_id] = self._count.get(model_id, 0) + 1

    def ttl(self, model_id: str) -> float:
        n = self._count.get(model_id, 0)
        if n < self.min_samples:
            return self.default_ttl
        hist = self._hist[model_id]
        need = self.percentile * n
        seen = 0
        for idx, c in enumerate(hist):
            seen += c
            if seen >= need:
                if idx >= self.n_buckets:
                    return self.min_ttl  # typical gap beyond the window
                ttl = (idx + 1) * self.bucket_s * self.margin
                return min(self.max_ttl, max(self.min_ttl, ttl))
        return self.min_ttl  # unreachable (seen == n >= need at the end)

    def predict_gap(self, model_id: str, min_gap_s: float = 0.0
                    ) -> Optional[tuple[float, float]]:
        """Predict the model's NEXT inter-arrival gap for pre-warm
        scheduling: ``(gap_s, prob)`` or None when the histogram cannot say.

        NOT the ``ttl()`` walk.  The TTL is a coverage percentile (stay warm
        through 95% of gaps); prediction asks when the re-arrival actually
        LANDS, so it takes the median — and, crucially, the median
        CONDITIONED on the gap already exceeding ``min_gap_s``.  The fleet
        arms pre-warm when the keep-alive lapses, i.e. the model has
        already been idle ``ttl`` seconds, and serverless gap distributions
        are bimodal (intra-burst seconds vs. inter-burst minutes): the
        unconditional median sits in the burst spike the keep-alive
        already absorbed, while the conditional walk lands on the
        inter-burst mode — the arrivals pre-warm exists for.

        The bucket midpoint is returned (unbiased within resolution),
        unclamped and without the safety margin.  ``prob`` is the
        conditional mass within one bucket either side of the prediction:
        sharply periodic re-arrivals (burst volleys) score near 1, diffuse
        Poisson tails spread over many buckets and score low — exactly the
        discount the fleet's cost/benefit check needs.  None below
        ``min_samples``, with fewer than 2 conditional in-window samples,
        or when the surviving mass sits in the overflow bucket
        (re-arrivals beyond the window are unpredictable)."""
        n = self._count.get(model_id, 0)
        if n < self.min_samples:
            return None
        hist = self._hist[model_id]
        lo = min(int(min_gap_s / self.bucket_s), self.n_buckets)
        cond = hist[lo:self.n_buckets]  # in-window mass with gap > min_gap
        m = sum(cond)
        if m < 2:
            return None  # one straggler gap is an anecdote, not a model
        need = 0.5 * m
        seen = 0
        for j, c in enumerate(cond):
            seen += c
            if seen >= need:
                idx = lo + j
                around = sum(hist[max(lo, idx - 1):
                                  min(self.n_buckets, idx + 2)])
                return (idx + 0.5) * self.bucket_s, around / m
        return None  # unreachable (seen == m >= need at the end)


def make_keep_alive(spec):
    """Parse a keep-alive policy spec: ``zero``, ``fixed`` / ``fixed:T``,
    ``adaptive`` / ``adaptive:P`` (P the percentile, e.g. ``adaptive:0.99``).
    The ONE factory both planes and every CLI flag route through.  An
    already-constructed policy object (anything with a ``ttl`` method)
    passes through unchanged, so callers that need non-default histogram
    geometry — e.g. the fleet benchmark's wide prediction window — reuse
    the same entry point."""
    if hasattr(spec, "ttl"):
        return spec
    name, _, arg = spec.partition(":")
    if name == "zero":
        return FixedTTL(0.0)
    if name == "fixed":
        return FixedTTL(float(arg) if arg else 40.0)
    if name == "adaptive":
        if arg:
            return AdaptiveHistogram(percentile=float(arg))
        return AdaptiveHistogram()
    raise ValueError(f"unknown keep-alive policy {spec!r} "
                     "(expected zero | fixed[:T] | adaptive[:P])")


# ---------------------------------------------------------------- manager
@dataclass
class LifecycleCounters:
    cold_starts: int = 0
    warm_starts: int = 0  # keep-alive hits (idle instance reused) + joins
    expirations: int = 0  # idle instances scaled to zero
    arrivals: int = 0


class LifecycleManager:
    """Per-model cold/warm/live tracking + keep-alive decisions.

    The manager is the single authority both planes consult: the cluster
    sim asks ``on_idle`` for the TTL its ``idle_expire`` event should use,
    the real-plane Gateway turns the same answer into ``Engine.retain`` (a
    positive TTL) or ``Engine.release`` (scale-to-zero).  ``log`` records
    every (time, event, model, detail) transition — two runs over the same
    trace must produce identical logs (pinned by the golden tests)."""

    def __init__(self, policy):
        self.policy = policy
        self.counters = LifecycleCounters()
        self.state: dict[str, InstanceState] = {}
        self._last_arrival: dict[str, float] = {}
        self.log: list[tuple[float, str, str, float]] = []

    def _note(self, now: float, event: str, model_id: str, detail: float):
        self.log.append((round(now, 6), event, model_id, round(detail, 6)))

    def state_of(self, model_id: str) -> InstanceState:
        return self.state.get(model_id, InstanceState.COLD)

    def observe_arrival(self, model_id: str, now: float):
        """Record an arrival (feeds the adaptive histogram's gap samples)."""
        self.counters.arrivals += 1
        last = self._last_arrival.get(model_id)
        if last is not None:
            self.policy.observe(model_id, max(0.0, now - last))
        self._last_arrival[model_id] = now

    def on_start(self, model_id: str, now: float, *, warm: bool):
        """An instance started serving (cold placement, keep-alive hit, or
        a join onto a running batch — the latter two are warm)."""
        if warm:
            self.counters.warm_starts += 1
        else:
            self.counters.cold_starts += 1
        self.state[model_id] = InstanceState.LIVE
        self._note(now, "warm" if warm else "cold", model_id, 0.0)

    def on_idle(self, model_id: str, now: float) -> float:
        """The model's last in-flight request drained: return the keep-alive
        TTL.  <= 0 means scale to zero immediately (the caller must also
        call ``on_expire``)."""
        ttl = self.policy.ttl(model_id)
        self.state[model_id] = (InstanceState.WARM if ttl > 0
                                else InstanceState.COLD)
        self._note(now, "idle", model_id, ttl)
        return ttl

    def predict_next_arrival(self, model_id: str, now: Optional[float] = None
                             ) -> Optional[tuple[float, float]]:
        """Predictive pre-warm feed (fleet gateway): ``(eta, prob)`` — the
        absolute trace time the model's next arrival is expected at, and the
        probability mass behind the prediction — or None when the policy
        cannot predict (fixed TTLs, cold history, out-of-window gaps).
        With ``now`` given, the policy conditions on the gap already being
        at least ``now - last_arrival`` (the model has provably been idle
        that long — see ``AdaptiveHistogram.predict_gap``).  The estimate is
        last-arrival + predicted gap, so it only moves when a new arrival
        is observed — replay-deterministic."""
        predict = getattr(self.policy, "predict_gap", None)
        last = self._last_arrival.get(model_id)
        if predict is None or last is None:
            return None
        min_gap = max(0.0, now - last) if now is not None else 0.0
        pred = predict(model_id, min_gap)
        if pred is None:
            return None
        gap, prob = pred
        return last + gap, prob

    def on_expire(self, model_id: str, now: float):
        """An idle instance's keep-alive lapsed (or was scaled to zero)."""
        self.counters.expirations += 1
        self.state[model_id] = InstanceState.COLD
        self._note(now, "expire", model_id, 0.0)

    def summary(self) -> dict[str, float]:
        c = self.counters
        starts = c.cold_starts + c.warm_starts
        return {
            "arrivals": c.arrivals,
            "cold_starts": c.cold_starts,
            "warm_starts": c.warm_starts,
            "expirations": c.expirations,
            "cold_start_rate": c.cold_starts / starts if starts else 0.0,
        }
