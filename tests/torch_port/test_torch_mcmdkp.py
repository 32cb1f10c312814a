"""The port's copy of the exact MCMDKP oracle (`core/mcmdkp.py`) against the
reference's, and tests/test_allocator.py::test_pgp_vs_oracle run on the
port's allocator: on random small pool instances the port's Partitioned-Gain
Packing plan is feasible and never cheaper than the port's oracle, and the
port's oracle gives the reference oracle's minimal cost on the same
instance.  The copy itself is diffed against the reference file by
test_torch_lockstep.py."""
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("jax")  # the reference package imports it

from repro.core import mcmdkp as ref_mcmdkp  # noqa: E402
from repro_torch.core.allocator import (AllocationError, NewTensor, apply_plan,  # noqa: E402
                                        partitioned_gain_packing)
from repro_torch.core.mcmdkp import Resident, layout_of, oracle_min_cost  # noqa: E402
from repro_torch.core.regions import RegionList, RState  # noqa: E402


def _ref_cost(capacity, layout, residents, news):
    ref_res = {n: ref_mcmdkp.Resident(r.fingerprint, r.size, r.evict_cost,
                                      r.evictable, r.movable)
               for n, r in residents.items()}
    return ref_mcmdkp.oracle_min_cost(capacity, layout, ref_res, news)


@st.composite
def pool_instance(draw):
    """tests/test_allocator.py's instance strategy over the port's RegionList."""
    cap = draw(st.integers(40, 120))
    rl = RegionList(cap)
    residents = {}
    for i in range(draw(st.integers(0, 4))):
        size = draw(st.integers(3, 25))
        if rl.alloc_best_fit(size, RState.TENSOR, f"r{i}") is None:
            continue
        residents[f"r{i}"] = Resident(f"r{i}", size, evict_cost=draw(
            st.floats(0.1, 10.0, allow_nan=False)), evictable=True, movable=True)
    for name in list(residents):  # free a subset to fragment
        if draw(st.booleans()):
            rl.free(rl.find(name).offset)
            del residents[name]
    free = rl.free_bytes() + sum(r.size for r in residents.values())
    news = []
    for _ in range(draw(st.integers(1, 3))):
        if free <= 2:
            break
        s = draw(st.integers(1, max(1, min(25, free // 2))))
        news.append(s)
        free -= s
    return rl, residents, news


@settings(max_examples=120, deadline=None)
@given(pool_instance())
def test_port_pgp_vs_port_oracle(instance):
    rl, residents, news = instance
    if not news:
        return
    layout = layout_of(rl)
    opt = oracle_min_cost(rl.capacity, layout, residents, news)
    assert opt == _ref_cost(rl.capacity, layout, residents, news)
    tensors = [NewTensor(f"n{i}", s) for i, s in enumerate(news)]
    try:
        plan = partitioned_gain_packing(rl, tensors)
    except AllocationError:
        assert opt is None or rl.free_bytes() < sum(news)
        return
    moved, _, placed = apply_plan(rl, plan)
    rl.check()
    assert set(placed) == {t.fingerprint for t in tensors}
    assert opt is not None, "oracle says infeasible but heuristic placed"
    assert moved + 1e-9 >= opt or moved <= sum(r.size for r in residents.values())


def test_oracle_costs_match_reference_on_seeded_instances():
    """200 seeded instances with evictions, immovable and unevictable
    residents: equal minimal costs (None where both find no plan)."""
    rng = random.Random(7)
    feasible = infeasible = 0
    for _ in range(200):
        cap = rng.randint(30, 90)
        rl = RegionList(cap)
        residents = {}
        for i in range(rng.randint(1, 5)):
            size = rng.randint(3, 20)
            if rl.alloc_best_fit(size, RState.TENSOR, f"r{i}") is not None:
                residents[f"r{i}"] = Resident(f"r{i}", size, rng.uniform(0.1, 10.0),
                                              evictable=rng.random() > 0.2,
                                              movable=rng.random() > 0.2)
        for name in list(residents):
            if rng.random() < 0.4:
                rl.free(rl.find(name).offset)
                del residents[name]
        news = [rng.randint(1, 30) for _ in range(rng.randint(1, 3))]
        layout = layout_of(rl)
        cost = oracle_min_cost(cap, layout, residents, news)
        assert cost == _ref_cost(cap, layout, residents, news), (layout, news)
        feasible += cost is not None
        infeasible += cost is None
    assert feasible and infeasible
