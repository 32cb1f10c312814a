"""A whole run of each cell on the CPU at the program's smoke size (the
harness's look for a card skipped): `correct` is true as served, false
with the timed path broken underneath, and false with the control (the
float8 reference) in the program's place.

The faults a B 1 serving cell can have are `pbench/faults.py`'s: a token
altered where it is produced, and a decode step that returns its state
unchanged.  The window is the trace's first slice of four
requests of 48 decode steps each, whatever the machine's speed, and the
check compares all of them: with random weights a step leans on its own
token, so a fault of the context shows as a changed best token only over
enough tokens.

At this size the models run in float32, where the program and the
reference agree to rounding (widest gaps of 1e-6 to 1e-5 logits), and the
check's limit is the test size's own, TEST_LIMIT, set as the cells' limits
are: between the program's readings and the control's (float8: 0.1 and
more); the cells' limits are set at their full sizes in bfloat16."""
import dataclasses
import time
from pathlib import Path

import pytest

from pbench import cell, faults

ROOT = Path(__file__).resolve().parents[1]
CELLS = ["dense-trio.switch", "moe-duo.chat"]
SEED = 2**31 + 101
TEST_LIMIT = 1e-3
REQUESTS, STEPS = 4, 48


def run(workload, **kw):
    limits = {"max_logit_gap": TEST_LIMIT, "min_tokens_compared": REQUESTS * (STEPS + 1)}
    return cell.run(ROOT, workload, SEED, 0.0, False, t_start=time.perf_counter(),
                    device="cpu", shrink=lambda c: dataclasses.replace(c.smoke(), dtype="float32"),
                    log=lambda m: None,
                    traffic={"limits": limits, "check_requests": REQUESTS,
                             "slice_requests": REQUESTS, "decode_steps": STEPS}, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_served_tokens_are_correct_and_the_control_is_not(workload):
    out = run(workload, control=True)
    gap = out["checks"]["max_logit_gap"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]
    assert gap["value"] <= gap["limit"] < out["readings"]["max_control_gap"], out["readings"]
    assert list(out["checks"]) == ["max_logit_gap", "tokens_compared", "failed_requests"]
    assert list(out)[-1] == "checks"
    spec = cell.spec(ROOT)
    assert set(out["metrics"]) == {m["name"] for m in spec["end_to_end"]
                                   if workload in m.get("workloads", [workload])}


def plant(name, monkeypatch):
    for obj, attr, new in faults.patches(name):
        monkeypatch.setattr(obj, attr, new)


@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_token_fails(workload, monkeypatch):
    plant("token", monkeypatch)
    out = run(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_keeps_its_state_fails(workload, monkeypatch):
    plant("stuck", monkeypatch)
    out = run(workload)
    assert not out["correct"], out["checks"]
