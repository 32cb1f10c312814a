"""A whole traced run of each cell on the card, every model cut to two
layers at its full width (so the kernels run at the cell's shapes): the
served tokens are correct, every per-layer metric of the cell is read, and
no share of a peak or a roofline passes 100 %."""
import dataclasses
import json
import time
from pathlib import Path

import pytest

from pbench import cell

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_traced_run_on_the_card(workload, cuda_device):
    out = cell.run(ROOT, workload, 2**31 + 202, 3.0, True, t_start=time.perf_counter(),
                   device=cuda_device, shrink=lambda c: dataclasses.replace(c, num_layers=2),
                   log=lambda m: None)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    want = {m["name"] for m in SPEC["per_layer"] if workload in m["workloads"]}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)
    assert out["breakdown"]["device_ops"] and len(out["breakdown"]["idle_gaps"]) <= 10
