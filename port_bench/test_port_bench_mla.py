"""The `dsv2-lite.longdoc` cell run whole on the CPU at the program's smoke
size (DeepSeek-V2-Lite's `smoke()`: latent attention, YaRN, a dense layer 0,
routed and shared experts, in float32), as `test_port_bench_faults.py` runs
the other cells: `correct` is true as served, false under the float8
control, and false with each fault of `pbench/faults.py` planted (a token
altered where it is produced; a decode step that keeps its state).  The
prompt is cut to PROMPT tokens: the cell's 16,384 would give the plain
attention 4 GB of float32 scores a layer on the CPU.  Limit and window as
there (TEST_LIMIT between the float32 program's readings and the
control's); the cell's own limits are set at its full size in bfloat16.

Then `pbench/mla_counts.py` against counts made by hand at the published
widths."""
import dataclasses
import json
import time
from pathlib import Path

import pytest

from pbench import cell, faults
from pbench import mla_counts as mc

ROOT = Path(__file__).resolve().parents[1]
CELL = "dsv2-lite.longdoc"
SEED = 2**31 + 101
TEST_LIMIT = 1e-3
REQUESTS, STEPS, PROMPT = 4, 48, 256


def run(**kw):
    limits = {"max_logit_gap": TEST_LIMIT, "min_tokens_compared": REQUESTS * (STEPS + 1)}
    return cell.run(ROOT, CELL, SEED, 0.0, False, t_start=time.perf_counter(), device="cpu",
                    shrink=lambda c: dataclasses.replace(c.smoke(), dtype="float32"),
                    log=lambda m: None,
                    traffic={"limits": limits, "check_requests": REQUESTS,
                             "slice_requests": REQUESTS, "decode_steps": STEPS,
                             "prompt_tokens": PROMPT}, **kw)


def test_served_tokens_are_correct_and_the_control_is_not():
    out = run(control=True)
    gap = out["checks"]["max_logit_gap"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0, out["checks"]
    assert gap["value"] <= gap["limit"] < out["readings"]["max_control_gap"], out["readings"]
    spec = cell.spec(ROOT)
    assert set(out["metrics"]) == {m["name"] for m in spec["end_to_end"]
                                   if CELL in m.get("workloads", [CELL])}


@pytest.mark.parametrize("fault", faults.NAMES)
def test_a_fault_fails(fault, monkeypatch):
    for obj, attr, new in faults.patches(fault):
        monkeypatch.setattr(obj, attr, new)
    out = run()
    assert not out["correct"], out["checks"]


def test_counts_by_hand():
    conf = json.loads((ROOT / "port_bench" / "configs" / "dsv2-lite.json").read_text())
    cfg = conf["models"][0]["port"]
    S, L, H = 16384, 27, 16
    pairs = S * (S + 1) // 2
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert mc.attn_params(cfg) == attn
    experts = 3 * 2048 * 1408 * (6 + 2) + 2048 * 64
    want = 2 * S * (L * attn + 3 * 2048 * 10944 + 26 * experts) + 640 * H * pairs * L + 2 * 2048 * 102400
    assert mc.prefill_flops(cfg, S) == want
    assert mc.table_width(16448) == 2048 and mc.table_width(1024) == 64
    # one latent-mode call: 16 queries of 576 and outputs of 512, the rows once, the table
    assert mc.k1_bytes(cfg, 16448, 2048) == 16 * 576 * 2 + 16448 * 1152 + 2048 * 4 + 4 + 16 * 512 * 2
    rows = 576 * 2 * (16416 + 1) * L
    assert mc.decode_bytes(cfg, 16416) - mc.decode_bytes(cfg, 0) == rows - 576 * 2 * L


def test_the_published_config_stands_at_the_top_of_the_file():
    """The file holds the published config.json at its top level, key for
    key, as the model entry's `config` that the run reads does: the two may
    not drift apart."""
    conf = json.loads((ROOT / "port_bench" / "configs" / "dsv2-lite.json").read_text())
    (model,) = conf["models"]
    assert model["reduced"] == {}
    assert {k: conf[k] for k in model["config"]} == model["config"]
