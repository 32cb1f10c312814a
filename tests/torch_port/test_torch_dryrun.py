"""`python -m repro_torch.launch.dryrun` on a cell of the production mesh
(llama3.2-1b decode_32k, 256 ranks of a fake process group), run as its own
process with JAX and the reference package blocked: its row carries the
reference's keys, and `roofline.report` (a copy of the reference's)
renders it."""
import json
import os
import tempfile

import pytest

pytest.importorskip("jax")

from repro.roofline.analysis import Roofline as RefRoofline  # noqa: E402

from dist_helpers import run_snippet  # noqa: E402

# the keys `run_cell` and `main` add to the roofline row
# (src/repro/launch/dryrun.py:85-92, :147-149)
REF_EXTRA = ("ok", "lower_s", "compile_s", "xla_flops_per_chip_unrolled_once",
             "hlo_bytes_total_note", "step_desc", "variant", "step_kwargs")
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}

RUN = """
import runpy, sys
for name in ("jax", "jaxlib", "ml_dtypes", "repro"):
    sys.modules[name] = None
sys.argv = ["dryrun", "--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "single",
            "--out", {out!r}]
runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
"""


@pytest.fixture(scope="module")
def results():
    out = os.path.join(tempfile.mkdtemp(prefix="torch_dryrun_"), "dryrun_results_torch.json")
    proc = run_snippet(RUN.format(out=out), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "1 cells ok, 0 failures" in proc.stdout, proc.stdout[-2000:]
    with open(out) as f:
        return json.load(f)


def test_row_has_the_reference_keys(results):
    row = results["llama3.2-1b|decode_32k|single"]
    ref_row = RefRoofline("a", "s", "m", 1, 1.0, 1.0, 1.0, {}, 1.0, 1, {}).row()
    assert set(ref_row) | set(REF_EXTRA) <= set(row)
    assert set(row["memory_analysis"]) == MEMORY_KEYS
    assert row["ok"] and row["chips"] == 256 and row["trace_s"] > 0
    assert row["hlo_flops_per_chip"] > 0 and row["collective_bytes_per_chip"] > 0
    assert row["memory_analysis"]["argument_bytes"] > 0
    skips = [k for k, v in results.items() if v.get("skipped")]
    assert "llama3.2-1b|long_500k|skip" in skips


def test_report_renders_the_row(results):
    from repro_torch.roofline import report

    table = report.single_pod_table(results)
    assert "| llama3.2-1b | decode_32k | **" in table
    assert "llama3.2-1b" in report.skipped_table(results)
