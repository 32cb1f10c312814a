"""The ported examples (`repro_torch.examples`) on the CPU against the
reference's `examples/`, each run as a subprocess (the reference's with
JAX on the CPU) while the port's runs in-process:

- quickstart: every printed line but the generated tokens (the weights
  differ) equals the reference's: the three loads' byte ledgers, the pool
  layout, and a warm reload that moves 0 bytes;
- serve_engine: the block tables and KV-pool lines equal the reference's,
  and the paged decode agrees with the dense path;
- serve_cluster: the policy table (the cost plane) equals the reference's
  number for number at 40 requests;
- train_100m: a few steps, a crash and a restore; a run that crashes at
  step 3 and one that crashes at step 5 print the same loss at step 5, so
  the restored run continues the saved one exactly.
"""
import contextlib
import io
import subprocess
import sys

import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from dist_helpers import ENV, ROOT  # noqa: E402


def _reference(name: str, *args: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**ENV, "JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's examples, started together (serve_engine runs the
    Pallas kernel in interpret mode: about a minute)."""
    procs = {"quickstart": _reference("quickstart"), "serve_engine": _reference("serve_engine"),
             "serve_cluster": _reference("serve_cluster", "--requests", "40")}
    out = {}
    for name, proc in procs.items():
        text, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        out[name] = text.splitlines()
    return out


def _port(module, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = module.main(list(args))
    return result, buf.getvalue().splitlines()


def test_quickstart_ledgers_equal_reference(reference_runs):
    from repro_torch.examples import quickstart

    (cold, _, warm), lines = _port(quickstart, "--device", "cpu")
    keep = lambda ls: [line for line in ls if "generated tokens" not in line]  # noqa: E731
    assert keep(lines) == keep(reference_runs["quickstart"])
    assert cold.bytes_transferred > 0
    assert warm.bytes_transferred == 0 and warm.reuse_fraction == 1.0


def test_serve_engine_block_tables_equal_reference(reference_runs):
    from repro_torch.examples import serve_engine

    (tables, worst), lines = _port(serve_engine, "--device", "cpu")
    assert tables == {f"seq{i}": 3 for i in range(4)}
    assert worst <= serve_engine.TOL
    assert [line for line in lines if not line.startswith("paged vs dense")] \
        == reference_runs["serve_engine"]


def test_serve_cluster_policy_table_equals_reference(reference_runs):
    from repro_torch.examples import serve_cluster

    rows, lines = _port(serve_cluster, "--requests", "40", "--device", "cpu")
    assert lines == reference_runs["serve_cluster"]
    assert list(rows) == ["sllm", "sllm-c", "sllm-cm", "tangram", "tangram-conc"]


def test_train_100m_restores_and_continues(tmp_path):
    from repro_torch.examples import train_100m

    runs = {}
    for crash in (3, 5):
        runs[crash], lines = _port(train_100m, "--device", "cpu", "--steps", "6",
                                   "--crash-at", str(crash), "--ckpt-dir",
                                   str(tmp_path / f"crash{crash}"))
        assert f"restored step {crash}" in lines
    assert runs[3][-1][:2] == runs[5][-1][:2] == ("run2", 5)
    assert runs[3][-1][2] == runs[5][-1][2]  # the restored state is the saved one
    assert runs[3][0][2] > runs[3][-1][2]  # and training went on from it
