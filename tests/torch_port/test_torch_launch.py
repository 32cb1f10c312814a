"""The port's serving launcher against the reference's, as subprocesses on
the CPU (the port with ``--device cpu``): the same command line prints the
same lines once the wall-clock fields are taken out — the round-robin and
the ``--trace poisson --keep-alive-policy adaptive`` runs of
tests/test_launchers.py, and the fleet replay under ``--chaos``.

What stays is what the control plane decided: per request the model, the
engine, cold or warm, the reuse fraction and bytes moved, the pool's free
bytes; the summary's counts and cold rate; the fault ledgers.  Walls (and
the TTFT breakdown's shares, which are ratios of walls) are removed.  The
fleet run's mean inter-arrival (200 s) keeps every gap far above any
service wall, so its routing depends on the trace clock alone.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[2]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")

RUNS = {
    "round_robin": ["--models", "llama3.2-1b", "--requests", "2",
                    "--prompt-len", "16", "--gen-tokens", "4"],
    "trace_adaptive": ["--models", "llama3.2-1b", "--trace", "poisson",
                       "--requests", "3", "--keep-alive-policy", "adaptive",
                       "--mean-interarrival", "5", "--prompt-len", "16",
                       "--gen-tokens", "2"],
    "fleet_chaos": ["--models", "llama3.2-1b", "--trace", "poisson",
                    "--requests", "4", "--n-engines", "2", "--chaos",
                    "--mean-interarrival", "200", "--prompt-len", "16",
                    "--gen-tokens", "2"],
}

WALL = re.compile(r" *\d+(\.\d+)?(ms/tok|ms|s)\b")


def decided(stdout: str) -> list[str]:
    """The output's lines with every wall-clock field removed."""
    lines = []
    for line in stdout.splitlines():
        if line.startswith("  "):  # TTFT breakdown row: phase name only
            line = line.split()[0]
        lines.append(WALL.sub(" <wall>", line))
    return lines


@pytest.mark.parametrize("run", sorted(RUNS))
def test_launcher_prints_what_the_reference_prints(run):
    procs = [subprocess.Popen([sys.executable, "-m", f"{pkg}.launch.serve", *RUNS[run], *extra],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=ENV)
             for pkg, extra in (("repro", []), ("repro_torch", ["--device", "cpu"]))]
    (ref_out, ref_err), (port_out, port_err) = (p.communicate(timeout=600) for p in procs)
    assert procs[0].returncode == 0, ref_err[-1500:]
    assert procs[1].returncode == 0, port_err[-1500:]
    assert decided(port_out) == decided(ref_out)
    assert len(decided(ref_out)) >= 2
