"""chip_smoke.py, the script that runs the port on the H100, where there is
no card: it refuses
to run (non-zero exit, no result line), and its main path runs end to end
on the CPU at a reduced size through the same code."""
import dataclasses
import functools
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[2]


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_script(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = run_script(ROOT)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = run_script(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_main_path_rehearses_on_cpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.serving import engine

    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "PROMPT_LENS", (40, 30, 17, 5))
    monkeypatch.setattr(cs, "DECODE_STEPS", 4)
    monkeypatch.setattr(cs, "COMPARE_STEPS", 3)
    # small chunks, so the tiny model's cold load is chunked as at full width
    monkeypatch.setattr(engine, "Engine", functools.partial(engine.Engine,
                                                            chunk_bytes=256 << 10))
    cfg = dataclasses.replace(get_config("llama3.2-1b"), name="tiny-llama",
                              num_layers=2, d_model=128, d_ff=256, vocab_size=512)
    counts = cs.main_path(cfg, "cpu")
    assert counts == {"paged_attention": 0, "flash_attention": 0}  # CPU: plain versions
