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


TINY = dict(num_layers=2, d_model=128, d_ff=256, vocab_size=512, num_heads=4,
            num_kv_heads=2, head_dim=32)
TINY_DEEPSEEK = dict(num_layers=4, d_model=256, d_ff=512, vocab_size=1024, num_heads=8,
                     num_kv_heads=8, head_dim=32)


def tiny_models(cs):
    """llama3.2-1b and deepseek-7b shrunk so the deepseek stand-in is ~9x
    the llama one, as at full width (5.6x); weights drawn as on the card."""
    from repro_torch.configs import get_config

    cfgs = {"llama3.2-1b": dataclasses.replace(get_config("llama3.2-1b"), **TINY),
            "deepseek-7b": dataclasses.replace(get_config("deepseek-7b"), **TINY_DEEPSEEK)}
    return cfgs, {m: cs.draw_weights(c, i, "cpu") for i, (m, c) in enumerate(cfgs.items())}


def count_plain_calls(monkeypatch):
    """On the CPU the wrappers run their plain versions and count nothing;
    make each call count as a launch, so the counters' bookkeeping runs."""
    from repro_torch.kernels import ops

    for name, fn in ops.KERNELS.items():
        def counted(*a, _fn=fn, **k):
            _fn.launches += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)


def test_serverless_phase_rehearses_on_cpu(monkeypatch):
    """The [serverless] phase's trace, pool rule and checks on the CPU: warm,
    full h2d and partial-reuse cold starts, every load's bytes, the first
    requests against the plain attention, the crash's memory check, and each
    model's launches as its instances counted them."""
    from collections import Counter

    from repro_torch.core.trace import SimModel
    from repro_torch.serverless import poisson_trace

    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "SERVERLESS_PROMPT", 40)
    monkeypatch.setattr(cs, "SERVERLESS_GEN", 4)
    count_plain_calls(monkeypatch)
    cfgs, weights = tiny_models(cs)
    per_model = cs.serverless_phase(cfgs, weights, "cpu")
    trace = poisson_trace(models=[SimModel(m, 1e6, 1) for m in cfgs], **cs.SERVERLESS_TRACE)
    n = Counter(r.model_id for r in trace)
    assert per_model == {m: {"paged_attention": c.num_layers * 4 * n[m],
                             "flash_attention": c.num_layers * n[m]}
                         for m, c in cfgs.items()}


def test_fleet_phase_rehearses_on_cpu(monkeypatch):
    """The [fleet] phase on the CPU: the chaos trace over two engines, the
    crash and recovery, store-tier and prefetched loads on bounded host
    tiers, then the recovered engine's Gateway replay."""
    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "SERVERLESS_PROMPT", 40)
    monkeypatch.setattr(cs, "SERVERLESS_GEN", 4)
    monkeypatch.setattr(cs, "FLEET_HOST_CACHE", 64 << 10)
    cfgs, weights = tiny_models(cs)
    summary = cs.fleet_phase(cfgs, weights, "cpu")
    assert summary["engine_crashes"] == 1 and summary["dropped_requests"] == 0
