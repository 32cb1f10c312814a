"""chip_smoke.py, the script that runs the port on the H100, where there is
no card: it refuses
to run (non-zero exit, no result line), and its main path runs end to end
on the CPU at a reduced size through the same code."""
import dataclasses
import functools
import importlib.util
import inspect
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
    assert counts == {"paged_attention": 0, "flash_attention": 0,  # CPU: plain versions
                      "moe_experts": 0, "rope_kv_write": 0, "add_rms_norm": 0}


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
                             "flash_attention": c.num_layers * n[m], "moe_experts": 0,
                             "rope_kv_write": c.num_layers * 4 * n[m],
                             "add_rms_norm": (2 * c.num_layers + 1) * 4 * n[m]}
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


def test_gateway_phases_rehearse_graphed_on_cpu(monkeypatch, capsys):
    """[serverless] and [fleet] with the engines' decode steps captured
    through the CPU double of a CUDA graph and kept across requests: every
    request whose model's tree and slab are unchanged since its previous
    request replays from its first step (0 eager steps, 0 captures), each
    model's first such request equals the eager step's rerun, and the
    counts and holds are as eager."""
    import re

    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "SERVERLESS_PROMPT", 40)
    monkeypatch.setattr(cs, "SERVERLESS_GEN", 4)
    monkeypatch.setattr(cs, "FLEET_HOST_CACHE", 64 << 10)
    count_plain_calls(monkeypatch)
    made = capture_through_double(monkeypatch)
    cfgs, weights = tiny_models(cs)
    cs.serverless_phase(cfgs, weights, "cpu")
    out = capsys.readouterr().out
    live = re.search(r"\[serverless\] requests on a live key .*: \[(.*)\] of 10", out)
    assert live and live.group(1), out  # the roomy trace has warm and full-hit requests
    assert "each model's first live-key request against the eager step" in out
    assert out.count("(key live)") == len(live.group(1).split(","))
    summary = cs.fleet_phase(cfgs, weights, "cpu")
    assert summary["engine_crashes"] == 1 and summary["dropped_requests"] == 0
    assert "[fleet] requests on a live key" in capsys.readouterr().out
    assert made and all(g.replays > 0 and not g.live() for g in made)


TINY_MOE = dict(num_layers=2, d_model=128, moe_d_ff=64, vocab_size=512, num_heads=8,
                num_kv_heads=1, head_dim=32, num_experts=16, experts_per_token=4)
TINY_VLM = dict(num_layers=3, d_model=96, d_ff=192, vocab_size=512, num_heads=7,
                num_kv_heads=1, head_dim=32, vision_stub_patches=8,
                mrope_sections=(8, 4, 4))


def test_families_phase_rehearses_on_cpu(monkeypatch):
    """The [families] phase on the CPU: a MoE and a VLM model of about the
    full-width size ratio through the Gateway, the seeded trace's warm, full
    h2d and partial-reuse starts, every load's bytes, the first requests
    against the plain attention (the MoE one with its kernel path's expert
    choices) and each model's launches."""
    from collections import Counter

    from repro_torch.configs import get_config
    from repro_torch.core.trace import SimModel
    from repro_torch.serverless import poisson_trace

    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "FAMILY_PROMPT", 24)
    monkeypatch.setattr(cs, "SERVERLESS_GEN", 4)
    count_plain_calls(monkeypatch)
    cfgs = {"qwen3-moe-30b-a3b": dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                                                     **TINY_MOE),
            "qwen2-vl-7b": dataclasses.replace(get_config("qwen2-vl-7b"), **TINY_VLM)}
    weights = {m: cs.draw_weights(c, i, "cpu") for i, (m, c) in enumerate(cfgs.items())}
    per_model = cs.families_phase(cfgs, weights, "cpu")
    trace = poisson_trace(models=[SimModel(m, 1e6, 1) for m in cfgs], **cs.FAMILY_TRACE)
    n = Counter(r.model_id for r in trace)
    # the MoE model's B 1 decode steps take the routed experts (k 4 < 16 experts)
    assert per_model == {m: {"paged_attention": c.num_layers * 4 * n[m],
                             "flash_attention": c.num_layers * n[m],
                             "moe_experts": c.num_layers * 4 * n[m] * c.is_moe,
                             "rope_kv_write": c.num_layers * 4 * n[m],
                             "add_rms_norm": (2 * c.num_layers + 1) * 4 * n[m]}
                         for m, c in cfgs.items()}


def test_dedup_and_migration_phases_rehearse_on_cpu(monkeypatch):
    """[dedup] and [migration] on the CPU over the deepseek-7b stand-in:
    delta-only variant loads whose shared leaves are the base's tensors, the
    small pool's evictions, and a bit-identical migrated replay."""
    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "SERVERLESS_PROMPT", 40)
    monkeypatch.setattr(cs, "KV_ROOM", 3 << 19)  # one KV region of the stand-in
    _, weights = tiny_models(cs)
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("deepseek-7b"), **TINY_DEEPSEEK)
    out = cs.dedup_phase(cfg, weights["deepseek-7b"], "cpu")
    assert out["delta_bytes"] == 2 * 4 * 256 * 256 * 2  # stacked wq and wo, bf16
    mig = cs.migration_phase(cfg, weights["deepseek-7b"], "cpu")
    assert mig["bytes"] == 2 * 4 * 3 * 16 * 8 * 32 * 2  # K + V, 3 pages of 16 tokens


TINY_STATE = {
    "mixtral-8x7b": dict(num_layers=6, d_model=128, d_ff=256, moe_d_ff=256, vocab_size=512,
                         num_heads=4, num_kv_heads=2, head_dim=32, sliding_window=64),
    "recurrentgemma-9b": dict(num_layers=8, d_model=128, lru_width=128, d_ff=256,
                              vocab_size=1024, num_heads=4, num_kv_heads=1, head_dim=32,
                              sliding_window=64,
                              layer_pattern=("rglru", "rglru", "swa") * 2 + ("rglru", "rglru")),
    "mamba2-2.7b": dict(num_layers=4, d_model=96, vocab_size=512, ssm_state=16,
                        ssm_head_dim=16, ssm_chunk=32),
    "whisper-tiny": dict(num_layers=2, encoder_layers=2, d_model=32, num_heads=2,
                         num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64, encoder_seq=32),
}


def test_state_families_phase_rehearses_on_cpu(monkeypatch):
    """The [state-families] phase on the CPU: the four non-paged families
    (recurrentgemma-9b in its two-segment pattern) through the Gateway with
    the seeded trace's warm, full h2d and partial-reuse starts and the pool
    rule, every load's bytes, the first requests against the plain
    attention, launches by model (K2 per attention layer, the encoder's
    too; no K1), then the long-prompt probes over window-sized rings and
    the eager-against-graphed check (both eager: a CPU engine never
    captures)."""
    rehearse_state_families(monkeypatch)


def test_state_families_phase_rehearses_graphed_on_cpu(monkeypatch):
    """The same phase with the engines' state steps captured through the
    CPU double of a CUDA graph: the gateway's decode replays, the long
    probes hold their eager pair (`eager_steps`) and then replay, the
    check's graphed engine replays, and every count and hold is as eager."""
    made = capture_through_double(monkeypatch)
    rehearse_state_families(monkeypatch)
    assert made and all(g.replays > 0 and not g.live() for g in made)


def capture_through_double(monkeypatch) -> list:
    """Engines built with ``cuda_graphs=True`` (the default) capture their
    decode steps through `RecordingCapture`, the CPU double of a CUDA
    graph; returns their `StepGraphs`, as the engines are built."""
    from repro_torch.serving import engine
    from repro_torch.serving.step_graph import StepGraphs

    from torch_port_helpers import RecordingCapture

    made = []

    class Graphed(engine.Engine):
        def __init__(self, *a, cuda_graphs=True, **k):
            super().__init__(*a, cuda_graphs=cuda_graphs, **k)
            if cuda_graphs:
                self.step_graphs = StepGraphs(RecordingCapture())
                made.append(self.step_graphs)

    monkeypatch.setattr(engine, "Engine", Graphed)
    return made


def rehearse_state_families(monkeypatch):
    from collections import Counter

    from repro_torch.configs import get_config
    from repro_torch.core.trace import SimModel
    from repro_torch.serverless import poisson_trace

    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "STATE_PROMPT", 24)
    monkeypatch.setattr(cs, "SERVERLESS_GEN", 4)
    monkeypatch.setattr(cs, "STATE_LONG", {"recurrentgemma-9b": 80, "mixtral-8x7b": 100})
    count_plain_calls(monkeypatch)
    cfgs = {m: dataclasses.replace(get_config(m), **TINY_STATE[m]) for m in cs.STATE_MODELS}
    weights = {m: cs.draw_weights(c, i, "cpu") for i, (m, c) in enumerate(cfgs.items())}
    per_model = cs.state_families_phase(cfgs, weights, "cpu")
    trace = poisson_trace(models=[SimModel(m, 1e6, 1) for m in cfgs], **cs.STATE_TRACE)
    n = Counter(r.model_id for r in trace)
    attn = {"mixtral-8x7b": 6, "recurrentgemma-9b": 2, "mamba2-2.7b": 0, "whisper-tiny": 4}
    assert set(n) == set(cfgs)
    # mixtral's B 1 decode steps take the routed experts (k 2 < 8 experts): 4
    # a request, and the long probe's own count
    moe = {m: cfgs[m].num_layers if cfgs[m].is_moe else 0 for m in cfgs}
    probe = inspect.signature(cs.long_prompt_probe).parameters["steps"].default
    assert per_model == {**{m: {"paged_attention": 0, "flash_attention": attn[m] * n[m],
                                "moe_experts": moe[m] * 4 * n[m], "rope_kv_write": 0,
                                "add_rms_norm": 0}
                            for m in cfgs},
                         "recurrentgemma-9b long": {"paged_attention": 0,
                                                    "flash_attention": 2, "moe_experts": 0,
                                                    "rope_kv_write": 0, "add_rms_norm": 0},
                         "mixtral-8x7b long": {"paged_attention": 0, "flash_attention": 6,
                                               "moe_experts": moe["mixtral-8x7b"] * probe,
                                               "rope_kv_write": 0, "add_rms_norm": 0}}


def test_train_phase_rehearses_on_cpu(monkeypatch, tmp_path, capsys):
    """The [train] phase on the CPU at --smoke sizes: llama3.2-1b through the
    launcher, checks (a)-(d) (peak memory and the profile are CUDA-only),
    the checkpoint round trip, the MoE dispatches held against each other,
    the launcher's CLI contract over every architecture, and (e) no kernel
    launched."""
    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "TRAIN_BATCH", 2)
    monkeypatch.setattr(cs, "TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "MOE_TRAIN_SEQ", 32)
    monkeypatch.setattr(cs, "CKPT_DIR", tmp_path / "build" / "train_ckpt")
    cs.train_phase("cpu", smoke=True)
    out = capsys.readouterr().out
    for line in ("(a) first loss", "(b) bf16 vs fp32", "(c) 20 steps on one batch",
                 "(d) remat on vs off", "34 of 34 leaves bitwise equal",
                 "scatter vs gshard", "grouped vs gshard", "resumed from step 6",
                 "(e) kernel launches over the phase: {'paged_attention': 0, "
                 "'flash_attention': 0, 'moe_experts': 0, 'rope_kv_write': 0, "
                 "'add_rms_norm': 0}"):
        assert line in out, line
    assert not (tmp_path / "build" / "train_ckpt").exists()


def test_trace_phase_rehearses_on_cpu(monkeypatch, tmp_path):
    """The [trace] phase on the CPU over the llama3.2-1b stand-in: a cold
    load, a store-tier reload and 3 fused decode steps on a traced engine,
    the span families and their nesting, and a Chrome trace that loads."""
    import json

    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "SERVERLESS_PROMPT", 24)
    monkeypatch.setattr(cs, "TRACE_DIR", tmp_path / "trace")
    cfgs, weights = tiny_models(cs)
    counts = cs.trace_phase(cfgs["llama3.2-1b"], weights["llama3.2-1b"], "cpu")
    assert counts == {"paged_attention": 0, "flash_attention": 0,  # CPU: plain versions
                      "moe_experts": 0, "rope_kv_write": 0, "add_rms_norm": 0}
    doc = json.loads((tmp_path / "trace" / "llama3.2-1b.json").read_text())
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) > 10


@pytest.mark.parametrize("capture", ["off", "double"])
def test_graphs_phase_rehearses_on_cpu(monkeypatch, capture):
    """The [graphs] phase on the CPU over the llama3.2-1b stand-in, both
    engines eager ("off": a CPU engine never captures), or the graphed one
    capturing through the CPU double of a CUDA graph ("double"): every
    step's logits equal, launches equal, the capture before the eviction,
    the drop and the recapture."""
    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "PROMPT_LENS", (40, 30, 17, 5))
    monkeypatch.setattr(cs, "GRAPH_STEPS", 8)
    monkeypatch.setattr(cs, "GRAPH_EVICT_AT", 4)
    count_plain_calls(monkeypatch)
    if capture == "double":
        capture_through_double(monkeypatch)
    cfgs, weights = tiny_models(cs)
    out = cs.graphs_phase(cfgs["llama3.2-1b"], weights["llama3.2-1b"], "cpu")
    L = cfgs["llama3.2-1b"].num_layers
    assert out["eager"]["launches"] == out["graphed"]["launches"] == {
        "paged_attention": L * 2 * 8, "flash_attention": L * 2, "moe_experts": 0,
        "rope_kv_write": L * 2 * 8, "add_rms_norm": (2 * L + 1) * 2 * 8}


def test_examples_phase_rehearses_on_cpu(monkeypatch, tmp_path):
    """The [examples] phase on the CPU: the four ported examples as
    processes of their own, each exiting 0 with its own check's line
    (train_100m and serve_cluster cut short)."""
    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "EXAMPLE_CKPT", tmp_path / "ckpt")
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # four processes at once
    cs.examples_phase("cpu", overrides={"train_100m": ("--steps", "2", "--crash-at", "1",
                                                       "--ckpt-dir", str(tmp_path / "ckpt")),
                                        "serve_cluster": ("--requests", "20")})
    assert not (tmp_path / "ckpt").exists()


def test_dense_phase_rehearses_on_cpu(monkeypatch):
    """The [dense] phase on the CPU over yi-9b and codeqwen1.5-7b stand-ins
    (G 4 and G 1; the larger model ~1.2x the smaller, as at full width
    1.08x): the seeded trace's warm, full h2d and partial-reuse starts,
    every load's bytes, the first requests against the plain attention and
    each model's launches."""
    from collections import Counter

    from repro_torch.configs import get_config
    from repro_torch.core.trace import SimModel
    from repro_torch.serverless import poisson_trace

    cs = load_chip_smoke()
    monkeypatch.setattr(cs, "SERVERLESS_PROMPT", 40)
    monkeypatch.setattr(cs, "SERVERLESS_GEN", 4)
    count_plain_calls(monkeypatch)
    cfgs = {m: dataclasses.replace(get_config(m), **TINY_DENSE[m]) for m in cs.DENSE_MODELS}
    weights = {m: cs.draw_weights(c, i, "cpu") for i, (m, c) in enumerate(cfgs.items())}
    per_model = cs.dense_phase(cfgs, weights, "cpu")
    trace = poisson_trace(models=[SimModel(m, 1e6, 1) for m in cfgs], **cs.SERVERLESS_TRACE)
    n = Counter(r.model_id for r in trace)
    assert per_model == {m: {"paged_attention": c.num_layers * 4 * n[m],
                             "flash_attention": c.num_layers * n[m], "moe_experts": 0,
                             "rope_kv_write": c.num_layers * 4 * n[m],
                             "add_rms_norm": (2 * c.num_layers + 1) * 4 * n[m]}
                         for m, c in cfgs.items()}


TINY_DENSE = {"yi-9b": dict(num_layers=6, d_model=128, d_ff=384, vocab_size=512, num_heads=4,
                            num_kv_heads=1, head_dim=32),
              "codeqwen1.5-7b": dict(num_layers=4, d_model=128, d_ff=384, vocab_size=720,
                                     num_heads=4, num_kv_heads=4, head_dim=32)}


def test_distributed_phase_rehearses_on_cpu():
    """The [distributed] phase on the CPU at smoke sizes, in a process of its
    own (its one-rank gloo group must not outlive it): the three steps on a
    1x1 mesh against the undistributed path (the serve step through the
    flash-decode combine), an elastic checkpoint round trip, compressed
    gradients, and the dry-run subprocess on one cell (no kernel launches
    on the CPU)."""
    from dist_helpers import run_snippet

    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import chip_smoke\n"
            "print('RESULT', chip_smoke.distributed_phase('cpu', smoke=True))\n")
    out = run_snippet(code, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    for line in ("make_train_step's gradients vs launch.train's", "train step 2:",
                 "bitwise equal True", "prefill step:", "serve step 1", "compressed_grad_fn",
                 "elastic checkpoint of",
                 "dryrun llama3.2-1b|decode_32k|single: bottleneck",
                 "kernel launches over the phase: {'paged_attention': 0, 'flash_attention': 0, "
                 "'moe_experts': 0, 'rope_kv_write': 0, 'add_rms_norm': 0}"):
        assert line in out.stdout, line
