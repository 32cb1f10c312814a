"""Each model's plain reference (the module its configuration entry names,
`reference/lm.py` by default) against the program's CPU `Engine`, at the
program's smoke size in float32, for every model of every configuration in
BENCHMARK.json, its weights drawn as its configuration draws them: dense
models, one with q/k/v biases, and a MoE model whose prompt overflows an
expert, so that the capacity rule drops pairs.  Prefill through the
engine's paged path and its decode steps must give the reference's logits
at every served position.  Then the path from a configuration's
``reference`` key to the check: a module it names is the one `check.gaps`
compares through, and a module that is not there stops a run at set-up."""
import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.engine import Engine

import reference
from pbench import cell
from pbench.weights import draw
from reference import lm as ref

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFS = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in SPEC["configs"]}
ENTRIES = {(c, m["id"]): m for c, conf in CONFS.items() for m in conf["models"]}
PROMPT, STEPS = 64, 6


def smoke(conf: str, model_id: str) -> ModelConfig:
    cfg = ModelConfig(**ENTRIES[conf, model_id]["port"]).smoke()
    return dataclasses.replace(cfg, dtype="float32")


def served(cfg, tree, prompt):
    """(logits at each served position, served tokens) through the engine."""
    eng = Engine(1 << 30, device="cpu")
    eng.register(cfg.name, cfg, init_fn=lambda: tree)
    eng.load(cfg.name)
    inst = eng.start_instance(cfg.name)
    logits = [inst.prefill({"tokens": prompt})[0]]
    toks = [int(logits[-1].argmax())]
    for _ in range(STEPS):
        logits.append(inst.decode(torch.tensor([toks[-1]], dtype=torch.int32))[0])
        toks.append(int(logits[-1].argmax()))
    inst.finish()
    eng.close()
    return torch.stack(logits), toks


def reference_logits(cfg, flat, prompt, toks, module=ref):
    seq = prompt[0].tolist() + toks[:-1]
    rows = list(range(PROMPT - 1, PROMPT + STEPS))
    return module.forward(flat, cell._port_dict(cfg), [(seq, PROMPT, rows)],
                          device="cpu")["fp32"][0]


@pytest.mark.parametrize("conf,model_id", list(ENTRIES), ids=[f"{c}:{m}" for c, m in ENTRIES])
def test_reference_gives_the_engines_logits(conf, model_id):
    cfg = smoke(conf, model_id)
    module = reference.load(reference.module_of(ENTRIES[conf, model_id]))
    tree, flat = draw(cfg, 2**33 + 17, "cpu", CONFS[conf].get("draw"))
    # two experts take most tokens: the prompt overflows their capacity
    for name in [n for n in flat if n.rsplit("/", 1)[-1] == "router"]:
        flat[name][..., :2] *= 6.0
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                           generator=torch.Generator().manual_seed(5), dtype=torch.int32)
    got, toks = served(cfg, tree, prompt)
    want = reference_logits(cfg, flat, prompt, toks, module)
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= 1e-4 * float(scale), model_id
    if cfg.qkv_bias:
        no_bias = {k: (torch.zeros_like(v) if k.endswith(("bq", "bk", "bv")) else v)
                   for k, v in flat.items()}
        assert (float((reference_logits(cfg, no_bias, prompt, toks, module) - got).abs().max())
                > 1e-2 * float(scale))


def test_the_capacity_rule_drops_what_the_engine_drops(monkeypatch):
    """Without the rule (no expert ever full) the reference leaves the
    engine's logits: the prompt did overflow, and the reference drops the
    same pairs."""
    cfg = smoke("moe-duo", "qwen3-moe-30b-a3b")
    tree, flat = draw(cfg, 2**33 + 17, "cpu")
    flat["segments/0/0/mlp/router"][..., :2] *= 6.0
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                           generator=torch.Generator().manual_seed(5), dtype=torch.int32)
    got, toks = served(cfg, tree, prompt)
    monkeypatch.setattr(ref, "PROMPT_CAPACITY", 100.0)
    dropless = reference_logits(cfg, flat, prompt, toks)
    assert float((dropless - got).abs().max()) > 1e-2 * float(dropless.abs().max())


def test_fp8_rounding():
    x = torch.linspace(-3, 3, 101)
    y = ref._fp8(x)
    assert float((y - x).abs().max()) <= 3 / 448 * 32  # e4m3: 3 mantissa bits
    assert float((y - x).abs().max()) > 0
    assert ref.capacity(64, 2, 8, 1.25) == 24 and ref.capacity(1, 8, 128, 4.0) == 8


# Reference modules a test configuration names: one hands on lm's logits and
# records the models it computed, one hands on their negation.
MODULES = {
    "bench_test_echo": "lm.forward(weights, cfg, seqs, device=device, precisions=precisions)",
    "bench_test_negated": "{p: [-x for x in xs] for p, xs in lm.forward(weights, cfg, seqs, "
                          "device=device, precisions=precisions).items()}",
}


@pytest.fixture
def checkout(tmp_path, monkeypatch):
    """make(module): a root whose BENCHMARK.json points `moe-duo` at a copy
    of its configuration file in tmp_path in which every model names the
    reference `module`, found among the modules this test writes."""
    refs = tmp_path / "references"
    refs.mkdir()
    for name, body in MODULES.items():
        (refs / f"{name}.py").write_text(
            f"from reference import lm\n\nCALLS = []\n\n\n"
            f"def forward(weights, cfg, seqs, *, device, precisions=('fp32',)):\n"
            f"    CALLS.append(cfg['name'])\n    return {body}\n")
    monkeypatch.setattr(reference, "__path__", [str(refs), *reference.__path__])

    def make(module):
        conf = json.loads((HERE / "configs" / "moe-duo.json").read_text())
        for m in conf["models"]:
            m["reference"] = module
        (tmp_path / "moe-duo.json").write_text(json.dumps(conf))
        spec = dict(SPEC, configs=[dict(c, file="moe-duo.json") if c["name"] == "moe-duo" else c
                                   for c in SPEC["configs"]])
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
        return tmp_path

    yield make
    for name in MODULES:
        sys.modules.pop(f"reference.{name}", None)


def run_chat(root):
    requests, steps = 4, 8
    limits = {"max_logit_gap": 1e-3, "min_tokens_compared": requests * (steps + 1)}
    return cell.run(root, "moe-duo.chat", 2**31 + 303, 0.0, False, t_start=time.perf_counter(),
                    device="cpu", shrink=lambda c: dataclasses.replace(c.smoke(), dtype="float32"),
                    log=lambda m: None,
                    traffic={"limits": limits, "check_requests": requests,
                             "slice_requests": requests, "decode_steps": steps})


@pytest.mark.parametrize("module,correct", [("bench_test_echo", True),
                                            ("bench_test_negated", False)])
def test_the_check_compares_through_the_named_reference(checkout, module, correct):
    out = run_chat(checkout(module))
    calls = sys.modules[f"reference.{module}"].CALLS
    assert calls and set(calls) <= {m for c, m in ENTRIES if c == "moe-duo"}
    assert out["correct"] is correct, out["checks"]


def test_a_missing_reference_stops_the_run_before_weights_are_drawn(checkout, monkeypatch):
    def drawn(*a, **k):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(cell, "draw", drawn)
    with pytest.raises(SystemExit, match=r"qwen3-moe-30b-a3b.*bench_test_absent\.py"):
        run_chat(checkout("bench_test_absent"))
