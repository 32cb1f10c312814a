"""The plain reference (`reference/lm.py`) against the program's CPU
`Engine`, at the program's smoke size in float32: a dense model, one with
q/k/v biases, and a MoE model whose prompt overflows an expert, so that the
capacity rule drops pairs.  Prefill through the engine's paged path and its
decode steps must give the reference's logits at every served position."""
import dataclasses
import json
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.engine import Engine

from pbench import cell
from pbench.weights import draw
from reference import lm as ref

HERE = Path(__file__).resolve().parent
CONFS = {f: json.loads((HERE / "configs" / f"{f}.json").read_text())
         for f in ("dense-trio", "moe-duo")}
MODELS = {m["id"]: m["port"] for c in CONFS.values() for m in c["models"]}
# each model's weights drawn as its configuration draws them
QK_GAIN = {m["id"]: c.get("draw", {}).get("qk_gain", 1.0)
           for c in CONFS.values() for m in c["models"]}
PROMPT, STEPS = 64, 6


def smoke(model_id: str) -> ModelConfig:
    cfg = ModelConfig(**MODELS[model_id]).smoke()
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


def reference(cfg, flat, prompt, toks):
    seq = prompt[0].tolist() + toks[:-1]
    rows = list(range(PROMPT - 1, PROMPT + STEPS))
    return ref.forward(flat, cell._port_dict(cfg), [(seq, PROMPT, rows)], device="cpu")["fp32"][0]


@pytest.mark.parametrize("model_id", ["deepseek-7b", "codeqwen1.5-7b", "qwen3-moe-30b-a3b"])
def test_reference_gives_the_engines_logits(model_id):
    cfg = smoke(model_id)
    tree, flat = draw(cfg, 2**33 + 17, "cpu", qk_gain=QK_GAIN[model_id])
    if cfg.is_moe:
        # two experts take most tokens: the prompt overflows their capacity
        flat["segments/0/0/mlp/router"][..., :2] *= 6.0
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                           generator=torch.Generator().manual_seed(5), dtype=torch.int32)
    got, toks = served(cfg, tree, prompt)
    want = reference(cfg, flat, prompt, toks)
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= 1e-4 * float(scale), model_id
    if cfg.qkv_bias:
        no_bias = {k: (torch.zeros_like(v) if k.endswith(("bq", "bk", "bv")) else v)
                   for k, v in flat.items()}
        assert float((reference(cfg, no_bias, prompt, toks) - got).abs().max()) > 1e-2 * float(scale)


def test_the_capacity_rule_drops_what_the_engine_drops(monkeypatch):
    """Without the rule (no expert ever full) the reference leaves the
    engine's logits: the prompt did overflow, and the reference drops the
    same pairs."""
    cfg = smoke("qwen3-moe-30b-a3b")
    tree, flat = draw(cfg, 2**33 + 17, "cpu")
    flat["segments/0/0/mlp/router"][..., :2] *= 6.0
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT),
                           generator=torch.Generator().manual_seed(5), dtype=torch.int32)
    got, toks = served(cfg, tree, prompt)
    monkeypatch.setattr(ref, "PROMPT_CAPACITY", 100.0)
    dropless = reference(cfg, flat, prompt, toks)
    assert float((dropless - got).abs().max()) > 1e-2 * float(dropless.abs().max())


def test_fp8_rounding():
    x = torch.linspace(-3, 3, 101)
    y = ref._fp8(x)
    assert float((y - x).abs().max()) <= 3 / 448 * 32  # e4m3: 3 mantissa bits
    assert float((y - x).abs().max()) > 0
    assert ref.capacity(64, 2, 8, 1.25) == 24 and ref.capacity(1, 8, 128, 4.0) == 8
