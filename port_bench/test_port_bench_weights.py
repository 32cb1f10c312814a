"""The bounds of the weights' draw: without a configuration's
``draw.fan_in`` and ``draw.norms`` every leaf of every benchmark model is
drawn by the llama-style rule the benchmark has always drawn by, so its
weights stay bit-identical at every seed; with them, the configuration's
widths and norm scales hold."""
import dataclasses
import json
import math
from pathlib import Path

import pytest

from repro_torch.configs.base import ModelConfig
from repro_torch.models import build_model
from repro_torch.models.tensors import flatten_params

from pbench import weights

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFS = {c["name"]: json.loads((ROOT / c["file"]).read_text()) for c in SPEC["configs"]}
ENTRIES = {(c, m["id"]): m for c, conf in CONFS.items() for m in conf["models"]}


def llama_rule(name, shape, cfg, qk_gain):
    """The rule as the benchmark first drew by it, frozen here."""
    base = name.rsplit("/", 1)[-1]
    if base in ("ln1", "ln2", "final_norm"):
        return 0.1
    if base in ("bq", "bk", "bv"):
        return 0.5
    gain = qk_gain if base in ("wq", "wk") else 1.0
    if base == "wo":
        fan = cfg.num_heads * cfg.resolved_head_dim
    elif base == "wd":
        fan = shape[-2]
    else:
        fan = cfg.d_model
    return gain / math.sqrt(fan)


def leaves(cfg):
    return [(n, tuple(s.shape)) for n, s in flatten_params(build_model(cfg).param_specs())]


@pytest.mark.parametrize("conf,model_id", list(ENTRIES), ids=[f"{c}:{m}" for c, m in ENTRIES])
def test_without_fan_ins_every_leaf_keeps_the_llama_rule(conf, model_id):
    """Every leaf that the configuration's ``draw.fan_in`` and ``draw.norms``
    leave out (in dense-trio and moe-duo: every leaf)."""
    rule = CONFS[conf].get("draw") or {}
    named = set(rule.get("fan_in", {})) | set(rule.get("norms", ()))
    cfg = ModelConfig(**ENTRIES[conf, model_id]["port"])
    checked = 0
    for name, shape in leaves(cfg):
        if name.rsplit("/", 1)[-1] not in named:
            want = llama_rule(name, shape, cfg, rule.get("qk_gain", 1.0))
            assert weights.leaf_bound(name, shape, cfg, rule) == want, name
            checked += 1
    assert checked >= 8


def test_a_configurations_fan_ins_and_norms_hold():
    cfg = ModelConfig(**ENTRIES["moe-duo", "qwen3-moe-30b-a3b"]["port"])
    rule = {"qk_gain": 2.0, "norms": ["kv_norm"],
            "fan_in": {"wo": 512, "wd": "moe_d_ff", "wkv_b": ["num_kv_heads", "head_dim"]}}
    shape = (12, 4, 128, 2048)
    assert weights.leaf_bound("segments/0/0/attn/wo", shape, cfg, rule) == 1 / math.sqrt(512)
    assert weights.leaf_bound("segments/0/0/mlp/wd", shape, cfg, rule) == 1 / math.sqrt(768)
    assert weights.leaf_bound("segments/0/0/attn/wkv_b", shape, cfg, rule) == 1 / math.sqrt(4 * 128)
    assert weights.leaf_bound("segments/0/0/attn/kv_norm", shape, cfg, rule) == weights.NORM_BOUND
    assert weights.leaf_bound("segments/0/0/ln1", shape, cfg, rule) == weights.NORM_BOUND
    # a leaf the map leaves out keeps the rule, the gain with it
    assert weights.leaf_bound("segments/0/0/attn/wq", shape, cfg, rule) == 2.0 / math.sqrt(2048)
    # a field follows the configuration as run (the tests' smoke size)
    small = dataclasses.replace(cfg, moe_d_ff=64)
    assert weights.leaf_bound("segments/0/0/mlp/wd", shape, small, rule) == 1 / 8
