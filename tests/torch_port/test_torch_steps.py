"""The distributed steps (`repro_torch.distributed.steps`) on gloo CPU
ranks against the reference's steps on its fake-device meshes, smoke
configs in fp32, parameters crossing by leaf name, inputs from numpy.

Cases (4 ranks each):
- llama3.2-1b on a 2x2 (data, model) mesh: one train step (loss, and the
  parameters after AdamW), the same with 2 microbatches, a prefill step
  (last logits and caches) and a serve step over a sequence-sharded cache
  (logits and caches: the flash-decode combine);
- qwen3-moe-30b-a3b with the GShard dispatch, expert-parallel over
  "model" (`moe_ep_axis`): equal to the run without the axis, with the
  dispatch and combine tensors placed Shard(2) on "model";
- qwen3-moe-30b-a3b's prefill step: the scatter dispatch, each rank's
  experts over the whole batch (`sharded.moe_forward`);
- llama3.2-1b on a 1x4 mesh with H 4, K 2 (Megatron-GQA: KV replicated,
  one query head per rank, ranks 2 and 3 read KV head 1) and with H 6,
  K 2 (6 % 4 != 0: head dim shards), prefill against the unsharded port
  and the reference's prefill step;
- serve steps over sequence-sharded caches for mixtral-8x7b (its SWA ring,
  past the wrap), whisper-tiny (self and cross caches) and
  qwen3-moe-30b-a3b; mamba2-2.7b's train step (the scan by heads) and
  recurrentgemma-9b's prefill step, on the 2x2 mesh.
"""
import json
import os
import tempfile

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dist_helpers import finish, start_ranks, start_snippet  # noqa: E402

LOSS_TOL = 2e-5  # fp32 (tests/test_kernels.py)
PARAM_TOL = 1e-6  # fp32 params after one AdamW step (test_torch_train_models.py)
OUT_TOL = 2e-5  # fp32 logits and caches

B, S, CAP, POS = 4, 16, 16, 10
CASES = [
    {"name": "train", "arch": "llama3.2-1b", "mesh": [2, 2], "kind": "train", "B": B, "S": S},
    {"name": "train_mb2", "arch": "llama3.2-1b", "mesh": [2, 2], "kind": "train", "B": B,
     "S": S, "mb": 2, "seed": 0},
    {"name": "prefill", "arch": "llama3.2-1b", "mesh": [2, 2], "kind": "prefill", "B": B, "S": S},
    {"name": "serve", "arch": "llama3.2-1b", "mesh": [2, 2], "kind": "serve", "B": B, "S": CAP},
    {"name": "moe", "arch": "qwen3-moe-30b-a3b", "mesh": [2, 2], "kind": "train", "B": B, "S": S},
    {"name": "moe_ep", "arch": "qwen3-moe-30b-a3b", "mesh": [2, 2], "kind": "train", "B": B,
     "S": S, "ep": "model", "seed": 4},
    {"name": "moe_prefill", "arch": "qwen3-moe-30b-a3b", "mesh": [2, 2], "kind": "prefill",
     "B": B, "S": S},
    {"name": "gqa", "arch": "llama3.2-1b", "mesh": [1, 4], "kind": "prefill", "B": B, "S": S,
     "heads": [4, 2]},
    {"name": "hd_fallback", "arch": "llama3.2-1b", "mesh": [1, 4], "kind": "prefill", "B": B,
     "S": S, "heads": [6, 2]},
    {"name": "serve_ring", "arch": "mixtral-8x7b", "mesh": [2, 2], "kind": "serve", "B": B,
     "S": CAP, "pos": 20},
    {"name": "serve_encdec", "arch": "whisper-tiny", "mesh": [2, 2], "kind": "serve", "B": B,
     "S": CAP},
    {"name": "serve_moe", "arch": "qwen3-moe-30b-a3b", "mesh": [2, 2], "kind": "serve", "B": B,
     "S": CAP},
    {"name": "ssd_train", "arch": "mamba2-2.7b", "mesh": [2, 2], "kind": "train", "B": B, "S": S},
    {"name": "rglru_prefill", "arch": "recurrentgemma-9b", "mesh": [2, 2], "kind": "prefill",
     "B": B, "S": S},
]
SERVE = [c["name"] for c in CASES if c["kind"] == "serve"]

REF_SNIPPET = """
import os, sys, json, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ShapeConfig
from repro.distributed import steps
from repro.distributed.sharding import make_mesh_compat
from repro.models import build_model
from repro.models.tensors import leaf_path
from repro.train.optimizer import init_opt_state

cases, out_path = json.loads(sys.argv[1]), sys.argv[2]

def named(tree):
    return {leaf_path(p): np.asarray(l).astype(np.float32) if np.asarray(l).dtype != np.int32
            else np.asarray(l) for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}

def unflat(template, flat):
    leaves = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(leaves[1], [jnp.asarray(flat[leaf_path(p)])
                                                     for p, _ in leaves[0]])

out = {"params": {}, "data": {}, "ref": {}}
for i, case in enumerate(cases):
    cfg = dataclasses.replace(get_config(case["arch"]).smoke(), dtype="float32")
    if case.get("heads"):
        cfg = dataclasses.replace(cfg, num_heads=case["heads"][0], num_kv_heads=case["heads"][1])
    model = build_model(cfg)
    mesh = make_mesh_compat(tuple(case["mesh"]), ("data", "model"), devices=jax.devices())
    params = model.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(100 + case.get("seed", i))  # a seed of its own, or a twin's
    kind = case["kind"]
    shape = ShapeConfig(kind, case["S"], case["B"], "decode" if kind == "serve" else kind)
    out["params"][case["name"]] = named(params)
    if kind in ("train", "prefill"):
        tokens = rng.integers(0, cfg.vocab_size, (case["B"], case["S"])).astype(np.int32)
        out["data"][case["name"]] = {"tokens": tokens}
        batch = {"tokens": jnp.asarray(tokens)}
    if kind == "train":
        b = steps.make_train_step(cfg, mesh, shape, microbatches=case.get("mb", 1),
                                  moe_ep_axis=case.get("ep", ""))
        with mesh:
            new, _, loss = b.fn(params, init_opt_state(params), batch)
        out["ref"][case["name"]] = {"loss": float(loss), "params": named(new)}
    elif kind == "prefill":
        b = steps.make_prefill_step(cfg, mesh, shape)
        with mesh:
            last, cache = b.fn(params, batch)
        out["ref"][case["name"]] = {"last": np.asarray(last), "cache": named(cache)}
    else:
        spec = model.input_specs(shape)
        flat, P = {}, case.get("pos", """ + str(POS) + """)
        for p, leaf in jax.tree_util.tree_flatten_with_path(spec["cache"])[0]:
            name = leaf_path(p)
            if name.endswith("kv_pos"):
                # ring slot s holds the latest position before P that is s mod C
                C = leaf.shape[-1]
                slot = np.arange(C)
                held = slot + C * ((P - 1 - slot) // C)
                flat[name] = np.broadcast_to(np.where(held >= 0, held, -1),
                                             leaf.shape).astype(np.int32)
            else:
                flat[name] = (rng.standard_normal(leaf.shape) * 0.5).astype(np.float32)
        token = rng.integers(0, cfg.vocab_size, (case["B"],)).astype(np.int32)
        pos = np.full((case["B"],), P, np.int32)
        out["data"][case["name"]] = {"cache": flat, "token": token, "pos": pos}
        b = steps.make_serve_step(cfg, mesh, shape)
        with mesh:
            logits, cache = b.fn(params, jnp.asarray(token), jnp.asarray(pos),
                                 unflat(spec["cache"], flat))
        out["ref"][case["name"]] = {"logits": np.asarray(logits), "cache": named(cache)}
with open(out_path, "wb") as f:
    pickle.dump(out, f)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def runs():
    """The reference's steps, then the port's on 4 gloo ranks, on the same
    parameters and inputs."""
    import pickle

    tmp = tempfile.mkdtemp(prefix="torch_steps_")
    ref_path = os.path.join(tmp, "ref.pkl")
    code = ("import sys\n" f"sys.argv = ['ref', {json.dumps(CASES)!r}, {ref_path!r}]\n"
            + REF_SNIPPET)
    finish(start_snippet(code, {"JAX_PLATFORMS": "cpu"}), timeout=600)
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    port_path = os.path.join(tmp, "port.pt")
    finish(start_ranks("steps", 4, {"cases": CASES, "params": ref["params"], "data": ref["data"]},
                       port_path), timeout=600)
    return ref, torch.load(port_path, weights_only=False)


def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _hold_tree(got: dict, want: dict, tol: float):
    assert set(got) == set(want)
    errs = {n: _max_err(got[n], want[n]) for n in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])


@pytest.mark.parametrize("name", ["train", "train_mb2", "ssd_train"])
def test_train_step_matches_reference(runs, name):
    ref, port = runs
    r, p = ref["ref"][name], port[name]
    assert abs(p["loss"] - r["loss"]) <= LOSS_TOL, (p["loss"], r["loss"])
    _hold_tree(p["params"], r["params"], PARAM_TOL)


def test_microbatches_keep_the_loss(runs):
    """Two microbatches average to the whole batch's loss.  (AdamW's first
    step is the gradient's sign, so near-zero gradients summed in another
    order move their parameters either way: the reference's own two runs
    differ there too, and each is held against its own above.)"""
    _, port = runs
    assert abs(port["train_mb2"]["loss"] - port["train"]["loss"]) <= LOSS_TOL


@pytest.mark.parametrize("name", ["prefill", "moe_prefill", "gqa", "hd_fallback",
                                  "rglru_prefill"])
def test_prefill_step_matches_reference_and_unsharded(runs, name):
    ref, port = runs
    r, p = ref["ref"][name], port[name]
    assert _max_err(p["last"], r["last"]) <= OUT_TOL
    assert _max_err(p["last"], p["unsharded_last"]) <= OUT_TOL
    _hold_tree(p["cache"], r["cache"], OUT_TOL)


@pytest.mark.parametrize("name", SERVE)
def test_serve_step_matches_reference(runs, name):
    """A serve step over a cache sequence-sharded on "model" (the flash-decode
    combine): llama3.2-1b, mixtral-8x7b's SWA ring past its wrap,
    whisper-tiny's self and cross caches, qwen3-moe-30b-a3b."""
    ref, port = runs
    r, p = ref["ref"][name], port[name]
    assert _max_err(p["logits"], r["logits"]) <= OUT_TOL
    _hold_tree(p["cache"], r["cache"], OUT_TOL)
    assert p["seq_sharded"], "no cache leaf was sequence-sharded"


def test_expert_parallel_axis_changes_placement_not_values(runs):
    ref, port = runs
    plain, ep = port["moe"], port["moe_ep"]
    assert plain["ep_placements"] == []
    assert ep["ep_placements"] == [("Replicate()", "Shard(dim=2)")]
    assert abs(ep["loss"] - plain["loss"]) <= LOSS_TOL
    _hold_tree(ep["params"], plain["params"], PARAM_TOL)
    assert abs(ep["loss"] - ref["ref"]["moe_ep"]["loss"]) <= LOSS_TOL
    _hold_tree(ep["params"], ref["ref"]["moe_ep"]["params"], PARAM_TOL)
