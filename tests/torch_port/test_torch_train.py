"""The port's training substrate (`repro_torch.train`, `launch/train.py`):
analogues of tests/test_train.py's six tests on the port, then parity with
the reference: one AdamW step on identical params, grads and state (fp32
within 1e-6; bf16 params equal or one bf16 step apart), the bigram table,
checkpoints that cross between the packages in both directions, and the
launcher's CLI contract of tests/test_launchers.py with ``--device cpu``
(in-process, for every architecture, and as a subprocess)."""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import data as ref_data  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import arch_ids, get_config  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.models.tensors import flatten_params  # noqa: E402
from repro_torch.train.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                          restore, save)
from repro_torch.train.data import BigramStream, DataConfig  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,  # noqa: E402
                                         global_norm, init_opt_state)

from torch_port_helpers import ref_named_numpy, to_f32  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]


def tiny_cfg(pkg_config=get_config):
    return dataclasses.replace(
        pkg_config("llama3.2-1b"), num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        tie_embeddings=True)


def tiny_model():
    cfg = tiny_cfg()
    return cfg, build_model(cfg)


def init(model, seed=0):
    return model.init(torch.Generator().manual_seed(seed), device="cpu")


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


# ------------------------------------------------- tests/test_train.py on the port
def test_loss_decreases_on_bigram_task():
    cfg, model = tiny_model()
    params = init(model)
    data = BigramStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=8, branching=4))
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=10)
    opt_state = init_opt_state(params)
    losses = []
    for i in range(60):
        params, opt_state, loss, _ = launcher.train_step(
            model, params, opt_state, {"tokens": data.batch(i)}, opt_cfg)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_grad_clip_bounds_update():
    cfg, model = tiny_model()
    params = init(model)
    opt_cfg = AdamWConfig(grad_clip=0.5)
    state = init_opt_state(params)
    big_grads = tree_map(lambda p: torch.full(p.shape, 100.0), params)
    before = tree_map(torch.clone, params)
    new_params, new_state, metrics = adamw_update(params, big_grads, state, opt_cfg)
    assert metrics["grad_norm"] > 0.5  # raw norm reported
    assert int(new_state["step"]) == 1
    assert new_state["step"].dtype == torch.int32 and new_state["step"].dim() == 0
    # the clipped update: |m_hat / sqrt(v_hat)| = 1 per element, lr at warmup
    lr = opt_cfg.lr / opt_cfg.warmup_steps
    for (n, p), (_, q) in zip(flatten_params(before), flatten_params(new_params)):
        bound = lr * (1 + opt_cfg.weight_decay * float(p.abs().max())) + 1e-6
        assert 0 < float((q.float() - p.float()).abs().max()) <= bound, n


def test_data_determinism_and_sharding():
    data = BigramStream(DataConfig(vocab_size=128, seq_len=32, global_batch=8))
    b1 = data.batch(3)
    b2 = data.batch(3)
    assert torch.equal(b1, b2) and b1.dtype == torch.int32
    s0 = data.batch(3, shard=0, num_shards=2)
    s1 = data.batch(3, shard=1, num_shards=2)
    assert s0.shape == (4, 32)
    assert not torch.equal(s0, s1)
    assert not torch.equal(data.batch(4), b1)
    # bigram structure: every transition comes from the table
    tbl = data.table
    ok = [int(b1[i, t + 1]) in tbl[int(b1[i, t])].tolist()
          for i in range(8) for t in range(31)]
    assert all(ok)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    cfg, model = tiny_model()
    params = init(model)
    opt = init_opt_state(params)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, {"params": params, "opt": opt})
    mgr.wait()
    assert latest_step(str(tmp_path)) == 30
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step-"))
    assert kept == ["step-00000020", "step-00000030"]  # gc keeps newest 2

    like = {"params": tree_map(torch.zeros_like, params),
            "opt": tree_map(torch.zeros_like, opt)}
    restored = mgr.restore_latest(like)
    for (n, a), (_, b) in zip(flatten_params(restored), flatten_params(
            {"params": params, "opt": opt})):
        assert a.dtype == b.dtype and torch.equal(a, b), n


def test_checkpoint_detects_tree_mismatch(tmp_path):
    cfg, model = tiny_model()
    params = init(model)
    save(str(tmp_path), 1, {"params": params})
    with pytest.raises(AssertionError):
        restore(str(tmp_path), {"params": params, "extra": torch.zeros(3)})


def test_elastic_restore_onto_new_placement(tmp_path):
    """Restore puts every leaf on the device the `shardings` tree names."""
    cfg, model = tiny_model()
    params = init(model)
    save(str(tmp_path), 5, params)
    like = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
    shardings = tree_map(lambda p: torch.device("cpu"), params)
    restored = restore(str(tmp_path), like, shardings=shardings)
    for (n, a), (_, b) in zip(flatten_params(restored), flatten_params(params)):
        assert a.device == torch.device("cpu") and torch.equal(a, b), n


def test_elastic_restore_with_new_sharding(tmp_path):
    """tests/test_train.py's test of the same name on both packages: one
    checkpoint, restored by the reference onto `SingleDeviceSharding`s and
    by the port onto the device each `shardings` leaf names, gives the same
    leaves in each one's placement."""
    cfg, model = tiny_model()
    params = init(model)
    save(str(tmp_path), 5, params)
    like = tree_map(torch.zeros_like, params)
    restored = restore(str(tmp_path), like,
                       shardings=tree_map(lambda p: torch.device("cpu"), params))
    ref_like = jax.tree.map(lambda t: jnp.zeros(tuple(t.shape), jnp.float32), params)
    sharding = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    got = ref_ckpt.restore(str(tmp_path), ref_like,
                           shardings=jax.tree.map(lambda _: sharding, ref_like))
    assert jax.tree.leaves(got)[0].sharding == sharding
    want = ref_named_numpy(got)
    for n, t in flatten_params(restored):
        assert t.device == torch.device("cpu"), n
        assert np.array_equal(to_f32(t), want[n].astype(np.float32)), n


def test_async_save_error_surfaces_on_wait(tmp_path):
    """A failed background write is raised by `wait()`, not lost."""
    target = tmp_path / "file"
    target.write_text("not a directory")
    mgr = CheckpointManager(str(target))
    mgr.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()


# ---------------------------------------------------------- parity with the reference
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """One AdamW step from the same params, grads and a non-zero state (step
    7, still in warmup): fp32 params and moments within 1e-6, bf16 params
    equal or one bf16 step apart."""
    rc = dataclasses.replace(tiny_cfg(ref_config), dtype=dtype)
    pc = dataclasses.replace(tiny_cfg(), dtype=dtype)
    rp = ref_build(rc).init(jax.random.PRNGKey(0))
    named = ref_named_numpy(rp)
    rng = np.random.default_rng(1)
    grads = {n: (rng.standard_normal(a.shape) * 0.3).astype(np.float32)
             for n, a in named.items()}
    m = {n: (rng.standard_normal(a.shape) * 0.01).astype(np.float32) for n, a in named.items()}
    v = {n: np.abs(rng.standard_normal(a.shape) * 1e-4).astype(np.float32)
         for n, a in named.items()}
    cfg_r = ref_opt.AdamWConfig(lr=1e-3, warmup_steps=5, grad_clip=1.0)
    cfg_p = AdamWConfig(lr=1e-3, warmup_steps=5, grad_clip=1.0)

    def ref_tree(d, cast):
        leaves, treedef = jax.tree_util.tree_flatten_with_path(rp)
        from repro.models.tensors import leaf_path

        return jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(d[leaf_path(p)]).astype(cast(leaf)) for p, leaf in leaves])

    r_state = {"m": ref_tree(m, lambda l: jnp.float32), "v": ref_tree(v, lambda l: jnp.float32),
               "step": jnp.asarray(7, jnp.int32)}
    r_new, r_st, r_met = jax.jit(lambda p, g, s: ref_opt.adamw_update(p, g, s, cfg_r))(
        rp, ref_tree(grads, lambda l: l.dtype), r_state)

    pp = params_from_numpy(named, pc, device="cpu")

    def port_tree(d, dtype_of):
        return tree_map_named(pp, lambda n, p: torch.from_numpy(d[n].copy()).to(dtype_of(p)))

    p_state = {"m": port_tree(m, lambda p: torch.float32),
               "v": port_tree(v, lambda p: torch.float32),
               "step": torch.tensor(7, dtype=torch.int32)}
    p_new, p_st, p_met = adamw_update(pp, port_tree(grads, lambda p: p.dtype), p_state, cfg_p)

    # the norm sums ~1.7e5 squares in fp32 in another order: 1e-5 of it
    assert abs(float(p_met["grad_norm"]) - float(r_met["grad_norm"])) <= 1e-5 * float(
        r_met["grad_norm"])
    assert abs(float(p_met["lr"]) - float(r_met["lr"])) <= 1e-12
    assert int(p_st["step"]) == int(r_st["step"]) == 8
    want = ref_named_numpy({"p": r_new, "m": r_st["m"], "v": r_st["v"]})
    for n, t in flatten_params({"p": p_new, "m": p_st["m"], "v": p_st["v"]}):
        got, ref = to_f32(t), to_f32(want[n])
        if t.dtype == torch.bfloat16:
            # one bf16 step at the larger magnitude
            ulp = np.maximum(np.abs(ref), np.abs(got)) * 2.0 ** -7
            assert np.all(np.abs(got - ref) <= ulp), n
        else:
            assert np.max(np.abs(got - ref)) <= 1e-6, n


def tree_map_named(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: tree_map_named(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_named(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def test_global_norm_and_schedule_match_reference():
    rng = np.random.default_rng(2)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in [(3, 4), (5,), (2, 2, 2)]]
    want = float(ref_opt.global_norm([jnp.asarray(a) for a in leaves]))
    assert abs(float(global_norm([torch.from_numpy(a) for a in leaves])) - want) <= 1e-6 * want
    from repro_torch.train.optimizer import _schedule

    for step in (0, 3, 9, 10, 50):
        assert abs(float(_schedule(AdamWConfig(warmup_steps=10), torch.tensor(step)))
                   - float(ref_opt._schedule(ref_opt.AdamWConfig(warmup_steps=10),
                                             jnp.asarray(step)))) <= 1e-9


@pytest.mark.parametrize("vocab,branching,seed", [(128, 4, 0), (512, 2, 7)])
def test_bigram_table_equals_reference(vocab, branching, seed):
    cfg = dict(vocab_size=vocab, seq_len=16, global_batch=4, seed=seed, branching=branching)
    ref = ref_data.BigramStream(ref_data.DataConfig(**cfg))
    port = BigramStream(DataConfig(**cfg))
    assert np.array_equal(ref.table, port.table) and port.table.dtype == np.int32
    assert port.entropy_floor() == ref.entropy_floor()
    b = port.batch(0).numpy()
    assert all(b[i, t + 1] in port.table[b[i, t]] for i in range(4) for t in range(15))


def _ckpt_tree_pair():
    rc, pc = tiny_cfg(ref_config), tiny_cfg()
    rp = ref_build(rc).init(jax.random.PRNGKey(3))
    named = ref_named_numpy(rp)
    pp = params_from_numpy(named, pc, device="cpu")
    r_opt = ref_opt.init_opt_state(rp)
    r_opt = {**r_opt, "step": jnp.asarray(4, jnp.int32),
             "m": jax.tree.map(lambda x: x + 0.5, r_opt["m"])}
    p_opt = init_opt_state(pp)
    p_opt["step"] = torch.tensor(4, dtype=torch.int32)
    p_opt["m"] = tree_map(lambda x: x + 0.5, p_opt["m"])
    return {"params": rp, "opt": r_opt}, {"params": pp, "opt": p_opt}


def test_checkpoint_written_by_reference_restores_into_port(tmp_path):
    ref_tree, port_tree = _ckpt_tree_pair()
    ref_ckpt.save(str(tmp_path), 4, ref_tree)
    like = tree_map(torch.zeros_like, port_tree)
    got = restore(str(tmp_path), like)
    want = ref_named_numpy(ref_tree)
    for n, t in flatten_params(got):
        assert t.dtype == dict(flatten_params(port_tree))[n].dtype
        assert np.array_equal(to_f32(t), to_f32(want[n])), n


def test_checkpoint_written_by_port_restores_into_reference(tmp_path):
    ref_tree, port_tree = _ckpt_tree_pair()
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(4, port_tree)
    mgr.wait()
    ref_ckpt.save(str(tmp_path / "ref"), 4, ref_tree)
    like = jax.tree.map(jnp.zeros_like, ref_tree)
    got = ref_named_numpy(ref_ckpt.restore(str(tmp_path / "port"), like))
    for n, t in flatten_params(port_tree):
        assert got[n].dtype.name == str(t.dtype).removeprefix("torch."), n
        assert np.array_equal(to_f32(got[n]), to_f32(t)), n
    # the same manifest, entry for entry
    manifests = [json.loads((tmp_path / d / "step-00000004" / "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]


# --------------------------------------------------------------------- the launcher
def run_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = launcher.main(["--device", "cpu", *argv])
    return run, out.getvalue()


def test_train_launcher_prints_loss():
    run, out = run_main(["--arch", "llama3.2-1b", "--smoke", "--steps", "4",
                         "--seq-len", "32", "--batch", "2"])
    assert "loss" in out and out.startswith("llama3.2-1b: ")
    assert "1 device(s)" in out
    assert [s for s, *_ in run.printed] == [0, 3]
    assert all(np.isfinite(loss) for _, loss, _, _ in run.printed)


def test_train_launcher_resume(tmp_path):
    base = ["--arch", "yi-9b", "--smoke", "--steps", "6", "--seq-len", "32",
            "--batch", "2", "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)]
    run1, out1 = run_main(base)
    assert "resumed" not in out1 and latest_step(str(tmp_path)) == 6
    # relaunch with more steps: must resume from the saved step, not step 0
    args2 = list(base)
    args2[args2.index("--steps") + 1] = "8"
    run2, out2 = run_main(args2)
    assert "resumed from step 6" in out2
    assert run2.start == 6 and [s for s, *_ in run2.printed] == [7]
    assert int(run2.opt_state["step"]) == 8  # the restored counter went on


@pytest.mark.parametrize("arch", arch_ids())
def test_train_launcher_every_architecture(arch):
    run, out = run_main(["--arch", arch, "--smoke", "--steps", "2", "--seq-len", "32",
                         "--batch", "2"])
    assert "loss" in out and [s for s, *_ in run.printed] == [0, 1]
    assert all(np.isfinite(loss) for _, loss, _, _ in run.printed)


def test_train_launcher_as_a_module(tmp_path):
    """`python -m repro_torch.launch.train` as a user runs it."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--arch",
         "llama3.2-1b", "--smoke", "--steps", "4", "--seq-len", "32", "--batch", "2"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-1500:]
    assert "loss" in out.stdout


def test_train_launcher_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        launcher.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1"])
