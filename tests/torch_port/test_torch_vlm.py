"""The port's VLM path (qwen2-vl-7b's smoke config: M-RoPE, qkv bias and the
vision-embeds prefix) against the reference: prefill logits and caches,
8 ring-cache decode steps, and the engine's paged path — prefill with
vision embeds, 8 paged decode steps with identical block tables and load
ledgers.  Also the reference's test_models.py check that scaling the
embeddings changes the output, and `make_batch`'s inputs.

Inputs come from numpy with a seed; reference weights cross by leaf name.
Tolerances are tests/test_kernels.py's: 2e-5 absolute for fp32, 2e-2 of
the reference's scale for bf16.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import ShapeConfig  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.configs import ShapeConfig as PortShape  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from torch_port_helpers import (close_to, load_ledger, load_report, max_err,  # noqa: E402
                                paired_engines, ref_named_numpy, to_f32, to_torch)

NAME = "qwen2-vl-7b"


def pair(dtype, **over):
    over = dict(dtype=dtype, **over)
    return (dataclasses.replace(ref_config(NAME).smoke(), **over),
            dataclasses.replace(port_config(NAME).smoke(), **over))


def batches(cfg, B, S, seed, scale=1.0):
    """The same prefill batch for both packages: tokens, vision embeds (in
    the model's dtype) and text-style M-RoPE positions, from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    emb = jnp.asarray(rng.standard_normal((B, cfg.vision_stub_patches, cfg.d_model))
                      .astype(np.float32) * 0.02 * scale).astype(cfg.jnp_dtype)
    mrope = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    ref = {"tokens": jnp.asarray(toks), "vision_embeds": emb,
           "mrope_positions": jnp.asarray(mrope)}
    port = {"tokens": torch.from_numpy(toks), "vision_embeds": to_torch(emb),
            "mrope_positions": torch.from_numpy(mrope)}
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_and_ring_decode_match_reference(dtype):
    rc, pc = pair(dtype)
    rm, pm = ref_build(rc), port_build(pc)
    rp = rm.init(jax.random.PRNGKey(21))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    B, S, cap = 2, 20, 40
    rb, pb = batches(rc, B, S, 0)
    rl, rcache = jax.jit(lambda p, b: rm.prefill(p, b, cache_cap=cap))(rp, rb)
    pl, pcache = pm.prefill(pp, pb, cache_cap=cap)
    assert tuple(pl.shape) == (B, S, rc.padded_vocab)
    assert close_to(pl, rl, dtype), max_err(pl, rl)
    for key in ("k", "v"):
        assert close_to(pcache[0][0][key], rcache[0][0][key], dtype), key
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    ref_decode = jax.jit(rm.decode)
    for step in range(8):
        pos = np.full((B,), S + step, np.int32)
        rl, rcache = ref_decode(rp, jnp.asarray(tok), jnp.asarray(pos), rcache)
        pl, pcache = pm.decode(pp, torch.from_numpy(tok), torch.from_numpy(pos), pcache)
        assert close_to(pl, rl, dtype), f"step {step}: {max_err(pl, rl)}"
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)


def test_vision_embeds_change_output():
    """The port's analogue of tests/test_models.py::
    test_vision_embeds_change_output: scaling the patch embeddings by 5
    changes the prefill logits, as it changes the reference's."""
    rc, pc = pair("float32")
    rm, pm = ref_build(rc), port_build(pc)
    rp = rm.init(jax.random.PRNGKey(3))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    diffs = []
    for scale in (1.0, 5.0):
        rb, pb = batches(rc, 1, 16, 1, scale)
        rl, _ = rm.prefill(rp, rb)
        pl, _ = pm.prefill(pp, pb)
        assert close_to(pl, rl, "float32")
        diffs.append((to_f32(pl), to_f32(rl)))
    (p1, r1), (p5, r5) = diffs
    assert np.abs(p5 - p1).max() > 1e-4 and np.abs(r5 - r1).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_engine_prefill_and_paged_decode_match_reference(dtype):
    """Engine.load -> Instance.prefill (vision embeds, mixed lengths) -> 8
    paged decode steps that cross a block boundary: identical LoadReport,
    DataLoadStats and host-store ledger, identical block tables and uploads,
    logits within tolerance."""
    rc, pc = pair(dtype, num_layers=2)
    ref, port, _ = paired_engines({"m": (rc, pc, 4)})
    assert load_report(port.load("m")) == load_report(ref.load("m"))
    assert load_ledger(port) == load_ledger(ref)
    ri = ref.start_instance("m", num_pages=64, attn_mode="ref")
    pi = port.start_instance("m", num_pages=64)
    lens = [14, 11]
    rb, pb = batches(rc, 2, 14, 5)
    rl = ri.prefill(rb, lengths=lens)
    pl = pi.prefill(pb, lengths=lens)
    assert close_to(pl, rl, dtype), max_err(pl, rl)
    assert np.array_equal(pi._tables_np, ri._tables_np)
    tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    for step in range(8):
        rl = ri.decode(jnp.asarray(tok))
        pl = pi.decode(torch.from_numpy(tok))
        assert close_to(pl, rl, dtype), f"step {step}: {max_err(pl, rl)}"
        assert np.array_equal(pi._tables_np, ri._tables_np), step
        assert pi.table_uploads == ri.table_uploads
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    assert pi.table_uploads == 2  # each row crossed into its second block
    ri.finish(), pi.finish()
    ref.release("m"), port.release("m")
    assert load_report(port.load("m")) == load_report(ref.load("m"))  # warm
    assert load_ledger(port) == load_ledger(ref)
    ref.close(), port.close()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_make_batch_matches_reference_inputs(kind):
    """Same keys, shapes and dtypes as the reference's `make_batch`, M-RoPE
    positions text-style (all three streams arange(S)), positions and
    `kv_pos` zero, tokens within the vocabulary, float inputs 0.02 times a
    standard normal."""
    rc, pc = pair("bfloat16")
    ref = ref_build(rc).make_batch(jax.random.PRNGKey(0), ShapeConfig("t", 24, 2, kind))
    port = port_build(pc).make_batch(torch.Generator().manual_seed(0),
                                     PortShape("t", 24, 2, kind), device="cpu")
    from repro_torch.models.tensors import flatten_params

    rflat = ref_named_numpy(ref)
    pflat = dict(flatten_params(port))
    assert list(rflat) == list(pflat)
    for name, r in rflat.items():
        t = pflat[name]
        assert tuple(t.shape) == r.shape, name
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), name
        if "mrope" in name or "pos" in name:
            assert np.array_equal(to_f32(t), r.astype(np.float32)), name
        elif t.dtype == torch.int32:
            assert 0 <= int(t.min()) and int(t.max()) < rc.vocab_size, name
        else:  # 0.02 x standard normal
            assert 0 < float(t.float().abs().max()) < 0.02 * 8, name
