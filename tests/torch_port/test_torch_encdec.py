"""The port's Whisper-style encoder-decoder (`models/encdec.py`) against the
reference on the same weights and inputs: layer norm and the sinusoidal
encoder positions, the encoder alone, then the whisper-tiny smoke model's
prefill logits and caches (self-attention ring padded to the cache
capacity, cross-attention K/V over the encoder frames) and 8 decode steps;
the batch maker draws the stub's encoder frames.

Inputs come from numpy with a seed (the encoder frames cross as the
reference's dtype); weights from the reference's init, carried across by
leaf name.  Tolerances as tests/torch_port/test_torch_models.py: fp32 1e-4,
bf16 2e-2 of the output's scale.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro_torch.configs import SHAPES as PORT_SHAPES  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models import encdec as port_encdec  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from torch_port_helpers import max_err, ref_named_numpy, to_f32, to_torch  # noqa: E402

NAME = "whisper-tiny"
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def close(port, ref, dtype) -> bool:
    scale = max(1.0, float(np.abs(to_f32(ref)).max())) if dtype == "bfloat16" else 1.0
    return max_err(port, ref) <= MODEL_TOL[dtype] * scale


def pair(dtype):
    return (dataclasses.replace(ref_config(NAME).smoke(), dtype=dtype),
            dataclasses.replace(port_config(NAME).smoke(), dtype=dtype))


def weights(dtype, seed):
    rc, pc = pair(dtype)
    rp = ref_build(rc).init(jax.random.PRNGKey(seed))
    return rc, pc, rp, params_from_numpy(ref_named_numpy(rp), pc, device="cpu")


def frames(rc, B, seed):
    f = np.random.default_rng(seed).standard_normal((B, rc.encoder_seq, rc.d_model)) * 0.02
    return jnp.asarray(f.astype(np.float32)).astype(rc.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_positions_match_reference(dtype):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((2, 5, 64)).astype(np.float32)).astype(dtype)
    s, b = (jnp.asarray(rng.standard_normal(64).astype(np.float32)) for _ in range(2))
    assert close(port_encdec.layer_norm(to_torch(x), to_torch(s), to_torch(b)),
                 ref_encdec.layer_norm(x, s, b), dtype)
    pos = port_encdec._sinusoid_pos(37, 64, torch.float32, "cpu")
    assert max_err(pos, ref_encdec._sinusoid_pos(37, 64, jnp.float32)) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_reference(dtype):
    rc, pc, rp, pp = weights(dtype, 2)
    f = frames(rc, 2, 3)
    out = port_encdec.encode(pp, pc, to_torch(f))
    assert out.dtype == pc.torch_dtype and close(out, ref_encdec.encode(rp, rc, f), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_prefill_and_decode_match_reference(dtype):
    rc, pc, rp, pp = weights(dtype, 4)
    rm, pm = ref_build(rc), port_build(pc)
    B, S, cap = 2, 24, 40
    toks = np.random.default_rng(5).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    f = frames(rc, B, 6)
    rl, rcache = jax.jit(lambda p, b: rm.prefill(p, b, cache_cap=cap))(
        rp, {"tokens": jnp.asarray(toks), "enc_frames": f})
    pl, pcache = pm.prefill(pp, {"tokens": torch.from_numpy(toks),
                                 "enc_frames": to_torch(f)}, cache_cap=cap)
    assert tuple(pl.shape) == (B, S, rc.padded_vocab) and pl.dtype == pc.torch_dtype
    assert close(pl, rl, dtype)
    assert sorted(pcache) == sorted(rcache)
    for key in ("self_k", "self_v", "cross_k", "cross_v"):
        assert tuple(pcache[key].shape) == rcache[key].shape
        assert close(pcache[key], rcache[key], dtype), key
    assert np.array_equal(to_f32(pcache["kv_pos"]), to_f32(rcache["kv_pos"]))

    ref_decode = jax.jit(rm.decode)
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    for step in range(8):
        pos = np.full((B,), S + step, np.int32)
        rl, rcache = ref_decode(rp, jnp.asarray(tok), jnp.asarray(pos), rcache)
        pl, pcache = pm.decode(pp, torch.from_numpy(tok), torch.from_numpy(pos), pcache)
        assert close(pl, rl, dtype), f"step {step}: {max_err(pl, rl)}"
        assert np.array_equal(to_f32(pcache["kv_pos"]), to_f32(rcache["kv_pos"]))
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)


def test_cache_specs_and_batches_match_reference():
    rc, pc = pair("bfloat16")
    ref = ref_build(rc).cache_specs(3, 100)
    port = port_build(pc).cache_specs(3, 100)
    assert {k: (tuple(s.shape), str(s.dtype)) for k, s in ref.items()} == \
        {k: (tuple(shape), str(dt).removeprefix("torch.")) for k, (shape, dt) in port.items()}
    for kind in ("prefill", "decode"):
        shape = dataclasses.replace(PORT_SHAPES["train_4k"], seq_len=16, global_batch=2,
                                    kind=kind)
        rshape = dataclasses.replace(REF_SHAPES["train_4k"], seq_len=16, global_batch=2,
                                     kind=kind)
        rb = ref_build(rc).make_batch(jax.random.PRNGKey(0), rshape)
        pb = port_build(pc).make_batch(torch.Generator().manual_seed(0), shape, device="cpu")
        rl, _ = jax.tree_util.tree_flatten_with_path(rb)
        pl = [(k, pb[k]) for k in sorted(pb)] if kind == "prefill" else \
            [("cache", pb["cache"][k]) for k in sorted(pb["cache"])] + \
            [(k, pb[k]) for k in ("pos", "token")]
        assert [(tuple(x.shape), str(x.dtype)) for _, x in rl] == \
            [(tuple(x.shape), str(x.dtype).removeprefix("torch.")) for _, x in pl]
