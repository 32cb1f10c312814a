"""The port's model math against the reference on the same weights: prefill
logits and KV caches, then 8 ring-cache decode steps, for the smoke configs
of three attention families (GQA with tied embeddings, MHA, and qkv bias).

Weights come from the reference's init and cross as numpy by leaf name;
decode feeds both packages the reference's greedy tokens.  Tolerances: fp32
1e-4 (the same math, summed in another order); bf16 2e-2 of the output's
scale (bf16 keeps 8 mantissa bits, one rounding step is 2^-7 of the value,
and the frameworks round matmul outputs and softmax probabilities at
different points, so logits of magnitude ~2 differ by one or two steps).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models import common as port_common  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from torch_port_helpers import max_err, ref_named_numpy, to_f32, to_torch  # noqa: E402

ARCHS = ["llama3.2-1b", "deepseek-7b", "codeqwen1.5-7b"]
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def close(port, ref, dtype) -> bool:
    scale = max(1.0, float(np.abs(to_f32(ref)).max())) if dtype == "bfloat16" else 1.0
    return max_err(port, ref) <= MODEL_TOL[dtype] * scale


def pair(name, dtype, **over):
    rc = dataclasses.replace(ref_config(name).smoke(), dtype=dtype, **over)
    pc = dataclasses.replace(port_config(name).smoke(), dtype=dtype, **over)
    return rc, pc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference(name, dtype):
    rc, pc = pair(name, dtype)
    rm, pm = ref_build(rc), port_build(pc)
    rp = rm.init(jax.random.PRNGKey(sum(map(ord, name))))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    B, S, cap = 2, 24, 40
    toks = np.random.default_rng(0).integers(0, rc.vocab_size, (B, S)).astype(np.int32)

    ref_prefill = jax.jit(lambda params, batch: rm.prefill(params, batch, cache_cap=cap))
    ref_decode = jax.jit(rm.decode)
    rl, rcache = ref_prefill(rp, {"tokens": jnp.asarray(toks)})
    pl, pcache = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, cache_cap=cap)
    assert tuple(pl.shape) == (B, S, rc.padded_vocab) and pl.dtype == pc.torch_dtype
    assert close(pl, rl, dtype)
    for key in ("k", "v"):
        assert close(pcache[0][0][key], rcache[0][0][key], dtype), key
    assert np.array_equal(to_f32(pcache[0][0]["kv_pos"]), to_f32(rcache[0][0]["kv_pos"]))

    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    for step in range(8):
        pos = np.full((B,), S + step, np.int32)
        rl, rcache = ref_decode(rp, jnp.asarray(tok), jnp.asarray(pos), rcache)
        pl, pcache = pm.decode(pp, torch.from_numpy(tok), torch.from_numpy(pos), pcache)
        assert close(pl, rl, dtype), f"step {step}: {max_err(pl, rl)}"
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)


@pytest.mark.parametrize("sections", [(), (8, 4, 4)])
def test_rope_matches_reference(sections):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    if sections:
        pos = np.stack([np.arange(5) * (i + 1) for i in range(3)])[:, None].repeat(2, 1)
    else:
        pos = np.arange(5)[None].repeat(2, 0) + 7
    pos = pos.astype(np.int32)
    ref = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, sections)
    out = port_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0,
                                 sections)
    assert max_err(out, ref) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_swiglu_match_reference(dtype):
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((2, 3, 64)).astype(np.float32)).astype(dtype)
    scale = jnp.asarray(rng.standard_normal(64).astype(np.float32))
    ws = [jnp.asarray(rng.standard_normal(s).astype(np.float32) * 0.1).astype(dtype)
          for s in ((64, 96), (64, 96), (96, 64))]
    tol = MODEL_TOL[dtype]
    assert max_err(port_common.rms_norm(to_torch(x), to_torch(scale)),
                   ref_common.rms_norm(x, scale)) < tol
    assert close(port_common.swiglu(to_torch(x), *map(to_torch, ws)),
                 ref_common.swiglu(x, *ws), dtype)


def test_param_specs_allocate_nothing_and_init_is_seeded():
    rc, pc = pair("llama3.2-1b", "bfloat16")
    m = port_build(pc)
    from repro.models import param_bytes as ref_param_bytes
    from repro_torch.models import param_bytes, param_count
    from repro_torch.models.tensors import flatten_params

    specs = m.param_specs()
    assert all(t.is_meta for _, t in flatten_params(specs))
    ref_tree = jax.eval_shape(lambda: ref_build(rc).init(jax.random.PRNGKey(0)))
    assert param_bytes(specs) == ref_param_bytes(ref_tree)
    assert param_count(specs) == sum(x.size for x in jax.tree.leaves(ref_tree))
    a = flatten_params(m.init(torch.Generator().manual_seed(1), device="cpu"))
    b = flatten_params(m.init(torch.Generator().manual_seed(1), device="cpu"))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))


@pytest.mark.parametrize("name", ["mamba2-2.7b", "qwen3-moe-30b-a3b", "whisper-tiny"])
def test_unported_families_raise(name):
    m = port_build(port_config(name).smoke())
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError):
        m.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)})


def test_prefill_attention_requires_arange_positions():
    _, pc = pair("llama3.2-1b", "float32")
    p = port_build(pc).init(torch.Generator().manual_seed(0), device="cpu")
    attn = {k: v[0] for k, v in p["segments"][0][0]["attn"].items()}
    x = torch.zeros((1, 4, pc.d_model))
    ctx = port_layers.SeqCtx(positions=torch.arange(4)[None] + 3)
    with pytest.raises(ValueError, match="arange"):
        port_layers.attention_forward(attn, x, pc, ctx, "attn")


@pytest.mark.parametrize("name", ["llama3.2-1b", "mixtral-8x7b"])
def test_cache_specs_match_reference_and_prefill(name):
    """(shape, dtype) cache specs — ring-bounded for the sliding-window
    model — equal the reference's ShapeDtypeStructs."""
    rc, pc = pair(name, "bfloat16")
    ref = jax.tree.leaves(ref_build(rc).cache_specs(3, 100))
    port = [spec for seg in port_build(pc).cache_specs(3, 100) for unit in seg
            for spec in (unit[k] for k in sorted(unit))]
    assert [(tuple(s.shape), str(s.dtype)) for s in ref] == \
        [(tuple(shape), str(dt).removeprefix("torch.")) for shape, dt in port]
