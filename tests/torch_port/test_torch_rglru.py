"""The port's RG-LRU (RecurrentGemma) layers against the reference on the
same inputs: the log-depth linear scan against `jax.lax.associative_scan`
of the reference's combine (and against a step-by-step recurrence), the
RG-LRU layer's prefill and decode, the recurrentgemma-9b smoke model's
prefill and 8 decode steps, and the two-segment cache layout of the full
model's pattern ((rglru, rglru, swa) x n, then (rglru, rglru)), where ring
K/V and recurrence states sit in one unit.

Inputs come from numpy with a seed; weights from the reference's init,
carried across by leaf name.  Tolerances as tests/torch_port/test_torch_models.py:
fp32 1e-4, bf16 2e-2 of the output's scale.
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
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from torch_port_helpers import max_err, ref_named_numpy, to_f32, to_torch  # noqa: E402

NAME = "recurrentgemma-9b"
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the full model's pattern at smoke widths: two segments, ((rglru, rglru,
# swa), 2) then ((rglru, rglru), 1)
TWO_SEGMENTS = dict(num_layers=8,
                    layer_pattern=("rglru", "rglru", "swa") * 2 + ("rglru", "rglru"))


def close(port, ref, dtype) -> bool:
    scale = max(1.0, float(np.abs(to_f32(ref)).max())) if dtype == "bfloat16" else 1.0
    return max_err(port, ref) <= MODEL_TOL[dtype] * scale


def pair(dtype, **over):
    over = dict(dtype=dtype, **over)
    return (dataclasses.replace(ref_config(NAME).smoke(), **over),
            dataclasses.replace(port_config(NAME).smoke(), **over))


def _combine(c1, c2):  # the reference's rglru_forward combine
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, b1 * a2 + b2


@pytest.mark.parametrize("S", [1, 2, 3, 7, 16, 33, 64])
def test_linear_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.8, 1.0, (2, S, 5)).astype(np.float32)
    b = rng.standard_normal((2, S, 5)).astype(np.float32)
    ra, rb = jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    pa, pb = port_layers.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert max_err(pa, ra) < 1e-6 and max_err(pb, rb) < 1e-6
    h, seq = np.zeros((2, 5), np.float32), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    assert max_err(pb, np.stack(seq, 1)) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_layer_prefill_and_decode_match_reference(dtype):
    rc, pc = pair(dtype)
    rp = ref_build(rc).init(jax.random.PRNGKey(2))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    rl = jax.tree.map(lambda a: a[0], rp["segments"][0][0])
    pl = {k: v[0] for k, v in pp["segments"][0][0].items()}
    S = 21
    x = jnp.asarray(np.random.default_rng(3).standard_normal((2, S + 1, rc.d_model))
                    .astype(np.float32)).astype(dtype)
    ctx_r = ref_layers.SeqCtx(positions=jnp.zeros((2, S), jnp.int32), make_cache=True)
    ctx_p = port_layers.SeqCtx(positions=torch.zeros((2, S), dtype=torch.int32),
                               make_cache=True)
    ry, rcache = ref_layers.rglru_forward(rl, x[:, :S], rc, ctx_r)
    py, pcache = port_layers.rglru_forward(pl, to_torch(x[:, :S]), pc, ctx_p)
    assert close(py, ry, dtype)
    assert close(pcache["h"], rcache["h"], dtype) and pcache["h"].dtype == torch.float32
    assert close(pcache["conv"], rcache["conv"], dtype)  # the last 3 projected inputs
    ry, rcache = ref_layers.rglru_decode(rl, x[:, S:], rcache, rc, ctx_r)
    py, pcache = port_layers.rglru_decode(pl, to_torch(x[:, S:]), pcache, pc, ctx_p)
    assert close(py, ry, dtype) and close(pcache["h"], rcache["h"], dtype)


def _prefill_and_decode(dtype, over, seed):
    rc, pc = pair(dtype, **over)
    rm, pm = ref_build(rc), port_build(pc)
    rp = rm.init(jax.random.PRNGKey(seed))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    B, S, cap = 2, 40, 48
    toks = np.random.default_rng(seed).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    rl, rcache = jax.jit(lambda p, b: rm.prefill(p, b, cache_cap=cap))(
        rp, {"tokens": jnp.asarray(toks)})
    pl, pcache = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, cache_cap=cap)
    assert tuple(pl.shape) == (B, S, rc.padded_vocab) and pl.dtype == pc.torch_dtype
    assert close(pl, rl, dtype)
    ref_leaves = jax.tree_util.tree_flatten_with_path(rcache)[0]
    port_leaves = [(s, u, k, pcache[s][u][k]) for s in range(len(pcache))
                   for u in range(len(pcache[s])) for k in sorted(pcache[s][u])]
    assert len(ref_leaves) == len(port_leaves)
    for (path, r), (s, u, k, p) in zip(ref_leaves, port_leaves):
        assert jax.tree_util.keystr(path) == f"[{s}][{u}]['{k}']"
        assert tuple(p.shape) == r.shape and str(p.dtype) == f"torch.{r.dtype}", k
        if k == "kv_pos":
            assert np.array_equal(to_f32(p), to_f32(r))
        else:
            assert close(p, r, dtype), (s, u, k)

    ref_decode = jax.jit(rm.decode)
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    for step in range(8):
        pos = np.full((B,), S + step, np.int32)
        rl, rcache = ref_decode(rp, jnp.asarray(tok), jnp.asarray(pos), rcache)
        pl, pcache = pm.decode(pp, torch.from_numpy(tok), torch.from_numpy(pos), pcache)
        assert close(pl, rl, dtype), f"step {step}: {max_err(pl, rl)}"
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    return pc, pcache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrentgemma_prefill_and_decode_match_reference(dtype):
    _prefill_and_decode(dtype, {}, 11)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_segment_cache_layout_matches_reference(dtype):
    """Two segments with different units; the first unit mixes RG-LRU states
    with a window-bounded ring (the smoke window 64 > the 48-slot cap)."""
    pc, pcache = _prefill_and_decode(dtype, TWO_SEGMENTS, 12)
    assert pc.segments == ((("rglru", "rglru", "swa"), 2), (("rglru", "rglru"), 1))
    assert [len(seg) for seg in pcache] == [3, 2]
    assert sorted(pcache[0][2]) == ["k", "kv_pos", "v"]
    assert pcache[0][2]["k"].shape[:3] == (2, 2, 48)  # (repeat, B, ring)
    assert sorted(pcache[1][0]) == ["conv", "h"] and pcache[1][0]["h"].shape[0] == 1


def test_cache_specs_match_reference():
    rc, pc = pair("bfloat16", **TWO_SEGMENTS)
    ref = jax.tree_util.tree_flatten_with_path(ref_build(rc).cache_specs(3, 100))[0]
    port = port_build(pc).cache_specs(3, 100)
    port = [(f"[{s}][{u}]['{k}']", port[s][u][k]) for s in range(len(port))
            for u in range(len(port[s])) for k in sorted(port[s][u])]
    assert [(jax.tree_util.keystr(p), tuple(s.shape), str(s.dtype)) for p, s in ref] == \
        [(p, tuple(shape), str(dt).removeprefix("torch.")) for p, (shape, dt) in port]
