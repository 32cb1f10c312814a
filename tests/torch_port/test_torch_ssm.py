"""The port's Mamba2 (SSD) layers against the reference on the same inputs:
the causal depthwise conv with and without a decode state, `segsum`, the
chunked SSD scan (directly, and through `ssd_forward` with S not a multiple
of the chunk, whose padded steps must leave the final state exact), and the
mamba2-2.7b smoke model's prefill logits and caches, then 8 decode steps.

Inputs come from numpy with a seed; weights from the reference's init,
carried across by leaf name.  Tolerances: fp32 1e-4 (the same math summed
in another order); bf16 2e-2 of the output's scale (one or two bf16
rounding steps, taken at different points by the two frameworks).
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
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models import common as port_common  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

from torch_port_helpers import max_err, ref_named_numpy, to_f32, to_torch  # noqa: E402

NAME = "mamba2-2.7b"
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def close(port, ref, dtype) -> bool:
    scale = max(1.0, float(np.abs(to_f32(ref)).max())) if dtype == "bfloat16" else 1.0
    return max_err(port, ref) <= MODEL_TOL[dtype] * scale


def pair(dtype, **over):
    over = dict(dtype=dtype, **over)
    return (dataclasses.replace(ref_config(NAME).smoke(), **over),
            dataclasses.replace(port_config(NAME).smoke(), **over))


def arr(rng, shape, dtype="float32", scale=1.0):
    return jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32)).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(dtype, with_state):
    rng = np.random.default_rng(1)
    S = 1 if with_state else 13
    x, w = arr(rng, (2, S, 24), dtype), arr(rng, (4, 24), dtype, 0.5)
    state = arr(rng, (2, 3, 24), dtype) if with_state else None
    ry, rs = ref_common.causal_conv1d(x, w, state=state)
    py, ps = port_common.causal_conv1d(to_torch(x), to_torch(w),
                                       state=None if state is None else to_torch(state))
    assert py.dtype == getattr(torch, dtype) and tuple(py.shape) == ry.shape
    assert close(py, ry, dtype)
    # the decode state is the last W-1 inputs, exactly
    assert np.array_equal(to_f32(ps), to_f32(rs))


def test_segsum_is_zero_after_exp_above_the_diagonal():
    x = np.random.default_rng(2).standard_normal((3, 7)).astype(np.float32)
    ref = ref_layers.segsum(jnp.asarray(x))
    out = port_layers.segsum(torch.from_numpy(x))
    e = torch.exp(out)
    assert not torch.isnan(e).any()
    assert torch.equal(torch.triu(e, 1), torch.zeros_like(e))
    fin = np.isfinite(np.asarray(ref))
    assert np.array_equal(fin, torch.isfinite(out).numpy())
    assert np.abs(np.asarray(ref)[fin] - out.numpy()[fin]).max() < 1e-6


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_reference(init):
    rng = np.random.default_rng(3)
    b, s, h, p, n, chunk = 2, 48, 3, 4, 5, 16
    x = arr(rng, (b, s, h, p))
    A = -jnp.abs(arr(rng, (b, s, h), scale=0.3))
    Bm, Cm = arr(rng, (b, s, n)), arr(rng, (b, s, n))
    st = arr(rng, (b, h, p, n)) if init else None
    ry, rst = ref_layers.ssd_chunked(x, A, Bm, Cm, chunk, init_state=st)
    py, pst = port_layers.ssd_chunked(*map(to_torch, (x, A, Bm, Cm)), chunk,
                                      init_state=None if st is None else to_torch(st))
    assert max_err(py, ry) < 1e-4 and max_err(pst, rst) < 1e-4


@pytest.mark.parametrize("S", [40, 32, 7])
def test_ssd_forward_pads_to_the_chunk_and_keeps_the_final_state_exact(S):
    """S 40 with chunk 32: 24 padded steps of dt 0; S 32: none; S 7 < chunk.
    The final state equals the reference's and the state a step-by-step
    recurrence reaches over the real steps only."""
    rc, pc = pair("float32")
    rp = ref_build(rc).init(jax.random.PRNGKey(5))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    rl = jax.tree.map(lambda a: a[0], rp["segments"][0][0])
    pl = {k: v[0] for k, v in pp["segments"][0][0].items()}
    x = arr(np.random.default_rng(S), (2, S, rc.d_model))
    ctx_r = ref_layers.SeqCtx(positions=jnp.zeros((2, S), jnp.int32), make_cache=True)
    ctx_p = port_layers.SeqCtx(positions=torch.zeros((2, S), dtype=torch.int32),
                               make_cache=True)
    ry, rcache = ref_layers.ssd_forward(rl, x, rc, ctx_r)
    py, pcache = port_layers.ssd_forward(pl, to_torch(x), pc, ctx_p)
    assert max_err(py, ry) < 1e-4
    for key in ("conv", "state"):
        assert max_err(pcache[key], rcache[key]) < 1e-4, key
    # the same state by one ssd_decode step at a time from zeros
    cache = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt)
             in port_layers.ssd_cache_spec(pc, 2).items()}
    for t in range(S):
        _, cache = port_layers.ssd_decode(pl, to_torch(x)[:, t : t + 1], cache, pc, ctx_p)
    assert max_err(cache["state"], pcache["state"]) < 1e-4
    assert max_err(cache["conv"], pcache["conv"]) == 0.0


def test_ssd_cache_spec_matches_reference():
    rc, pc = pair("bfloat16")
    ref = ref_layers.ssd_cache_spec(rc, 3)
    port = port_layers.ssd_cache_spec(pc, 3)
    assert {k: (tuple(s.shape), str(s.dtype)) for k, s in ref.items()} == \
        {k: (tuple(shape), str(dt).removeprefix("torch.")) for k, (shape, dt) in port.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_prefill_and_decode_match_reference(dtype):
    rc, pc = pair(dtype)
    rm, pm = ref_build(rc), port_build(pc)
    rp = rm.init(jax.random.PRNGKey(7))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    B, S = 2, 40  # not a multiple of the smoke chunk (32)
    toks = np.random.default_rng(8).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    rl, rcache = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(toks)})
    pl, pcache = pm.prefill(pp, {"tokens": torch.from_numpy(toks)})
    assert tuple(pl.shape) == (B, S, rc.padded_vocab) and pl.dtype == pc.torch_dtype
    assert close(pl, rl, dtype)
    for key in ("conv", "state"):
        assert close(pcache[0][0][key], rcache[0][0][key], dtype), key
    assert pcache[0][0]["state"].dtype == torch.float32

    ref_decode = jax.jit(rm.decode)
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    for step in range(8):
        pos = np.full((B,), S + step, np.int32)
        rl, rcache = ref_decode(rp, jnp.asarray(tok), jnp.asarray(pos), rcache)
        pl, pcache = pm.decode(pp, torch.from_numpy(tok), torch.from_numpy(pos), pcache)
        assert close(pl, rl, dtype), f"step {step}: {max_err(pl, rl)}"
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
