"""Sliding-window attention with its ring cache (mixtral-8x7b, MoE + SWA)
against the reference: prefill and 8 ring decode steps at a prompt inside
the window and at one longer than it (the window masks, and the ring holds
exactly `sliding_window` slots), with the reference's expert choices
replayed (`RouterReplay`: bf16 near-ties route either way).

It also pins a reference behaviour of the Engine's non-paged fallback that
the port keeps: `Instance.prefill` passes ``cache_cap = round_up(S,
block_tokens)``, so after a prompt of a whole number of blocks every SWA
ring has S slots, fewer than the window, and the first decoded token
(position S, slot S % S = 0) overwrites position 0, which the window still
covers: decode token 1 no longer attends to position 0, in either package.

Tolerances as tests/torch_port/test_torch_models.py: fp32 1e-4, bf16 2e-2 of
the output's scale.
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
from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from test_torch_moe import RouterReplay  # noqa: E402

from torch_port_helpers import max_err, paired_engines, ref_named_numpy, to_f32  # noqa: E402

NAME = "mixtral-8x7b"
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def close(port, ref, dtype) -> bool:
    scale = max(1.0, float(np.abs(to_f32(ref)).max())) if dtype == "bfloat16" else 1.0
    return max_err(port, ref) <= MODEL_TOL[dtype] * scale


def pair(dtype, **over):
    over = dict(dtype=dtype, num_layers=2, **over)
    return (dataclasses.replace(ref_config(NAME).smoke(), **over),
            dataclasses.replace(port_config(NAME).smoke(), **over))


@pytest.fixture
def router_replay(monkeypatch):
    replay = RouterReplay(monkeypatch)
    yield replay
    jax.clear_caches()  # drop the traces that call back into this recorder


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,cap", [(24, 40), (80, 90)])
def test_swa_prefill_and_ring_decode_match_reference(dtype, S, cap, router_replay):
    """S 24: inside the smoke window (64), a 40-slot ring; S 80 > 64: the
    window masks at prefill and the ring holds 64 slots, so decode wraps."""
    rc, pc = pair(dtype)
    rm, pm = ref_build(rc), port_build(pc)
    rp = rm.init(jax.random.PRNGKey(S))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    B = 2
    toks = np.random.default_rng(S).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    rl, rcache = jax.jit(lambda p, b: rm.prefill(p, b, cache_cap=cap))(
        rp, {"tokens": jnp.asarray(toks)})
    pl, pcache = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, cache_cap=cap)
    assert close(pl, rl, dtype), max_err(pl, rl)
    ring = min(cap, rc.sliding_window)
    assert pcache[0][0]["k"].shape[2] == ring == rcache[0][0]["k"].shape[2]
    for key in ("k", "v"):
        assert close(pcache[0][0][key], rcache[0][0][key], dtype), key
    assert np.array_equal(to_f32(pcache[0][0]["kv_pos"]), to_f32(rcache[0][0]["kv_pos"]))
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    ref_decode = jax.jit(rm.decode)
    for step in range(8):
        pos = np.full((B,), S + step, np.int32)
        rl, rcache = ref_decode(rp, jnp.asarray(tok), jnp.asarray(pos), rcache)
        pl, pcache = pm.decode(pp, torch.from_numpy(tok), torch.from_numpy(pos), pcache)
        assert close(pl, rl, dtype), f"step {step}: {max_err(pl, rl)}"
        assert np.array_equal(to_f32(pcache[0][0]["kv_pos"]), to_f32(rcache[0][0]["kv_pos"]))
        tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    router_replay.done()


def test_engine_ring_wraps_at_a_block_multiple_prompt_in_both_packages():
    rc, pc = pair("float32")
    ref, port, weights = paired_engines({"m": (rc, pc, 9)})
    ref.load("m"), port.load("m")
    S = 2 * ref.block_tokens  # a whole number of blocks, inside the window
    assert S < rc.sliding_window
    toks = np.random.default_rng(9).integers(0, rc.vocab_size, (1, S)).astype(np.int32)
    ri, pi = ref.start_instance("m"), port.start_instance("m")
    rl = ri.prefill({"tokens": jnp.asarray(toks)})
    pl = pi.prefill({"tokens": torch.from_numpy(toks)})
    assert not ri.paged and not pi.paged
    assert max_err(pl, rl) < 1e-4
    for inst in (ri, pi):
        kv_pos = to_f32(inst._cache[0][0]["kv_pos"])
        assert kv_pos.shape == (rc.num_layers, 1, S)  # a ring of S slots, not the window
        assert (kv_pos == np.arange(S)).all()
    tok = np.asarray(jnp.argmax(rl, -1)).astype(np.int32)
    rl = ri.decode(jnp.asarray(tok))
    pl = pi.decode(torch.from_numpy(tok))
    assert max_err(pl, rl) < 1e-4
    for inst in (ri, pi):
        kv_pos = to_f32(inst._cache[0][0]["kv_pos"])
        assert kv_pos[:, 0, 0].tolist() == [S] * rc.num_layers  # slot 0: position S
        assert 0 not in kv_pos  # position 0 is gone though the window covers it

    # with room in the ring (the reference model test's cap S + 8), token 1
    # still sees position 0 and its logits differ
    rm = ref_build(rc)
    _, roomy = rm.prefill(weights["m"], {"tokens": jnp.asarray(toks)}, cache_cap=S + 8)
    wide, _ = rm.decode(weights["m"], jnp.asarray(tok), jnp.asarray([S], jnp.int32), roomy)
    assert max_err(wide, rl) > 1e-3
    ri.finish(), pi.finish()
    ref.close(), port.close()
