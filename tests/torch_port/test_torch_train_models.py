"""The models' training halves against the reference's `jax.grad`, on the
CPU at smoke size: `Model.loss` and the gradient of every leaf, for every
family, with the per-unit remat off and on; and the port's remat itself
(each unit recomputed in backward, the GShard combine output saved,
nothing entered outside autograd).

Inputs come from numpy with a seed; reference weights cross by leaf name.
Tolerances (`train_parity_helpers`): fp32 loss within 2e-5
(tests/test_kernels.py's fp32 tolerance) and every leaf's gradient within a
relative L2 error of 1e-4 (||g_port - g_ref|| / ||g_ref||; the fp32 rows
measure ~1e-6).

Routing ties.  MoE rows give the port the reference's expert choices
(`GradRouterReplay`): each reference top-k is recorded in forward order
and the port's `layers.route` takes it in place of its own, weighted by its
own router probabilities.  A layer is known by its router's storage, so the
port's remat recomputation routes as its first forward did.
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models import build_model as ref_build  # noqa: E402
from repro_torch.launch.train import loss_and_grads, make_batch  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models.tensors import flatten_params  # noqa: E402

from train_parity_helpers import (FAMILIES, batches, hold, pair,  # noqa: E402,F401
                                  ref_value_and_grad, router_replay, setup)

@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_reference(name, remat, router_replay):
    """Model.loss and every leaf's gradient, fp32, B 2, S 24."""
    rc, pc, rp, pp = setup(name, "float32")
    rb, pb = batches(rc, pc, 2, 24)
    rm, pm = ref_build(rc), port_build(pc)
    ref_loss, ref_grads = ref_value_and_grad(
        lambda p: rm.loss(p, rb, remat=remat), rp)
    loss, grads = loss_and_grads(pm, pp, pb, remat=remat, moe_impl="scatter")
    hold(loss, grads, ref_loss, ref_grads, "float32")
    if rc.is_moe:
        assert router_replay.by_layer, "no MoE layer was replayed"


@pytest.mark.parametrize("name", ["qwen2-vl-7b", "whisper-tiny"])
def test_launcher_stub_batch_matches_reference(name):
    """The launchers' own batch: all-zero VLM / audio stubs and arange
    M-RoPE positions (the port's `launch.train.make_batch`, the reference's
    inline `make_batch`), fp32, B 2, S 24.  For the VLM the zero patch rows
    stay zero through every layer (their q, k, v are the biases, which init
    to zero), so each RMSNorm meets an all-zero row, whose derivative is
    1/sqrt(eps) = 1e3; compounded over the layers it reaches layer 0's `bv`,
    the one leaf whose gradient does not multiply the zero activations.  Its
    norm reads ~1e8 in both packages at the first step (the launcher's
    first printed gnorm; the clip bounds the update)."""
    rc, pc, rp, pp = setup(name, "float32")
    B, S = 2, 24
    toks = np.random.default_rng(0).integers(0, rc.vocab_size, (B, S)).astype(np.int32)
    rb = {"tokens": jnp.asarray(toks)}
    if rc.family == "audio":
        rb["enc_frames"] = jnp.zeros((B, rc.encoder_seq, rc.d_model), rc.jnp_dtype)
    if rc.family == "vlm":
        rb["vision_embeds"] = jnp.zeros((B, rc.vision_stub_patches, rc.d_model),
                                        rc.jnp_dtype)
        rb["mrope_positions"] = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (3, B, S))
    pb = make_batch(pc, torch.from_numpy(toks))
    rm, pm = ref_build(rc), port_build(pc)
    ref_loss, ref_grads = ref_value_and_grad(lambda p: rm.loss(p, rb, remat=False), rp)
    loss, grads = loss_and_grads(pm, pp, pb)
    hold(loss, grads, ref_loss, ref_grads, "float32")
    if rc.family == "vlm":
        top = max(ref_grads, key=lambda n: np.linalg.norm(ref_grads[n]))
        assert top == "segments/0/0/attn/bv", top
        assert np.linalg.norm(ref_grads[top]) > 1e6


def test_remat_recomputes_each_unit_but_saves_the_moe_combine(monkeypatch):
    """With remat the expert products of every MoE layer run twice (forward,
    then the unit's recomputation in backward) while the named GShard
    combine output is saved; without remat they run once."""
    _, pc = pair("qwen3-moe-30b-a3b", "float32", num_layers=2)
    pm = port_build(pc)
    params = pm.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, pc.vocab_size, (1, 16), generator=torch.Generator().manual_seed(1))
    calls = []
    inner = port_layers._experts
    monkeypatch.setattr(port_layers, "_experts",
                        lambda xe, p: calls.append(1) or inner(xe, p))
    assert port_layers._save_moe_y(None, torch.ops.repro_torch.moe_y.default) == \
        torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert port_layers._save_moe_y(None, torch.ops.aten.mm.default) == \
        torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
    runs = {}
    for remat in (False, True):
        calls.clear()
        loss, grads = loss_and_grads(pm, params, {"tokens": toks}, remat=remat)
        runs[remat] = (len(calls), float(loss), grads)
    assert runs[False][0] == 2 and runs[True][0] == 4
    assert runs[False][1] == runs[True][1]
    for (n, a), (_, b) in zip(flatten_params(runs[False][2]), flatten_params(runs[True][2])):
        assert torch.allclose(a, b, rtol=0, atol=1e-6), n


def test_remat_is_inert_outside_autograd(monkeypatch):
    """A forward in which no input requires grad (serving) never enters the
    checkpoint, even with `remat` on."""
    _, pc = pair("llama3.2-1b", "float32", num_layers=2)
    pm = port_build(pc)
    params = pm.init(torch.Generator().manual_seed(0), device="cpu")
    seen = []
    monkeypatch.setattr(port_layers, "checkpoint", lambda *a, **k: seen.append(1))
    logits, _ = port_lm.forward(params, pc, torch.zeros((1, 8), dtype=torch.int32),
                                make_cache=True, remat=True)
    assert not seen and logits.shape == (1, 8, pc.padded_vocab)
