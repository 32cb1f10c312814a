"""The training path's other routes against the reference's `jax.grad`,
on the CPU at smoke size: the blockwise attention of long sequences
(`attn_chunked`) forced on a sequence that crosses a chunk; each of the
three MoE dispatches (scatter, grouped, GShard) against its reference
counterpart, at a capacity that drops tokens too; and a bf16 row per dense
configuration.

Inputs come from numpy with a seed; reference weights cross by leaf name.
Tolerances (`train_parity_helpers`): fp32 loss within 2e-5 and gradients
within a relative L2 error of 1e-4 per leaf; bf16 loss within 2e-2 of the
reference's scale and gradients within a relative L2 error of 2e-2 (the
frameworks round at other points; the rows measure up to ~1.2e-2).  MoE
rows replay the reference's expert choices (`GradRouterReplay`).
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import torch  # noqa: E402

from repro.models import build_model as ref_build  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch.launch.train import loss_and_grads  # noqa: E402
from repro_torch.models import build_model as port_build  # noqa: E402
from repro_torch.models import layers as port_layers  # noqa: E402
from repro_torch.models import lm as port_lm  # noqa: E402
from repro_torch.models.tensors import (flatten_params, tree_structure,  # noqa: E402
                                        tree_unflatten)

from train_parity_helpers import (DENSE, batches, hold,  # noqa: E402,F401
                                  ref_value_and_grad, router_replay, setup)

@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2-vl-7b", "mixtral-8x7b"])
def test_chunked_attention_loss_matches_reference(name, router_replay):
    """`lm_loss` with `attn_chunked` forced, 32-token chunks over S 128: the
    causal mask crosses chunks, and mixtral's 64-token window masks whole
    chunks behind it."""
    rc, pc, rp, pp = setup(name, "float32")
    rb, pb = batches(rc, pc, 1, 128)
    kw = dict(attn_chunked=True, q_chunk=32, kv_chunk=32, remat=False,
              mrope_positions=None, vision_embeds=None)
    if rc.family == "vlm":
        kw_r = dict(kw, mrope_positions=rb["mrope_positions"],
                    vision_embeds=rb["vision_embeds"])
        kw_p = dict(kw, mrope_positions=pb["mrope_positions"],
                    vision_embeds=pb["vision_embeds"])
    else:
        kw_r = kw_p = kw
    ref_loss, ref_grads = ref_value_and_grad(
        lambda p: ref_lm.lm_loss(p, rc, rb["tokens"], **kw_r), rp)
    leaves = [t.requires_grad_() for _, t in flatten_params(pp)]
    loss = port_lm.lm_loss(pp, pc, pb["tokens"], **kw_p)
    grads = torch.autograd.grad(loss, leaves)
    hold(loss, tree_unflatten(tree_structure(pp), list(grads)), ref_loss, ref_grads,
         "float32")


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5_drops"])
@pytest.mark.parametrize("impl", ["scatter", "grouped", "gshard"])
def test_moe_dispatch_matches_reference(impl, cf, router_replay):
    """Each dispatch's loss and gradients against the reference's same
    dispatch (qwen3-moe-30b-a3b smoke, B 2, S 64: the scatter capacity
    comes from B*S, the grouped and GShard ones from S), with remat on so
    the GShard combine output is the saved tensor."""
    rc, pc, rp, pp = setup("qwen3-moe-30b-a3b", "float32")
    rb, pb = batches(rc, pc, 2, 64, seed=4)
    ref_loss, ref_grads = ref_value_and_grad(
        lambda p: ref_lm.lm_loss(p, rc, rb["tokens"], remat=True, moe_impl=impl,
                                 moe_capacity_factor=cf), rp)
    leaves = [t.requires_grad_() for _, t in flatten_params(pp)]
    loss = port_lm.lm_loss(pp, pc, pb["tokens"], remat=True, moe_impl=impl,
                           moe_capacity_factor=cf)
    grads = torch.autograd.grad(loss, leaves)
    hold(loss, tree_unflatten(tree_structure(pp), list(grads)), ref_loss, ref_grads,
         "float32")
    if cf < 1:  # some expert overflows its capacity: the drop path ran
        groups = [ids.reshape(-1) if impl == "scatter" else ids.reshape(2, -1)[b]
                  for ids in router_replay.ids[:4] for b in range(2)]
        cap = port_layers.moe_capacity(groups[0].size // 2, 2, 8, cf)
        assert max(np.bincount(g, minlength=8).max() for g in groups) > cap


@pytest.mark.parametrize("name", DENSE)
def test_bf16_loss_and_grads_match_reference(name):
    """The dense configurations in bf16, remat on (the reference's default)."""
    rc, pc, rp, pp = setup(name, "bfloat16")
    rb, pb = batches(rc, pc, 2, 24)
    rm, pm = ref_build(rc), port_build(pc)
    ref_loss, ref_grads = ref_value_and_grad(lambda p: rm.loss(p, rb), rp)
    loss, grads = loss_and_grads(pm, pp, pb, remat=True)
    hold(loss, grads, ref_loss, ref_grads, "bfloat16")


