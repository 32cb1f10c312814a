"""Shared parts of the training parity tests: the same numpy-seeded batch
for both packages, the reference's `jax.grad` as numpy leaves, the
tolerances, and the MoE router replay for gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import build_model as ref_build
from repro_torch.configs import get_config as port_config
from repro_torch.models import layers as port_layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.tensors import flatten_params

from torch_port_helpers import ref_named_numpy, to_f32

LOSS_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
FAMILIES = ["llama3.2-1b", "qwen3-moe-30b-a3b", "qwen2-vl-7b", "mixtral-8x7b",
            "mamba2-2.7b", "recurrentgemma-9b", "whisper-tiny"]
DENSE = ["llama3.2-1b", "deepseek-7b", "codeqwen1.5-7b", "yi-9b"]


class GradRouterReplay:
    """Records the expert ids of every reference top-k (an ordered debug
    callback, in forward order; a remat recomputation records again after
    them) and routes each port MoE layer, known by its router's storage, by
    the next unused record on its first call and by the same one after,
    shaped to the leading dims of the tokens it routes ((B, S) for the
    GShard dispatch, (B*S,) for the others)."""

    def __init__(self, monkeypatch):
        self.ids = []
        self.by_layer = {}
        real_top_k = jax.lax.top_k

        def recording(x, k):
            w, idx = real_top_k(x, k)
            jax.debug.callback(lambda i: self.ids.append(np.asarray(i)), idx,
                               ordered=True)
            return w, idx

        def replaying(xf, router, k):
            key = router.data_ptr()
            if key not in self.by_layer:
                jax.effects_barrier()
                assert len(self.by_layer) < len(self.ids), "more port MoE layers"
                ids = self.ids[len(self.by_layer)].reshape(-1, k)
                self.by_layer[key] = torch.from_numpy(ids.astype(np.int64))
            idx = self.by_layer[key]
            assert idx.numel() == xf[..., 0].numel() * k
            idx = idx.reshape(*xf.shape[:-1], k)
            w = torch.softmax(xf.to(torch.float32) @ router, dim=-1).gather(-1, idx)
            return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx

        jax.clear_caches()  # no compiled reference step may skip the callback
        monkeypatch.setattr(jax.lax, "top_k", recording)
        monkeypatch.setattr(port_layers, "route", replaying)


@pytest.fixture
def router_replay(monkeypatch):
    replay = GradRouterReplay(monkeypatch)
    yield replay
    jax.clear_caches()  # drop the traces that call back into this recorder


def pair(name, dtype, **over):
    over = dict(dtype=dtype, **over)
    return (dataclasses.replace(ref_config(name).smoke(), **over),
            dataclasses.replace(port_config(name).smoke(), **over))


def batches(rc, pc, B, S, seed=0):
    """The same numpy-seeded training batch for both packages."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, rc.vocab_size, (B, S)).astype(np.int32)}
    if rc.family == "audio":
        arrays["enc_frames"] = rng.standard_normal((B, rc.encoder_seq, rc.d_model)) * 0.02
    if rc.family == "vlm":
        arrays["vision_embeds"] = rng.standard_normal(
            (B, rc.vision_stub_patches, rc.d_model)) * 0.02
        arrays["mrope_positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32), (3, B, S)).copy()
    ref, port = {}, {}
    for k, a in arrays.items():
        if a.dtype == np.int32:
            ref[k], port[k] = jnp.asarray(a), torch.from_numpy(a)
        else:
            a = a.astype(np.float32)
            ref[k] = jnp.asarray(a).astype(rc.jnp_dtype)
            port[k] = torch.from_numpy(a).to(pc.torch_dtype)
    return ref, port


def setup(name, dtype, seed=3, **over):
    rc, pc = pair(name, dtype, **over)
    rp = ref_build(rc).init(jax.random.PRNGKey(seed))
    pp = params_from_numpy(ref_named_numpy(rp), pc, device="cpu")
    return rc, pc, rp, pp


def ref_value_and_grad(loss_fn, params):
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jax.effects_barrier()
    return float(loss), ref_named_numpy(grads)


def hold(port_loss, port_grads, ref_loss, ref_grads, dtype):
    """The loss within LOSS_TOL (of the reference's scale in bf16) and every
    leaf's gradient within GRAD_TOL relative L2 of the reference's."""
    scale = max(1.0, abs(ref_loss)) if dtype == "bfloat16" else 1.0
    port_loss = float(port_loss.detach())
    assert abs(port_loss - ref_loss) <= LOSS_TOL[dtype] * scale, (
        port_loss, ref_loss)
    named = flatten_params(port_grads)
    assert {n for n, _ in named} == set(ref_grads)
    worst = {}
    for n, g in named:
        got, want = to_f32(g), to_f32(ref_grads[n])
        assert np.isfinite(got).all(), n
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        worst[n] = err
    bad = {n: e for n, e in worst.items() if not e <= GRAD_TOL[dtype]}
    assert not bad, bad
