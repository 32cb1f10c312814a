"""The training path on the card.  Every test here takes the `cuda_device`
fixture and skips without a CUDA device; the file imports neither JAX nor
the reference package, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port

A loss forced onto the kernel route raises (the kernels have no backward);
the loss's own route launches no kernel; one training step of a small
config on the card matches the same step on the CPU (fp32 with TF32 off:
the loss within 2e-5, every leaf's gradient within 1e-4 relative L2); bf16
MoE gradients are finite under each dispatch; a checkpoint round trip on
the card is bitwise; the data stream's batch reaches the card without a
sync.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.train import loss_and_grads, make_batch, train_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.tensors import flatten_params  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.data import BigramStream, DataConfig  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_opt_state  # noqa: E402

pytestmark = pytest.mark.cuda

NAMES = ["llama3.2-1b", "qwen3-moe-30b-a3b", "mamba2-2.7b", "whisper-tiny"]


@pytest.fixture
def fp32_matmuls(cuda_device):
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def small(name, dtype="float32"):
    cfg = dataclasses.replace(get_config(name).smoke(), dtype=dtype)
    return cfg, build_model(cfg)


def test_loss_on_the_kernel_route_raises(cuda_device):
    cfg, model = small("llama3.2-1b", "bfloat16")
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    params["embed"].requires_grad_()
    toks = torch.zeros((1, 64), dtype=torch.int32, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        lm.forward(params, cfg, toks, remat=False, kernel_attention=True)


@pytest.mark.parametrize("name", NAMES)
def test_training_step_matches_the_cpu(fp32_matmuls, name):
    """The loss and every gradient of one step, card against CPU (remat on),
    then the step's update: the loss and the gradient norm agree, and the
    card runs no kernel."""
    dev = fp32_matmuls
    cfg, model = small(name)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    data = BigramStream(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2))
    out = {}
    for d in ("cpu", dev):
        ops.reset_launch_counts()
        p, batch = _to(params, d), make_batch(cfg, data.batch(0, device=d))  # copies
        loss, grads = loss_and_grads(model, p, batch, remat=True)
        _, _, loss2, metrics = train_step(model, p, init_opt_state(p), batch,
                                          AdamWConfig(lr=1e-3, warmup_steps=10))
        assert ops.launch_counts() == {"paged_attention": 0, "flash_attention": 0,
                                      "moe_experts": 0, "rope_kv_write": 0,
                                      "add_rms_norm": 0}
        assert float(loss2) == float(loss)
        out[str(d)] = (float(loss), float(metrics["grad_norm"]), _to(grads, "cpu"))
    (lc, nc, gc), (lg, ng, gg) = out["cpu"], out[str(dev)]
    assert abs(lc - lg) <= 2e-5 and abs(nc - ng) <= 1e-4 * nc
    for (n, a), (_, b) in zip(flatten_params(gc), flatten_params(gg)):
        err = float((a.double() - b.double()).norm())
        assert err <= 1e-4 * max(float(a.double().norm()), 1e-12), n


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device, copy=True)


def test_bf16_loss_and_grads_on_the_card_are_finite(cuda_device):
    cfg, model = small("qwen3-moe-30b-a3b", "bfloat16")
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    toks = BigramStream(DataConfig(cfg.vocab_size, 64, 2)).batch(0, device=cuda_device)
    for impl in ("scatter", "grouped", "gshard"):
        loss, grads = loss_and_grads(model, params, {"tokens": toks}, remat=True,
                                     moe_impl=impl)
        assert torch.isfinite(loss)
        assert all(bool(torch.isfinite(g).all()) for _, g in flatten_params(grads)), impl


def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    cfg, model = small("llama3.2-1b", "bfloat16")
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    tree = {"params": params, "opt": init_opt_state(params)}
    tree["opt"]["step"] += 3
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree)
    mgr.wait()
    like = _to(tree, cuda_device)
    got = mgr.restore_latest({"params": like["params"], "opt": like["opt"]})
    for (n, a), (_, b) in zip(flatten_params(got), flatten_params(tree)):
        assert a.device == b.device and a.dtype == b.dtype and torch.equal(a, b), n


def test_stream_batch_reaches_the_card_without_a_sync(cuda_device):
    """A CUDA batch is the CPU batch, copied from pinned host memory without
    waiting for the device (`set_sync_debug_mode("error")` raises on a sync)."""
    data = BigramStream(DataConfig(vocab_size=1000, seq_len=64, global_batch=4))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = data.batch(3, device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert toks.device.type == "cuda" and toks.dtype == torch.int32
    assert torch.equal(toks.cpu(), data.batch(3))
