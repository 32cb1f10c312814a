"""The routed-experts kernel (`kernels/moe_experts.py`, CUDA
`csrc/moe_experts.cu`) on the card.

Every test here is marked `cuda` and skips without a CUDA device; the file
imports neither JAX nor the reference package, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port/test_torch_moe_card.py

- The kernel against its plain version (`ref.moe_experts_ref`) at
  qwen3-moe-30b-a3b's widths (B 1 and B 4, and 12 tokens routed alike,
  4 of each expert's pairs dropped), mixtral-8x7b's (E 8, k 2, D 4096,
  F 14336) and smoke width, bf16 within 2e-2 of the output's scale and
  fp32 within 2e-5: bitwise repeatable, and blind to every expert no kept
  pair is routed to (NaN weights there change nothing).
- qwen3-moe-30b-a3b at full width in 2 layers on an `Engine`: a 512-token
  prefill launches the kernel 0 times; the paged decode step, eager, then
  captured and replayed, gives logits bitwise equal to an eager engine's,
  and each step adds one launch a MoE layer.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import moe_experts_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}  # tests/test_kernels.py

# (label, dtype, T, k, E, D, F, routing): "random" draws each token's k
# distinct experts; "alike" routes every token to experts 0..k-1 and keeps
# the first 8 pairs of each (the capacity at decode)
CASES = [
    ("qwen3-moe B1", torch.bfloat16, 1, 8, 128, 2048, 768, "random"),
    ("qwen3-moe B4", torch.bfloat16, 4, 8, 128, 2048, 768, "random"),
    ("qwen3-moe drops", torch.bfloat16, 12, 8, 128, 2048, 768, "alike"),
    ("mixtral-8x7b B1", torch.bfloat16, 1, 2, 8, 4096, 14336, "random"),
    ("smoke", torch.bfloat16, 3, 2, 8, 128, 64, "random"),
    ("smoke", torch.float32, 3, 2, 8, 128, 64, "random"),
    ("qwen3-moe B1", torch.float32, 1, 8, 128, 2048, 768, "random"),
]


def inputs(gen, dtype, T, k, E, D, F, routing):
    dev = torch.device("cuda")
    x = torch.randn((T, D), generator=gen, device=dev).to(dtype)
    if routing == "alike":
        ids = torch.arange(k, device=dev).repeat(T, 1)
        keep = (torch.arange(T, device=dev) < 8)[:, None].expand(T, k).contiguous()
    else:
        ids = torch.stack([torch.randperm(E, generator=gen, device=dev)[:k]
                           for _ in range(T)])
        keep = torch.ones((T, k), dtype=torch.bool, device=dev)
    w = torch.rand((T, k), generator=gen, device=dev)
    w = w / w.sum(-1, keepdim=True)

    def weights(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev) * fan_in ** -0.5).to(dtype)

    return (x, ids, w, keep, weights((E, D, F), D), weights((E, D, F), D),
            weights((E, F, D), F))


@pytest.mark.parametrize("label, dtype, T, k, E, D, F, routing", CASES,
                         ids=[f"{c[0]}-{str(c[1])[6:]}" for c in CASES])
def test_kernel_matches_plain_version(cuda_device, label, dtype, T, k, E, D, F, routing):
    gen = torch.Generator(device=cuda_device).manual_seed(T * 1000 + E)
    args = inputs(gen, dtype, T, k, E, D, F, routing)
    out = ops.moe_experts(*args)
    ref = moe_experts_ref(*args)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (T, D)
    scale = max(1.0, float(ref.float().abs().max()))
    err = float((out.float() - ref.float()).abs().max())
    assert err <= TOL[dtype] * scale, (label, err, scale)
    assert torch.equal(ops.moe_experts(*args), out)  # fixed order of every sum

    # every expert that no kept pair is routed to may hold anything
    x, ids, w, keep, wg, wu, wd = args
    unread = torch.ones(E, dtype=torch.bool, device=cuda_device)
    unread[ids[keep]] = False
    assert bool(unread.any())
    blind = [t.clone() for t in (wg, wu, wd)]
    for t in blind:
        t[unread] = float("nan")
    assert torch.equal(ops.moe_experts(x, ids, w, keep, *blind), out)


def test_decode_step_graphed_equals_eager_and_counts_launches(cuda_device):
    """qwen3-moe at full width in 2 layers: the prefill launches the kernel
    0 times; 6 paged decode steps (eager, capture, 4 replays) give logits
    bitwise equal to an eager engine's, one launch a MoE layer a step."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=2,
                              vocab_size=4096)
    batch = build_model(cfg).make_batch(torch.Generator().manual_seed(5),
                                        ShapeConfig("card", 512, 1, "prefill"),
                                        device=cuda_device)
    steps = 6
    out = {}
    for route in ("eager", "graphed"):
        eng = Engine(8 << 30, cuda_graphs=route == "graphed", engine_id=route)
        eng.register(cfg.name, cfg)  # the same crc32-seeded weights on both
        eng.load(cfg.name)
        inst = eng.start_instance(cfg.name, num_pages=64)
        before = ops.launch_counts()
        logits = [inst.prefill(batch)]
        torch.cuda.synchronize()
        prefill = {k: n - before[k] for k, n in ops.launch_counts().items()}
        assert prefill == {"paged_attention": 0, "flash_attention": cfg.num_layers,
                           "moe_experts": 0, "rope_kv_write": 0, "add_rms_norm": 0}, prefill
        tok = logits[0].argmax(-1).to(torch.int32)
        per_step = []
        for _ in range(steps):
            before = ops.moe_experts.launches
            logits.append(inst.decode(tok))
            per_step.append(ops.moe_experts.launches - before)
            tok = logits[-1].argmax(-1).to(torch.int32)
        assert per_step == [cfg.num_layers] * steps, per_step
        if route == "graphed":
            g = eng.step_graphs
            assert (g.eager_steps, g.captures, g.replays) == (1, 1, steps - 1)
        inst.finish()
        out[route] = [t.cpu() for t in logits]
        eng.close()
    for i, (e, g) in enumerate(zip(out["eager"], out["graphed"])):
        assert torch.equal(e, g), i
