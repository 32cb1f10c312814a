"""The paged decode step's rope + K/V write kernel (`kernels/rope_kv_write.py`,
CUDA `csrc/rope_kv_write.cu`) on the card.

Every test here is marked `cuda` and skips without a CUDA device; the file
imports neither JAX nor the reference package, so it runs on a GPU machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port/test_torch_rope_kv_write_card.py

- The kernel against its plain version (`ref.rope_kv_write_ref`), to the
  bit, at the served models' decode shapes (deepseek-7b, yi-9b, qwen3-moe,
  codeqwen1.5-7b with its q/k/v bias, qwen2-vl-7b's M-RoPE, llama3.2-1b's
  main path at B 4) and at B 3 with mixed lengths across a page boundary:
  the roped q and both layers' pages whole.
- The wrapper raises on fp32, on a non-contiguous operand, on mis-shaped
  operands and under autograd, and launches nothing then.
- An `Engine` over deepseek-7b and qwen3-moe at full width in 2 layers and
  codeqwen1.5-7b and qwen2-vl-7b at smoke width: the paged decode step,
  eager, captured and replayed, gives logits equal to the bit to those of
  the step as it was before the kernel (`torch_port_helpers.chain_step`,
  eager, its adds and norms by the step's own `ops.add_rms_norm`, so that
  the comparison sees the rope and the K/V write alone), and every step,
  replays included, counts one launch a layer.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import rope_kv_write_ref  # noqa: E402
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

from torch_port_helpers import chain_step  # noqa: E402

pytestmark = pytest.mark.cuda

# (label, B, H, K, hd, lengths, bias, mrope_sections, theta)
CASES = [
    ("deepseek-7b", 1, 32, 32, 128, (272,), False, (), 10_000.0),
    ("yi-9b", 1, 32, 4, 128, (272,), False, (), 5_000_000.0),
    ("qwen3-moe-30b-a3b", 1, 32, 4, 128, (528,), False, (), 1_000_000.0),
    ("codeqwen1.5-7b", 1, 32, 32, 128, (272,), True, (), 1_000_000.0),
    ("codeqwen1.5-7b kv4", 1, 32, 4, 128, (272,), True, (), 1_000_000.0),
    ("qwen2-vl-7b", 1, 28, 4, 128, (528,), False, (16, 24, 24), 1_000_000.0),
    ("llama3.2-1b main", 4, 32, 8, 64, (545, 417, 233, 97), False, (), 500_000.0),
    ("B3 page boundary", 3, 32, 8, 128, (15, 16, 1023), False, (), 10_000.0),
]
T, N = 16, 64


def inputs(B, H, K, hd, lengths, bias, sections, theta, seed=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, n, hd), generator=g, device=dev).to(torch.bfloat16)
               for n in (H, K, K))
    if bias:  # as `_project_qkv` adds it, in bfloat16
        q, k, v = (x + torch.randn(x.shape[1:], generator=g, device=dev).to(torch.bfloat16)
                   for x in (q, k, v))
    P = B * N + 3
    tables = torch.randperm(P, generator=g, device=dev)[: B * N].reshape(B, N).to(torch.int32)
    kp, vp = (torch.randn((P, T, K, hd), generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
    row = tables[torch.arange(B, device=dev), (pos // T).long()].long() * T + (pos % T).long()
    rp = pos[None, :, None].expand(3, B, 1) if sections else pos[:, None]
    cos, sin = (t.reshape(B, hd // 2).contiguous()
                for t in common.rope_table(rp, hd, theta, sections))
    return q, k, v, cos, sin, row, kp, vp


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_equals_plain_version_bitwise(cuda_device, case):
    args = inputs(*case[1:])
    q, k, v, cos, sin, row, kp, vp = args
    kp_ref, vp_ref = kp.clone(), vp.clone()
    want = rope_kv_write_ref(q, k, v, cos, sin, row, kp_ref, vp_ref)
    n0 = ops.rope_kv_write.launches
    got = ops.rope_kv_write(*args)
    torch.cuda.synchronize()
    assert ops.rope_kv_write.launches == n0 + 1
    assert torch.equal(got, want)
    assert torch.equal(kp, kp_ref) and torch.equal(vp, vp_ref)
    # and the inputs are left as they were
    again = inputs(*case[1:])
    assert all(torch.equal(a, b) for a, b in zip(args[:6], again[:6]))


def test_wrapper_raises_on_what_the_kernel_cannot_take(cuda_device):
    q, k, v, cos, sin, row, kp, vp = inputs(*CASES[0][1:])
    good = (q, k, v, cos, sin, row, kp, vp)
    n0 = ops.rope_kv_write.launches
    for i, name in enumerate(("q", "k", "v", "k_pages", "v_pages")):
        j = (0, 1, 2, 6, 7)[i]
        args = list(good)
        args[j] = args[j].float()
        with pytest.raises(TypeError, match=name):
            ops.rope_kv_write(*args)
    args = list(good)
    args[3] = cos.double()
    with pytest.raises(TypeError, match="cos"):
        ops.rope_kv_write(*args)
    args = list(good)
    args[5] = row.int()
    with pytest.raises(TypeError, match="row"):
        ops.rope_kv_write(*args)
    # non-contiguous: a transposed query, a strided page view
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.rope_kv_write(qt, *good[1:])
    kp2 = torch.cat([kp, kp], dim=-1)[..., : kp.shape[-1]]
    with pytest.raises(ValueError, match="contiguous"):
        ops.rope_kv_write(*good[:6], kp2, vp)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.rope_kv_write(q, k[:, :4], *good[2:])
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.rope_kv_write(*good[:3], cos[:, :32], *good[4:])
    with pytest.raises(ValueError, match="on cpu"):
        ops.rope_kv_write(*good[:5], row.cpu(), *good[6:])
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rope_kv_write(q.clone().requires_grad_(True), *good[1:])
    assert ops.rope_kv_write.launches == n0


# (arch, overrides): full width in 2 layers where one card holds it easily
ENGINES = {"deepseek-7b": {"num_layers": 2},
           "qwen3-moe-30b-a3b": {"num_layers": 2, "vocab_size": 4096},
           "codeqwen1.5-7b": "smoke", "qwen2-vl-7b": "smoke"}
STEPS = 12


def engine_run(cfg, graphed, chain, monkeypatch):
    """Prefill 3 prompts of mixed lengths and decode STEPS greedy steps fed
    the same tokens; the logits and each step's launches of the kernel."""
    if chain:
        monkeypatch.setattr(engine_mod, "_paged_decode_step",
                            functools.partial(chain_step, norm=ops.add_rms_norm))
    eng = Engine(8 << 30, cuda_graphs=graphed, engine_id=f"{graphed}-{chain}")
    eng.register(cfg.name, cfg)  # crc32-seeded weights: the same on every engine
    eng.load(cfg.name)
    batch = build_model(cfg).make_batch(torch.Generator().manual_seed(5),
                                        ShapeConfig("card", 40, 3, "prefill"),
                                        device="cuda")
    inst = eng.start_instance(cfg.name, num_pages=64)
    logits = [inst.prefill(batch, lengths=(40, 14, 7))]  # 14 + 2 steps opens a page
    gen = torch.Generator().manual_seed(6)
    per_step = []
    for _ in range(STEPS):
        tok = torch.randint(0, cfg.vocab_size, (3,), generator=gen, dtype=torch.int32).cuda()
        before = ops.rope_kv_write.launches
        logits.append(inst.decode(tok))
        per_step.append(ops.rope_kv_write.launches - before)
    torch.cuda.synchronize()
    counts = None if eng.step_graphs is None else (
        eng.step_graphs.eager_steps, eng.step_graphs.captures, eng.step_graphs.replays)
    inst.finish()
    eng.close()
    if chain:
        monkeypatch.undo()
    return [t.cpu() for t in logits], per_step, counts


@pytest.mark.parametrize("arch", ENGINES)
def test_graphed_step_equals_the_chain_bitwise_one_launch_a_layer(cuda_device, arch,
                                                                  monkeypatch):
    over = ENGINES[arch]
    base = get_config(arch)
    cfg = (dataclasses.replace(base.smoke(), name=arch) if over == "smoke"
           else dataclasses.replace(base, **over))
    want, chain_steps, _ = engine_run(cfg, False, True, monkeypatch)
    assert chain_steps == [0] * STEPS
    eager, eager_steps, _ = engine_run(cfg, False, False, monkeypatch)
    graphed, graphed_steps, counts = engine_run(cfg, True, False, monkeypatch)
    assert counts == (1, 1, STEPS - 1)
    assert eager_steps == graphed_steps == [cfg.num_layers] * STEPS
    for i, (w, e, g) in enumerate(zip(want, eager, graphed)):
        assert torch.equal(e, w), i
        assert torch.equal(g, w), i
