"""The paged decode step's rope + K/V write (`kernels/rope_kv_write.py`) on
the CPU, where the wrapper runs its plain version.

Each case is held, to the bit, against the chain the step ran before the
kernel existed (`torch_port_helpers.chain_apply_rope`, `apply_rope` as it
was, on q and on k at the step's positions, then one `index_copy_` of the
roped k and one of v into the layer's pages).  The engine's paged decode
logits are held the same way, against that earlier step
(`torch_port_helpers.chain_step`); a latent-attention model's, against its
step as it was before the two formats shared one layer loop
(`torch_port_helpers.chain_mla_step`).
"""
import dataclasses

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model, common  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

from torch_port_helpers import chain_apply_rope, chain_step  # noqa: E402


# ------------------------------------------------------------ the plain version
def step_inputs(B, H, K, hd, lengths, bias, T=16, pages=12, seed=0, dtype=torch.bfloat16):
    """One layer's q/k/v (B, 1, heads, hd) as a projection makes them, with
    a bias added where `bias`; a shuffled block table; the pages; each
    sequence's row for its position `lengths`."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((B, 1, n, hd), generator=g).to(dtype) for n in (H, K, K))
    if bias:
        q, k, v = (x + torch.randn(x.shape[2:], generator=g).to(dtype) for x in (q, k, v))
    tables = torch.randperm(pages, generator=g)[: B * 4].reshape(B, 4).to(torch.int32)
    kp, vp = (torch.randn((pages, T, K, hd), generator=g).to(dtype) for _ in range(2))
    pos = torch.tensor(lengths, dtype=torch.int32)
    row = tables[torch.arange(B), (pos // T).long()].long() * T + (pos % T).long()
    return q, k, v, kp, vp, pos, row


CASES = {  # (B, H, K, hd, lengths, bias, mrope_sections)
    "G1": (1, 4, 4, 32, (20,), False, ()),
    "G8": (1, 8, 1, 64, (37,), False, ()),
    "bias": (2, 8, 1, 32, (5, 50), True, ()),
    "mrope": (2, 4, 2, 32, (9, 31), False, (8, 4, 4)),
    # mixed lengths; 16 is the first row of a sequence's second page
    "B3-page-boundary": (3, 4, 2, 32, (15, 16, 33), False, ()),
}


@pytest.mark.parametrize("case", CASES)
def test_plain_version_equals_the_chain_bitwise(case):
    B, H, K, hd, lengths, bias, sections = CASES[case]
    q, k, v, kp, vp, pos, row = step_inputs(B, H, K, hd, lengths, bias)
    rp = pos[None, :, None].expand(3, B, 1) if sections else pos[:, None]
    P, T = kp.shape[:2]
    # the chain
    kp0, vp0 = kp.clone(), vp.clone()
    q0 = chain_apply_rope(q, rp, 10_000.0, sections)[:, 0]
    kp0.view(P * T, K, hd).index_copy_(0, row, chain_apply_rope(k, rp, 10_000.0, sections)[:, 0])
    vp0.view(P * T, K, hd).index_copy_(0, row, v[:, 0])
    # the wrapper over the step's table
    cos, sin = (t.reshape(B, hd // 2).contiguous()
                for t in common.rope_table(rp, hd, 10_000.0, sections))
    out = ops.rope_kv_write(q[:, 0], k[:, 0], v[:, 0], cos, sin, row, kp, vp)
    assert torch.equal(out, q0)
    assert torch.equal(kp, kp0) and torch.equal(vp, vp0)
    # only the sequences' rows changed
    changed = (kp0 != step_inputs(B, H, K, hd, lengths, bias)[3]).flatten(2).any(-1)
    assert set(torch.nonzero(changed.reshape(-1)).flatten().tolist()) <= set(row.tolist())


@pytest.mark.parametrize("sections", [(), (8, 4, 4)])
def test_one_table_a_step_equals_apply_rope_in_every_layer(sections):
    """The step builds its table once; every layer's q and k roped by it
    equal that layer's own `apply_rope`, as the chain computed it."""
    g = torch.Generator().manual_seed(3)
    B, hd = 3, 32
    pos = torch.tensor([0, 17, 4095], dtype=torch.int32)
    rp = pos[None, :, None].expand(3, B, 1) if sections else pos[:, None]
    table = common.rope_table(rp, hd, 1_000_000.0, sections)
    for layer in range(4):
        for heads in (4, 1):
            x = torch.randn((B, 1, heads, hd), generator=g).to(torch.bfloat16)
            want = chain_apply_rope(x, rp, 1_000_000.0, sections)
            assert torch.equal(common.rope_apply(x, table), want), (layer, heads)
            assert torch.equal(common.apply_rope(x, rp, 1_000_000.0, sections), want)


def test_prefill_shapes_rope_as_the_chain():
    """`apply_rope` over a prompt's (B, S) positions, and M-RoPE's (3, B, S)
    streams that differ, is the chain's to the bit."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 24, 4, 32), generator=g).to(torch.bfloat16)
    pos = torch.arange(24, dtype=torch.int32)[None].expand(2, 24)
    assert torch.equal(common.apply_rope(x, pos, 10_000.0), chain_apply_rope(x, pos, 10_000.0))
    mpos = torch.randint(0, 64, (3, 2, 24), generator=g, dtype=torch.int32)
    assert torch.equal(common.apply_rope(x, mpos, 10_000.0, (8, 4, 4)),
                       chain_apply_rope(x, mpos, 10_000.0, (8, 4, 4)))


def test_wrapper_rejects_mis_shaped_inputs():
    q, k, v, kp, vp, pos, row = step_inputs(2, 4, 2, 32, (3, 40), False)
    cos, sin = (t.reshape(2, 16).contiguous()
                for t in common.rope_table(pos[:, None], 32, 10_000.0))
    good = (q[:, 0], k[:, 0], v[:, 0], cos, sin, row, kp, vp)
    bad = {"q 4-d": (q, *good[1:]),
           "k heads": (good[0], k[:, 0, :1], *good[2:]),
           "v width": (*good[:2], v[:, 0, :, :16], *good[3:]),
           "cos width": (*good[:3], cos[:, :8], *good[4:]),
           "row batch": (*good[:5], row[:1], *good[6:]),
           "v_pages": (*good[:7], vp[:, :, :1]),
           "k_pages 3-d": (*good[:6], kp[0], vp)}
    for what, args in bad.items():
        with pytest.raises(ValueError, match="shape mismatch"):
            ops.rope_kv_write(*args)
            pytest.fail(f"took {what}")


# ------------------------------------------------------------ the engine
TINY = {"deepseek-7b": {}, "qwen3-moe-30b-a3b": {}, "codeqwen1.5-7b": {},
        "yi-9b": {"num_kv_heads": 1}, "qwen2-vl-7b": {}, "deepseek-v2-lite": {}}


def decode_logits(cfg, monkeypatch=None, steps=20):
    """Prefill three prompts of mixed lengths and decode `steps` greedy steps
    on a CPU engine; every logit.  With `monkeypatch`, the step is the chain."""
    if monkeypatch is not None:
        monkeypatch.setattr(engine_mod, "_paged_decode_step", chain_step)
    eng = Engine(256 << 20, device="cpu")
    eng.register(cfg.name, cfg)
    eng.load(cfg.name)
    batch = build_model(cfg).make_batch(torch.Generator().manual_seed(9),
                                        ShapeConfig("t", 30, 3, "prefill"), device="cpu")
    inst = eng.start_instance(cfg.name, num_pages=64)
    out = [inst.prefill(batch, lengths=(30, 14, 5))]  # 14 + 2 steps crosses a page
    for _ in range(steps):
        out.append(inst.decode(out[-1].argmax(-1).to(torch.int32)))
    inst.finish()
    eng.close()
    if monkeypatch is not None:
        monkeypatch.undo()
    return out


@pytest.mark.parametrize("arch", TINY)
def test_engine_paged_decode_logits_equal_the_chain_bitwise(arch, monkeypatch):
    cfg = dataclasses.replace(get_config(arch).smoke(), name=arch, **TINY[arch])
    if arch == "codeqwen1.5-7b":
        assert cfg.qkv_bias
    ops.reset_launch_counts()
    got = decode_logits(cfg)
    want = decode_logits(cfg, monkeypatch)
    assert len(got) == len(want) == 21
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), i
    assert ops.launch_counts()["rope_kv_write"] == 0  # CPU: the plain version
