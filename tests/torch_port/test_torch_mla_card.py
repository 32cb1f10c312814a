"""DeepSeek-V2-Lite's kernels and decode step on the card: K1's latent mode
(`kernels.paged_latent_attention`, `csrc/paged_attention.cu`) and K2 at
split q/k and v widths (`kernels.flash_attention`, `csrc/flash_attention.cu`).

Every test here is marked `cuda` and skips without a CUDA device; the file
imports neither JAX nor the reference package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/torch_port/test_torch_mla_card.py

- K1 latent at the benchmark cell's shape (B 1, 16 heads, one 576-wide
  latent head, V its first 512 columns, 16,448 tokens in a table of 2048
  pages of 16) and at short, several-sequence and empty lengths, against
  its plain version and against SDPA over the pre-gathered rows, bf16
  within 2e-2 of the output's scale (the tolerance of every bf16 kernel
  here, tests/test_kernels.py); bitwise repeatable.
- K2 at (192, 128) at S 16,384 (16 heads) against SDPA and, on three
  blocks of query rows, against the plain formula; at S 2,048 against the
  plain version whole.
- The counters: one latent launch a layer a decode step, one split-width
  launch a layer a prefill.
- DeepSeek-V2-Lite at full width in 3 layers (the dense layer and two MoE
  layers) on an `Engine`: a 1,100-token prompt widens the block table to
  128; 6 paged decode steps (eager, capture, 4 replays, the replays under
  ``torch.cuda.set_sync_debug_mode("error")``) give logits bitwise equal to
  an eager engine's.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
F = pytest.importorskip("torch.nn.functional")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref, paged_latent_attention_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 2e-2  # bfloat16 kernels against float32-accumulating plain versions
W, V, T = 576, 512, 16
SCALE = layers.mla_softmax_scale(get_config("deepseek-v2-lite"))


def latent_inputs(gen, B, H, N, lengths):
    dev = torch.device("cuda")
    P = B * N + 3
    q = torch.randn((B, H, W), generator=gen, device=dev).to(torch.bfloat16)
    pages = torch.randn((P, T, 1, W), generator=gen, device=dev).to(torch.bfloat16)
    tables = torch.randperm(P, generator=gen, device=dev)[: B * N].reshape(B, N).to(torch.int32)
    return q, pages, tables, torch.tensor(lengths, dtype=torch.int32, device=dev)


def close(out, want):
    scale = max(1.0, float(want.float().abs().max()))
    return float((out.float() - want.float()).abs().max()) <= TOL * scale


# (label, B, H, table pages, lengths): the cell's shape, a one-split length,
# rows past 16 and under 16, several sequences and an empty one
LATENT = [("cell", 1, 16, 2048, [16448]), ("short", 1, 16, 2048, [37]),
          ("64 pages", 1, 16, 64, [1000]), ("B3", 3, 16, 256, [4096, 1, 2500]),
          ("H4", 2, 4, 128, [700, 2048]), ("H20", 1, 20, 128, [1500]),
          ("empty", 2, 16, 64, [0, 300])]


@pytest.mark.parametrize("label,B,H,N,lengths", LATENT, ids=[c[0] for c in LATENT])
def test_latent_matches_plain_version_and_sdpa(cuda_device, label, B, H, N, lengths):
    gen = torch.Generator(device=cuda_device).manual_seed(B * 100 + N)
    q, pages, tables, lens = latent_inputs(gen, B, H, N, lengths)
    out = ops.paged_latent_attention(q, pages, tables, lens, v_dim=V, scale=SCALE)
    want = paged_latent_attention_ref(q, pages, tables, lens, v_dim=V, scale=SCALE)
    torch.cuda.synchronize()
    assert out.shape == (B, H, V) and out.dtype == torch.bfloat16
    assert close(out, want), label
    assert torch.equal(ops.paged_latent_attention(q, pages, tables, lens, v_dim=V, scale=SCALE),
                       out)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not out[b].any()
            continue
        rows = pages[tables[b].long()].reshape(-1, W)[:n]  # pre-gathered
        sdpa = F.scaled_dot_product_attention(q[b][None, None], rows[None, None],
                                              rows[None, None, :, :V], scale=SCALE)[0, 0]
        assert close(out[b], sdpa), (label, b)


def plain_rows(q, k, v, scale, rows):
    """Causal attention of query rows `rows` in float32 (the plain version's
    formula, on a slice of its queries)."""
    qs = q[0, rows].float()  # (R, H, d)
    end = rows.stop
    s = torch.einsum("rhd,thd->hrt", qs, k[0, :end].float()) * scale
    mask = torch.arange(end, device=q.device)[None] <= torch.arange(rows.start, end,
                                                                    device=q.device)[:, None]
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return torch.einsum("hrt,thd->rhd", p.to(torch.bfloat16).float(), v[0, :end].float())


@pytest.mark.parametrize("S", [2048, 16384])
def test_split_widths_match_plain_version_and_sdpa(cuda_device, S):
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    H = 16
    q, k = (torch.randn((1, S, H, 192), generator=gen, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randn((1, S, H, 128), generator=gen, device=cuda_device).to(torch.bfloat16)
    out = ops.flash_attention(q, k, v, causal=True, scale=SCALE)
    torch.cuda.synchronize()
    assert out.shape == (1, S, H, 128)
    sdpa = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          is_causal=True, scale=SCALE).transpose(1, 2)
    assert close(out, sdpa)
    if S <= 2048:
        assert close(out, flash_attention_ref(q, k, v, causal=True, scale=SCALE))
    for rows in (slice(0, 64), slice(S // 2 - 37, S // 2 + 27), slice(S - 64, S)):
        assert close(out[0, rows], plain_rows(q, k, v, SCALE, rows)), rows
    assert torch.equal(ops.flash_attention(q, k, v, causal=True, scale=SCALE), out)


def small_dsv2():
    return dataclasses.replace(get_config("deepseek-v2-lite"), num_layers=3)


def test_graphed_step_replays_bitwise_and_counts_launches(cuda_device):
    cfg = small_dsv2()
    prompt = torch.randint(0, cfg.vocab_size, (1, 1100), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32).to(cuda_device)
    steps = 6
    out = {}
    for route in ("eager", "graphed"):
        eng = Engine(12 << 30, cuda_graphs=route == "graphed", engine_id=route)
        eng.register(cfg.name, cfg)  # the same crc32-seeded weights on both
        eng.load(cfg.name)
        inst = eng.start_instance(cfg.name, num_pages=64)
        ops.reset_launch_counts()
        logits = [inst.prefill({"tokens": prompt})]
        torch.cuda.synchronize()
        assert ops.launch_counts()["paged_attention"] == 0
        assert ops.mode_counts() == {"paged_attention.latent": 0,
                                     "flash_attention.split": cfg.num_layers}
        assert inst._tables_np.shape[1] == 128  # 69 blocks: the table widened
        tok = logits[0].argmax(-1).to(torch.int32)
        per_step = []
        for i in range(steps):
            before = ops.mode_counts()["paged_attention.latent"]
            if route == "graphed" and i >= 2:  # replays read nothing back from the device
                torch.cuda.set_sync_debug_mode("error")
            try:
                logits.append(inst.decode(tok))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            per_step.append(ops.mode_counts()["paged_attention.latent"] - before)
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
    assert math.isfinite(float(out["eager"][-1].float().abs().max()))
