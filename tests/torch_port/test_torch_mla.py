"""DeepSeek-V2-Lite's pieces in the port, on the CPU: multi-head latent
attention (the prefill as published, the decode step absorbed), YaRN,
routing without renormalisation, shared experts beside the routed ones, a
leading dense layer, the latent page slab and block tables that grow past
`max_blocks_per_seq`.

The engine is held against the benchmark's plain float32 reference
(`port_bench/reference/mla.py`, which imports nothing of the program) at
`smoke()` size in float32 on seeded random weights, drawn as the
benchmark's configuration draws them.  Tolerances, each with its reason:

  * 1e-4 of the logits' scale between two float32 computations of one
    function that differ in the order of their sums (the engine's absorbed
    decode against the reference's un-absorbed equations; a layer's
    products of widths up to 256): float32 rounding is ~1e-7 a step, and a
    wrong mask, position or weight moves logits by a few percent;
  * 1e-5 of the output's scale between a kernel's plain version and dense
    attention over the same rows: the same products in float32 in another
    order.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import all_configs, get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref, paged_latent_attention_ref
from repro_torch.models import build_model, common, layers, lm
from repro_torch.models.tensors import spec_records
from repro_torch.serving.engine import Engine, _table_width

BENCH = Path(__file__).resolve().parents[2] / "port_bench"
sys.path.insert(0, str(BENCH))

from pbench import cell  # noqa: E402
from pbench.weights import draw  # noqa: E402
from reference import mla as ref  # noqa: E402

NAME = "deepseek-v2-lite"
DRAW = {"fan_in": {"wkv_b": "kv_lora_rank", "wo": ["num_heads", "v_head_dim"],
                   "shared_wd": ["num_shared_experts", "moe_d_ff"]},
        "norms": ["kv_norm"]}
PROMPT, STEPS = 64, 6
REL = 1e-4  # float32 logits of one function summed in another order (module docstring)


def smoke_cfg():
    return dataclasses.replace(get_config(NAME).smoke(), dtype="float32")


def weights(cfg, seed=2**33 + 29):
    return draw(cfg, seed, "cpu", DRAW)


def prompt_of(cfg, n=PROMPT, seed=5):
    return torch.randint(0, cfg.vocab_size, (1, n), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


def serve(cfg, tree, prompt, steps=STEPS):
    """(logits at each served position, the tokens served, the instance's
    table widths after prefill and at the end) through a CPU engine."""
    eng = Engine(1 << 30, device="cpu")
    eng.register(cfg.name, cfg, init_fn=lambda: tree)
    eng.load(cfg.name)
    inst = eng.start_instance(cfg.name)
    logits = [inst.prefill({"tokens": prompt})[0]]
    widths = [inst._tables_np.shape[1]]
    toks = [int(logits[-1].argmax())]
    for _ in range(steps):
        logits.append(inst.decode(torch.tensor([toks[-1]], dtype=torch.int32))[0])
        toks.append(int(logits[-1].argmax()))
    widths.append(inst._tables_np.shape[1])
    inst.finish()
    eng.close()
    return torch.stack(logits), toks, widths


def reference(cfg, flat, prompt, toks, precisions=("fp32",)):
    S = prompt.shape[1]
    seq = prompt[0].tolist() + toks[:-1]
    out = ref.forward(flat, cell._port_dict(cfg), [(seq, S, list(range(S - 1, len(seq))))],
                      device="cpu", precisions=precisions)
    return {p: xs[0] for p, xs in out.items()}


def test_registered_port_only():
    cfg = get_config(NAME)
    assert NAME not in all_configs()  # the reference's set of architectures stays as it is
    assert cfg.is_mla and cfg.segments == ((("attn",), 1), (("attn",), 26))
    assert [cfg.segment_is_moe(i) for i in range(2)] == [False, True]


def test_kv_bytes_and_param_count_at_published_widths():
    cfg = get_config(NAME)
    assert cfg.kv_bytes_per_token() == 576 * 2 * 27 == 31_104
    records = spec_records(NAME, cfg)  # meta tensors: nothing allocated
    assert sum(math.prod(r.shape) for r in records) == cfg.param_count() == 15_706_484_224
    for other in ("qwen3-moe-30b-a3b", "deepseek-7b"):  # the llama block's rule is unchanged
        c = get_config(other)
        assert c.kv_bytes_per_token() == 2 * c.num_kv_heads * c.resolved_head_dim * 2 * c.num_layers


def test_yarn_against_the_published_formulas():
    """Inverse frequencies, the cos/sin factor and the softmax scale at the
    published settings, from the formulas of `modeling_deepseek.py` in
    float64 here."""
    cfg = get_config(NAME)
    dim, base, factor, orig = 64, 10000.0, 40.0, 4096

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low, high = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), dim - 1)
    assert (low, high) == (10, 23)
    i = np.arange(dim // 2)
    extra = 1.0 / base ** (2 * i / dim)
    inter = extra / factor
    mask = 1.0 - np.clip((i - low) / (high - low), 0, 1)
    want = inter * (1 - mask) + extra * mask
    got = common.yarn_freqs(dim, cfg, "cpu").double().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7)  # float32 against float64
    assert common.yarn_rope_scale(cfg) == 1.0  # mscale == mscale_all_dim
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(layers.mla_softmax_scale(cfg) - 192 ** -0.5 * m * m) < 1e-12
    np.testing.assert_allclose(ref.yarn_inv_freq(cell._port_dict(cfg), "cpu").double().numpy(),
                               want, rtol=2e-7)


def test_route_without_renormalisation():
    gen = torch.Generator().manual_seed(3)
    x, router = torch.randn(5, 16, generator=gen), torch.randn(16, 8, generator=gen)
    probs = torch.softmax(x @ router, -1)
    w, idx = layers.route(x, router, 3, norm=False)
    assert torch.equal(w, torch.topk(probs, 3, -1).values) and float(w.sum(-1).max()) < 1
    wn, idxn = layers.route(x, router, 3)  # qwen3-moe's rule, the default
    assert torch.equal(idxn, idx)
    top = torch.topk(probs, 3, -1).values
    assert torch.equal(wn, top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9))
    assert get_config("qwen3-moe-30b-a3b").norm_topk_prob and not get_config(NAME).norm_topk_prob


def test_engine_serves_the_references_logits():
    """Prefill (un-absorbed, the flash kernel's plain version at q/k 48 and
    v 32) and six paged decode steps (absorbed, K1's latent plain version)
    give the reference's logits; the float8 reference does not."""
    cfg = smoke_cfg()
    tree, flat = weights(cfg)
    for name in [n for n in flat if n.rsplit("/", 1)[-1] == "router"]:
        flat[name][..., :2] *= 6.0  # two experts take most tokens: the prompt overflows them
    prompt = prompt_of(cfg)
    got, toks, _ = serve(cfg, tree, prompt)
    want = reference(cfg, flat, prompt, toks, ("fp32", "fp8"))
    scale = float(want["fp32"].abs().max())
    assert float((got - want["fp32"]).abs().max()) <= REL * scale
    assert float((want["fp8"] - want["fp32"]).abs().max()) > 1e2 * REL * scale


def test_shared_experts_and_dense_layer_count():
    """Without the shared experts, or without layer 0's dense MLP, the
    reference leaves the engine: both are on the path."""
    cfg = smoke_cfg()
    tree, flat = weights(cfg)
    prompt = prompt_of(cfg)
    got, toks, _ = serve(cfg, tree, prompt, steps=2)
    scale = float(got.abs().max())
    no_shared = {k: (torch.zeros_like(v) if "shared_wd" in k else v) for k, v in flat.items()}
    assert float((reference(cfg, no_shared, prompt, toks)["fp32"] - got).abs().max()) > 1e-2 * scale
    no_dense = {k: (torch.zeros_like(v) if k == "segments/0/0/mlp/wd" else v)
                for k, v in flat.items()}
    assert float((reference(cfg, no_dense, prompt, toks)["fp32"] - got).abs().max()) > 1e-2 * scale


def test_absorbed_decode_equals_the_unabsorbed_forward():
    """`lm.decode_step` over the latent ring (absorbed) gives the logits of
    the full-sequence forward (the equations as published) at every
    decoded position; no expert is ever full (a decoded token is a capacity
    group of its own, so only a dropless forward computes what the steps
    do)."""
    cfg = smoke_cfg()
    tree, _ = weights(cfg)
    model = build_model(cfg)
    tokens = prompt_of(cfg, 40, seed=11)
    S0 = 32
    dropless = 100.0
    with torch.no_grad():
        full, _ = lm.forward(tree, cfg, tokens, remat=False, moe_capacity_factor=dropless)
        _, cache = lm.forward(tree, cfg, tokens[:, :S0], make_cache=True, cache_cap=64,
                              remat=False, moe_capacity_factor=dropless)
        for p in range(S0, tokens.shape[1]):
            logits, cache = model.decode(tree, tokens[:, p], torch.tensor([p], dtype=torch.int32),
                                         cache)
            scale = float(full[0, p].abs().max())
            assert float((logits[0] - full[0, p]).abs().max()) <= REL * scale, p


def test_latent_plain_version_is_dense_attention():
    gen = torch.Generator().manual_seed(7)
    B, H, W, V, T, N, P = 2, 16, 80, 64, 16, 6, 15
    q = torch.randn(B, H, W, generator=gen)
    pages = torch.randn(P, T, 1, W, generator=gen)
    tables = torch.randperm(P, generator=gen)[: B * N].reshape(B, N).to(torch.int32)
    lengths = torch.tensor([85, 3], dtype=torch.int32)
    out = paged_latent_attention_ref(q, pages, tables, lengths, v_dim=V, scale=0.37)
    assert out.shape == (B, H, V)
    for b in range(B):
        rows = pages[tables[b].long()].reshape(N * T, W)[: int(lengths[b])]
        want = common.attention_dense(q[b][None, None], rows[None, :, None],
                                      rows[None, :, None, :V], causal=False, scale=0.37)[0, 0]
        assert float((out[b] - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(ops.paged_latent_attention(q, pages, tables, lengths, v_dim=V, scale=0.37),
                       out)  # CPU tensors: the plain version


def test_split_width_plain_version_is_dense_attention():
    gen = torch.Generator().manual_seed(8)
    q, k = torch.randn(1, 40, 4, 48, generator=gen), torch.randn(1, 40, 4, 48, generator=gen)
    v = torch.randn(1, 40, 4, 32, generator=gen)
    out = flash_attention_ref(q, k, v, causal=True, scale=0.3)
    want = common.attention_dense(q, k, v, causal=True, scale=0.3)
    assert out.shape == (1, 40, 4, 32)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(ops.flash_attention(q, k, v, causal=True, scale=0.3), out)


@pytest.mark.parametrize("prompt,width_after_prefill,width_at_end",
                         [(1000, 64, 64), (1100, 128, 128), (1024, 64, 128)])
def test_block_tables_grow_past_max_blocks(prompt, width_after_prefill, width_at_end):
    """A prompt that fits in 64 blocks of 16 keeps the table 64 wide (K1's
    split plan and the step's shapes as before); one that needs more
    widens it to a power-of-two multiple of 64, and a decode that crosses
    the width widens it then."""
    assert [_table_width(64, n) for n in (1, 64, 65, 128, 1028)] == [64, 64, 128, 128, 2048]
    cfg = dataclasses.replace(smoke_cfg(), num_layers=2)
    tree, _ = weights(cfg)
    prompt_t = prompt_of(cfg, prompt)
    got, _, widths = serve(cfg, tree, prompt_t, steps=3)
    assert widths == [width_after_prefill, width_at_end]
    assert torch.isfinite(got).all()
