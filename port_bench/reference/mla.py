"""Plain float32 reference of DeepSeek-V2's decoder: multi-head latent
attention (MLA) without q LoRA, YaRN rotary scaling, leading dense layers,
then layers of routed experts beside shared ones.

Written from the published architecture (Hugging Face's
``modeling_deepseek.py`` for DeepSeek-V2-Lite), in plain PyTorch: the
equations as published (un-absorbed), no kernel, no cache, no batching
across requests, and nothing of the program under test.  It reads the
weights the benchmark drew, by their leaf names (segment 0: the leading
dense layers; segment 1: the MoE layers):

  embed (V, D)        lm_head (D, V)        final_norm (D,)
  segments/<s>/0/ln1, ln2 (L_s, D)
  segments/<s>/0/attn/wq (L_s, D, H, dn + dr)   wkv_a (L_s, D, r + dr)
  segments/<s>/0/attn/kv_norm (L_s, r)          wkv_b (L_s, r, H, dn + dv)
  segments/<s>/0/attn/wo (L_s, H, dv, D)
  segments/0/0/mlp/wg, wu (L_0, D, F)   wd (L_0, F, D)
  segments/1/0/mlp/router (L_1, D, E)   wg, wu (L_1, E, D, Fe)   wd (L_1, E, Fe, D)
  segments/1/0/mlp/shared_wg, shared_wu (L_1, D, n Fe)   shared_wd (L_1, n Fe, D)

Per layer, x normed by ln1 (RMSNorm with a (1 + w) scale):

  q = x wq -> [q_nope | q_pe];  [c | k_pe] = x wkv_a;  c = RMSNorm_kv(c), eps 1e-6
  [k_nope | v] = c wkv_b;  q_pe, k_pe roped: their interleaved pairs regrouped
  (the published ``view(d / 2, 2).transpose``), then rotate-half with YaRN's
  frequencies (`yarn_inv_freq`) and cos/sin times mscale(factor, mscale) /
  mscale(factor, mscale_all_dim)
  scores = [q_nope | q_pe] . [k_nope | k_pe] * (dn + dr)^-1/2 * mscale(factor, mscale_all_dim)^2
  o = softmax(causal scores) v;  y = o wo

then the MLP of ln2(x): the dense SwiGLU (segment 0), or a softmax router's
top-k experts, weighted by their softmax probabilities as they are (no
renormalisation; routed scaling factor 1), plus the shared experts' SwiGLU.

Departures of the served rendition from the published model, which the
reference implements so that the two compute the same function:

  * experts have a capacity: within one call of the model (the prompt as
    one group, every decoded token as a group of its own) each expert takes
    ceil(T k / E * cf) pairs, rounded up to a multiple of 8 and at least 8,
    with cf 1.25 for the prompt and 4.0 for a decoded token; (token,
    choice) pairs past it are dropped, in token order, choices by falling
    probability (`reference.lm.capacity`; the published model is dropless).

`forward` keeps `reference.lm.forward`'s contract and layout: layer by
layer, one layer's weights moved to the device in float32 at a time,
attention in blocks of query rows (so that 16k positions fit), and under
the precision ``"fp8"`` every weight product with both operands rounded to
float8 e4m3.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch

from reference.lm import DECODE_CAPACITY, PROMPT_CAPACITY, _mm, capacity, rms_norm

F32 = torch.float32
LATENT_EPS = 1e-6  # the published kv_a_layernorm's eps
QUERY_BLOCK = 512  # query rows of one attention block


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: Mapping, device) -> torch.Tensor:
    """The published ``DeepseekV2YarnRotaryEmbedding`` frequencies (dr / 2,)."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    exps = torch.arange(0, dim, 2, dtype=F32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    if not cfg.get("yarn_factor"):
        return freq_extra
    factor, orig = cfg["yarn_factor"], cfg["yarn_original_max_pos"]
    freq_inter = 1.0 / (factor * base ** exps)

    def corr_dim(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr_dim(cfg["yarn_beta_fast"])), 0)
    high = min(math.ceil(corr_dim(cfg["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=F32, device=device) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def rope(x: torch.Tensor, inv_freq: torch.Tensor, cos_scale: float) -> torch.Tensor:
    """x (S, heads, dr) at positions 0..S-1: pairs regrouped, then rotate-half."""
    S, h, d = x.shape
    x = x.reshape(S, h, d // 2, 2).transpose(-1, -2).reshape(S, h, d)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv_freq  # (S, d/2)
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = (torch.cos(emb) * cos_scale)[:, None, :], (torch.sin(emb) * cos_scale)[:, None, :]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


def softmax_scale(cfg: Mapping) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    if cfg.get("yarn_factor") and cfg.get("yarn_mscale_all_dim"):
        m = yarn_mscale(cfg["yarn_factor"], cfg["yarn_mscale_all_dim"])
        scale = scale * m * m
    return scale


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention, q and k (S, H, dq), v (S, H, dv) -> (S, H, dv), in
    blocks of QUERY_BLOCK query rows over the keys they can see."""
    S = q.shape[0]
    out = []
    for s0 in range(0, S, QUERY_BLOCK):
        s1 = min(S, s0 + QUERY_BLOCK)
        scores = torch.einsum("shd,thd->hst", q[s0:s1], k[:s1]) * scale
        mask = (torch.arange(s1, device=q.device)[None, :]
                <= torch.arange(s0, s1, device=q.device)[:, None])
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("hst,thd->shd", probs, v[:s1]))
    return torch.cat(out, dim=0)


def _attn(w: Mapping[str, torch.Tensor], h: torch.Tensor, cfg: Mapping, precision: str,
          inv_freq: torch.Tensor) -> torch.Tensor:
    D, H, r = cfg["d_model"], cfg["num_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    S = h.shape[0]
    cos_scale = (yarn_mscale(cfg["yarn_factor"], cfg["yarn_mscale"])
                 / yarn_mscale(cfg["yarn_factor"], cfg["yarn_mscale_all_dim"])
                 if cfg.get("yarn_factor") else 1.0)
    q = _mm(h, w["attn/wq"].reshape(D, H * (dn + dr)), precision).reshape(S, H, dn + dr)
    ckv = _mm(h, w["attn/wkv_a"], precision)  # (S, r + dr)
    c = rms_norm(ckv[:, :r], w["attn/kv_norm"], LATENT_EPS)
    k_pe = rope(ckv[:, None, r:], inv_freq, cos_scale)  # (S, 1, dr)
    q_pe = rope(q[..., dn:], inv_freq, cos_scale)
    kv = _mm(c, w["attn/wkv_b"].reshape(r, H * (dn + dv)), precision).reshape(S, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(S, H, dr)], dim=-1)
    o = attention(torch.cat([q[..., :dn], q_pe], dim=-1), k, kv[..., dn:], softmax_scale(cfg))
    return _mm(o.reshape(S, H * dv), w["attn/wo"].reshape(H * dv, D), precision)


def _swiglu(x, wg, wu, wd, precision):
    g = _mm(x, wg, precision)
    u = _mm(x, wu, precision)
    return _mm(torch.nn.functional.silu(g) * u, wd, precision)


def moe(h: torch.Tensor, w: Mapping[str, torch.Tensor], cfg: Mapping, groups, precision: str
        ) -> torch.Tensor:
    """Routed experts (softmax router, top-k, weights not renormalised, each
    group's capacity; `groups` lists (start, end, factor) row ranges) plus
    the shared experts."""
    E, k = cfg["num_experts"], cfg["experts_per_token"]
    probs = torch.softmax(h @ w["router"], dim=-1)  # the router stays in fp32
    top_w, top_e = torch.topk(probs, k, dim=-1)
    if cfg.get("norm_topk_prob", True):
        top_w = top_w / top_w.sum(-1, keepdim=True)
    keep = torch.zeros_like(top_w, dtype=torch.bool)
    for start, end, factor in groups:
        cap = capacity(end - start, k, E, factor)
        flat = top_e[start:end].reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, E)
        slot = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
        keep[start:end] = (slot < cap).reshape(end - start, k)
    y = torch.zeros_like(h)
    for e in torch.unique(top_e[keep]).tolist():
        rows, cols = torch.nonzero((top_e == e) & keep, as_tuple=True)
        out = _swiglu(h[rows], w["wg"][e], w["wu"][e], w["wd"][e], precision)
        y.index_add_(0, rows, out * top_w[rows, cols, None])
    if "shared_wg" in w:
        y = y + _swiglu(h, w["shared_wg"], w["shared_wu"], w["shared_wd"], precision)
    return y


def _layer(w: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: Mapping, groups,
           precision: str, inv_freq: torch.Tensor) -> torch.Tensor:
    eps = cfg["norm_eps"]
    x = x + _attn(w, rms_norm(x, w["ln1"], eps), cfg, precision, inv_freq)
    h = rms_norm(x, w["ln2"], eps)
    if "mlp/router" in w:
        experts = {n[len("mlp/"):]: t for n, t in w.items() if n.startswith("mlp/")}
        return x + moe(h, experts, cfg, groups, precision)
    return x + _swiglu(h, w["mlp/wg"], w["mlp/wu"], w["mlp/wd"], precision)


def forward(weights: Mapping[str, torch.Tensor], cfg: Mapping,
            seqs: Sequence[tuple[Sequence[int], int, Sequence[int]]], *, device,
            precisions: Sequence[str] = ("fp32",)) -> dict[str, list[torch.Tensor]]:
    """Logits in float32, for each precision and each sequence of `seqs`, as
    `reference.lm.forward` gives them: (tokens, prompt_len, rows) gives one
    sequence whose first `prompt_len` tokens were the prompt (one capacity
    group) and the rest decoded one at a time (a group each); its logits
    (len(rows), V) are at positions `rows`."""
    assert set(precisions) <= {"fp32", "fp8"}
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    groups, xs = [], {}
    for tokens, prompt_len, _ in seqs:
        groups.append([(0, prompt_len, PROMPT_CAPACITY)] + [
            (p, p + 1, DECODE_CAPACITY) for p in range(prompt_len, len(tokens))])
    embed = weights["embed"]
    for prec in precisions:
        xs[prec] = [embed[torch.as_tensor(list(t), dtype=torch.long)].to(dev, F32)
                    for t, _, _ in seqs]
    inv_freq = yarn_inv_freq(cfg, dev)
    segments = sorted({n.split("/")[1] for n in weights if n.startswith("segments/")}, key=int)
    for s in segments:
        prefix = f"segments/{s}/0/"
        names = [n for n in weights if n.startswith(prefix)]
        for layer in range(weights[prefix + "ln1"].shape[0]):
            w = {n[len(prefix):]: weights[n][layer].to(dev, F32) for n in names}
            for prec in precisions:
                xs[prec] = [_layer(w, x, cfg, g, prec, inv_freq) for x, g in zip(xs[prec], groups)]
            del w
    norm = weights["final_norm"].to(dev, F32)
    head = (embed.T if cfg.get("tie_embeddings") else weights["lm_head"]).to(dev, F32)
    out = {}
    for prec in precisions:
        out[prec] = [_mm(rms_norm(x[list(rows)], norm, cfg["norm_eps"]), head, prec)
                     for x, (_, _, rows) in zip(xs[prec], seqs)]
    return out
