"""Plain float32 reference of the decoder-only LMs the benchmark serves.

Written from the published architecture (a llama-style block: RMSNorm with
a (1 + w) scale, rotary embeddings on the rotate-half convention, causal
grouped-query attention with optional q/k/v biases, SwiGLU or a top-k
mixture of SwiGLU experts), in plain PyTorch: no kernel, no cache, no
batching across requests, and nothing of the program under test.  It reads
the weights the benchmark drew, by their leaf names:

  embed (V, D)                      lm_head (D, V)       final_norm (D,)
  segments/0/0/ln1, ln2 (L, D)
  segments/0/0/attn/wq (L, D, H, hd)   wk, wv (L, D, K, hd)   wo (L, H, hd, D)
  segments/0/0/attn/bq (L, H, hd)      bk, bv (L, K, hd)      (qkv bias only)
  segments/0/0/mlp/wg, wu (L, D, F)    wd (L, F, D)           (dense)
  segments/0/0/mlp/router (L, D, E)    wg, wu (L, E, D, Fe)   wd (L, E, Fe, D)

Departures of the served rendition from the published models, which the
reference implements so that the two compute the same function:

  * no q/k RMSNorm in Qwen3-MoE's attention;
  * experts have a capacity: within one call of the model (the prompt as
    one group, every decoded token as a group of its own) each expert takes
    ceil(T k / E * cf) pairs, rounded up to a multiple of 8 and at least 8,
    with cf 1.25 for the prompt and 4.0 for a decoded token; (token,
    choice) pairs past it are dropped, in token order, choices by falling
    probability;
  * the k routing weights are renormalised to sum to 1 (Qwen3-MoE's
    ``norm_topk_prob``).

`forward` runs layer by layer, moving one layer's weights to the device in
float32 at a time, so a model larger than the free device memory fits.  Under
the precision ``"fp8"`` every matrix product takes its two operands rounded to
float8 e4m3 with one scale a tensor (the control: the same function one
precision step below the configuration's bfloat16).
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch

F32 = torch.float32
PREFIX = "segments/0/0/"
PROMPT_CAPACITY = 1.25
DECODE_CAPACITY = 4.0
FP8_MAX = 448.0  # largest finite float8 e4m3


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to float8 e4m3 under one scale for the tensor."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) at positions 0..S-1, rotate-half convention."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd // 2, dtype=F32, device=x.device) * 2.0 / hd)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv  # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention, q (S, H, hd), k and v (S, K, hd) -> (S, H, hd)."""
    S, H, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(S, K, H // K, hd)
    scores = torch.einsum("skgh,tkh->kgst", qg, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("kgst,tkh->skgh", probs, v).reshape(S, H, hd)


def capacity(tokens: int, k: int, experts: int, factor: float) -> int:
    cap = int(math.ceil(tokens * k / experts * factor))
    return max(8, -(-cap // 8) * 8)


def moe(h: torch.Tensor, w: Mapping[str, torch.Tensor], cfg: Mapping, groups, precision: str
        ) -> torch.Tensor:
    """Top-k mixture of SwiGLU experts over h (S, D) with each group's
    capacity; `groups` lists (start, end, factor) row ranges."""
    E, k = cfg["num_experts"], cfg["experts_per_token"]
    probs = torch.softmax(h @ w["router"], dim=-1)  # the router stays in fp32
    top_w, top_e = torch.topk(probs, k, dim=-1)
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
        x = h[rows]
        g = _mm(x, w["wg"][e], precision)
        u = _mm(x, w["wu"][e], precision)
        out = _mm(torch.nn.functional.silu(g) * u, w["wd"][e], precision)
        y.index_add_(0, rows, out * top_w[rows, cols, None])
    return y


def _layer(w: Mapping[str, torch.Tensor], x: torch.Tensor, cfg: Mapping, groups,
           precision: str) -> torch.Tensor:
    D, H, K = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd, eps = cfg["head_dim"], cfg["norm_eps"]
    S = x.shape[0]
    h = rms_norm(x, w["ln1"], eps)
    q = _mm(h, w["attn/wq"].reshape(D, H * hd), precision).reshape(S, H, hd)
    kk = _mm(h, w["attn/wk"].reshape(D, K * hd), precision).reshape(S, K, hd)
    v = _mm(h, w["attn/wv"].reshape(D, K * hd), precision).reshape(S, K, hd)
    if cfg.get("qkv_bias"):
        q, kk, v = q + w["attn/bq"], kk + w["attn/bk"], v + w["attn/bv"]
    o = attention(rope(q, cfg["rope_theta"]), rope(kk, cfg["rope_theta"]), v)
    x = x + _mm(o.reshape(S, H * hd), w["attn/wo"].reshape(H * hd, D), precision)
    h = rms_norm(x, w["ln2"], eps)
    if cfg.get("num_experts"):
        experts = {n[len("mlp/"):]: t for n, t in w.items() if n.startswith("mlp/")}
        return x + moe(h, experts, cfg, groups, precision)
    g = _mm(h, w["mlp/wg"], precision)
    u = _mm(h, w["mlp/wu"], precision)
    return x + _mm(torch.nn.functional.silu(g) * u, w["mlp/wd"], precision)


def forward(weights: Mapping[str, torch.Tensor], cfg: Mapping,
            seqs: Sequence[tuple[Sequence[int], int, Sequence[int]]], *, device,
            precisions: Sequence[str] = ("fp32",)) -> dict[str, list[torch.Tensor]]:
    """Logits in float32, for each precision and each sequence of `seqs`:
    (tokens, prompt_len, rows) gives one sequence whose first `prompt_len`
    tokens were the prompt (one capacity group) and the rest decoded one at
    a time (a group each); its logits (len(rows), V) are at positions
    `rows`.  One layer's weights cross to the device once for all."""
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
    layer_names = [n for n in weights if n.startswith(PREFIX)]
    for layer in range(cfg["num_layers"]):
        w = {n[len(PREFIX):]: weights[n][layer].to(dev, F32) for n in layer_names}
        for prec in precisions:
            xs[prec] = [_layer(w, x, cfg, g, prec) for x, g in zip(xs[prec], groups)]
        del w
    norm = weights["final_norm"].to(dev, F32)
    head = (embed.T if cfg.get("tie_embeddings") else weights["lm_head"]).to(dev, F32)
    out = {}
    for prec in precisions:
        out[prec] = [_mm(rms_norm(x[list(rows)], norm, cfg["norm_eps"]), head, prec)
                     for x, (_, _, rows) in zip(xs[prec], seqs)]
    return out
