"""Plain PyTorch versions of the kernels (port of `repro/kernels/ref.py`,
and `moe_experts_ref`, `rope_kv_write_ref` and `add_rms_norm_ref`, which
have no reference kernel).

`paged_attention_ref` / `flash_attention_ref` / `moe_experts_ref` /
`rope_kv_write_ref` / `add_rms_norm_ref` define what the CUDA kernels
compute, run for CPU tensors, and are what the kernels are held against on
the card.  Same casts as the reference oracles: scores in fp32,
probabilities cast to q.dtype before the V product; the experts round where
the slot dispatch (`models.layers.moe_forward`) rounds; the rotary
embedding rounds as `models.common.rope_apply` does; the norm is
`models.common.rms_norm`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import rms_norm

F32 = torch.float32


def _softmax_zero_masked(s: torch.Tensor) -> torch.Tensor:
    p = torch.softmax(s, dim=-1)
    return torch.nan_to_num(p, nan=0.0)  # fully-masked rows -> 0


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths):
    """Decode attention over paged KV.

    q:            (B, H, hd)        one query token per sequence
    k/v_pages:    (P, T, K, hd)     paged KV slab of one layer (block size T)
    block_tables: (B, N) int32      physical block ids per sequence
    lengths:      (B,) int32        context length (tokens) per sequence
    Returns (B, H, hd).
    """
    B, H, hd = q.shape
    P, T, K, _ = k_pages.shape
    N = block_tables.shape[1]
    G = H // K

    idx = block_tables.long()
    k = k_pages[idx].reshape(B, N * T, K, hd)  # (B, N*T, K, hd)
    v = v_pages[idx].reshape(B, N * T, K, hd)

    qq = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,btkh->bkgt", qq.to(F32), k.to(F32))
    s = s * (1.0 / math.sqrt(hd))
    pos = torch.arange(N * T, device=q.device)[None, None, None, :]
    mask = pos < lengths.to(q.device)[:, None, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    p = _softmax_zero_masked(s)
    o = torch.einsum("bkgt,btkh->bkgh", p.to(q.dtype), v)
    return o.reshape(B, H, hd)


def paged_latent_attention_ref(q, pages, block_tables, lengths, *, v_dim: int,
                               scale: float):
    """Latent-mode decode attention over paged latent rows (absorbed MLA).

    q:            (B, H, W)         the absorbed queries [q_lat | q_pe]
    pages:        (P, T, 1, W)      one layer's latent rows [c | k_pe]: K, and
                                    their first `v_dim` columns V
    block_tables: (B, N) int32      physical block ids per sequence
    lengths:      (B,) int32        context length (tokens) per sequence
    Scores at `scale`.  Returns (B, H, v_dim).
    """
    B, H, W = q.shape
    P, T, _, _ = pages.shape
    N = block_tables.shape[1]
    rows = pages[block_tables.long()].reshape(B, N * T, W)
    s = torch.einsum("bhw,btw->bht", q.to(F32), rows.to(F32)) * scale
    pos = torch.arange(N * T, device=q.device)[None, None, :]
    s = s.masked_fill(~(pos < lengths.to(q.device)[:, None, None]), float("-inf"))
    p = _softmax_zero_masked(s)
    return torch.einsum("bht,btv->bhv", p.to(q.dtype), rows[..., :v_dim])


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """Full-sequence attention with causal + sliding-window masking.

    q: (B, S, H, hd); k: (B, S, K, hd); v: (B, S, K, hv) (GQA: H = K * G; hv
    is hd but for latent attention's prefill).  `scale` defaults to
    1/sqrt(hd).  Returns (B, S, H, hv).
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qq = q.reshape(B, S, K, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qq.to(F32), k.to(F32))
    s = s * (1.0 / math.sqrt(hd) if scale is None else scale)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    s = s.masked_fill(~mask, float("-inf"))
    p = _softmax_zero_masked(s)
    o = torch.einsum("bkgst,btkh->bskgh", p.to(q.dtype), v)
    return o.reshape(B, S, H, v.shape[-1])


def moe_experts_ref(x, ids, w, keep, wg, wu, wd):
    """SwiGLU of each token's routed experts, weighted and summed.

    x:      (T, D)         tokens
    ids:    (T, k) int64   expert of each (token, choice) pair
    w:      (T, k) fp32    the pair's routing weight
    keep:   (T, k) bool    whether the pair kept a slot
    wg, wu: (E, D, F)      gate and up projections of every expert
    wd:     (E, F, D)      down projections
    Returns (T, D): the slot dispatch's products and casts (each product in
    x.dtype, the weight cast to it, the k pairs summed) over the pairs alone.
    """
    T, k = ids.shape
    e = ids.reshape(-1)
    xr = x[:, None, :].expand(T, k, x.shape[1]).reshape(T * k, 1, -1)
    h = F.silu(torch.bmm(xr, wg[e])) * torch.bmm(xr, wu[e])
    y = torch.bmm(h, wd[e])[:, 0]  # (T * k, D)
    y = y * (w.reshape(-1, 1) * keep.reshape(-1, 1)).to(y.dtype)
    return y.reshape(T, k, -1).sum(dim=1)


def rope_kv_write_ref(q, k, v, cos, sin, row, k_pages, v_pages):
    """Rotary embedding of a decode step's q and k, and its K/V rows written
    to their pages: the chain of `models.common.rope_apply` on q and k and
    two `index_copy_`.

    q:       (B, H, hd)     the step's query heads
    k, v:    (B, K, hd)     its new key and value rows
    cos, sin (B, hd / 2)    fp32, the step's `common.rope_table`
    row:     (B,) int64     each sequence's row of a layer's (P * T, K, hd) pages
    k_pages, v_pages (P, T, K, hd): one layer's, updated in place (the roped
    k and v at `row`).  Returns the roped q (B, H, hd).
    """
    P, T, K, hd = k_pages.shape
    cos, sin = cos[:, None, :], sin[:, None, :]

    def rope(x):  # common.rope_apply's products and rounding
        x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)

    k_pages.view(P * T, K, hd).index_copy_(0, row, rope(k))
    v_pages.view(P * T, K, hd).index_copy_(0, row, v)
    return rope(q)


def add_rms_norm_ref(h, delta, scale, eps):
    """The residual add and the RMSNorm after it: `h + delta` (`h` itself
    where `delta` is None), then `models.common.rms_norm` of the sum.

    h, delta: (B, S, D)   the residual stream and a sub-block's output
    scale:    (D,) fp32   the norm's scale (applied as 1 + scale)
    Returns (h + delta, rms_norm(h + delta, scale, eps)).
    """
    h_new = h if delta is None else h + delta
    return h_new, rms_norm(h_new, scale, eps)
