"""Plain PyTorch versions of the two kernels (port of `repro/kernels/ref.py`).

`paged_attention_ref` / `flash_attention_ref` define what the CUDA kernels
compute, run for CPU tensors, and are what the kernels are held against on
the card.  Same casts as the reference oracles: scores in fp32,
probabilities cast to q.dtype before the V product.
"""
from __future__ import annotations

import math

import torch

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


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """Full-sequence attention with causal + sliding-window masking.

    q: (B, S, H, hd); k, v: (B, S, K, hd) (GQA: H = K * G). Returns q-shaped.
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qq = q.reshape(B, S, K, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qq.to(F32), k.to(F32))
    s = s * (1.0 / math.sqrt(hd))
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
    return o.reshape(B, S, H, hd)

