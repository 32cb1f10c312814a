"""Shared model building blocks (port of `repro/models/common.py`): norms,
rotary embeddings, attention, MLP.

Pure functions over explicit parameter dicts with the reference's key names.
Conventions and cast order follow the reference:
  activations  (B, S, D)           cfg.dtype
  q/k/v        (B, S, H|K, hd)
  KV cache     (B, C, K, hd)       C = cache capacity (ring for SWA)
  softmax / norm statistics accumulate in fp32.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32


def resolve_device(device) -> torch.device:
    """`device` as a ``torch.device``.  A CUDA device with no card raises:
    nothing falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} needs a CUDA card; "
                           "pass device='cpu' to run on the CPU")
    return dev


# --------------------------------------------------------------------------- init
def uniform_scaled(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
                   fan_in: int, device) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) drawn in fp32 from `gen`, cast to
    `dtype`.  On the ``meta`` device only the shape and dtype are made."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.empty(shape, dtype=F32, device=gen.device)
    x.uniform_(-bound, bound, generator=gen)
    return x.to(device=device, dtype=dtype)


# --------------------------------------------------------------------------- norm
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(F32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


# ------------------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim // 2, dtype=F32, device=device) * 2.0 / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """Rotary embedding.

    x: (B, S, H, hd).  positions: (B, S) int32, or (3, B, S) for M-RoPE where
    the rows are (temporal, height, width) position streams and the frequency
    slots are split into `mrope_sections` (sums to hd // 2).
    """
    hd = x.shape[-1]
    inv_freq = rope_freqs(hd, theta, x.device)  # (hd/2,)
    if mrope_sections:
        assert positions.dim() == 3, "M-RoPE expects (3, B, S) position ids"
        assert sum(mrope_sections) == hd // 2
        # which position stream drives each freq slot, built on the device
        # from host-known section bounds (no host->device copy)
        slot = torch.arange(hd // 2, device=x.device)
        sec_id = torch.zeros_like(slot)
        for bound in itertools.accumulate(mrope_sections[:-1]):
            sec_id += (slot >= bound).to(sec_id.dtype)
        pos = positions.to(F32)  # (3, B, S)
        angles = pos[sec_id] * inv_freq[:, None, None]  # (hd/2, B, S)
        angles = torch.movedim(angles, 0, -1)  # (B, S, hd/2)
    else:
        angles = positions.to(F32)[..., None] * inv_freq  # (B, S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (B, S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- attention
def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,S,K,G,hd) x k (B,T,K,hd) -> (B,K,G,S,T) fp32 scores."""
    return torch.einsum("bskgh,btkh->bkgst", q.to(F32), k.to(F32))


def _masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis; rows with every entry -inf give 0."""
    probs = torch.softmax(scores, dim=-1)
    return torch.nan_to_num(probs, nan=0.0)


def attention_dense(q, k, v, *, causal: bool, window: int = 0,
                    q_positions=None, kv_positions=None, kv_valid=None):
    """Reference dense attention with GQA, causal and sliding-window masking.

    q: (B, S, H, hd); k, v: (B, T, K, hd).  positions default to arange.
    kv_valid: optional (B, T) bool — entries that hold real tokens (decode ring).
    Returns (B, S, H, hd) in q.dtype.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qq = q.reshape(B, S, K, G, hd)
    scores = _gqa_scores(qq, k) * scale  # (B,K,G,S,T) fp32

    if q_positions is None:
        q_positions = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    if kv_positions is None:
        kv_positions = torch.arange(T, dtype=torch.int32, device=q.device).expand(B, T)
    qp = q_positions[:, None, None, :, None]  # (B,1,1,S,1)
    kp = kv_positions[:, None, None, None, :]  # (B,1,1,1,T)
    mask = torch.ones((B, 1, 1, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & (kp > qp - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = _masked_softmax(scores)  # fully-masked rows -> 0
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(q.dtype), v)
    return out.reshape(B, S, H, hd)


def attention_chunked(q, k, v, *, causal: bool, window: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024):
    """Memory-bounded blockwise attention (online softmax), plain torch.

    Functionally identical to `attention_dense`: an outer loop over q chunks,
    an inner loop over kv chunks carrying the (m, l, acc) online-softmax
    state, as the reference's nested scans do.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    assert S % q_chunk == 0 and T % kv_chunk == 0
    nq, nk = S // q_chunk, T // kv_chunk
    dev = q.device

    qr = q.reshape(B, nq, q_chunk, K, G, hd)
    kr = k.reshape(B, nk, kv_chunk, K, hd)
    vr = v.reshape(B, nk, kv_chunk, K, hd)
    q_pos = torch.arange(S, dtype=torch.int32, device=dev).reshape(nq, q_chunk)
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev).reshape(nk, kv_chunk)

    outs = []
    for qi in range(nq):
        qc = qr[:, qi]  # (B, q_chunk, K, G, hd)
        m = torch.full((B, K, G, q_chunk), float("-inf"), dtype=F32, device=dev)
        l = torch.zeros((B, K, G, q_chunk), dtype=F32, device=dev)
        acc = torch.zeros((B, K, G, q_chunk, hd), dtype=F32, device=dev)
        for kj in range(nk):
            kc, vc = kr[:, kj], vr[:, kj]
            s = torch.einsum("bqkgh,btkh->bkgqt", qc.to(F32), kc.to(F32)) * scale
            qp = q_pos[qi][None, None, None, :, None]
            kpp = kv_pos[kj][None, None, None, None, :]
            msk = torch.ones_like(s, dtype=torch.bool)
            if causal:
                msk = msk & (kpp <= qp)
            if window > 0:
                msk = msk & (kpp > qp - window)
            s = s.masked_fill(~msk, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                               torch.exp(m - m_new))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(msk, p, torch.zeros_like(p))
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkh->bkgqh", p.to(qc.dtype).to(F32), vc.to(F32))
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,K,G,q_chunk,hd)
        outs.append(torch.movedim(out, 3, 1).to(q.dtype))  # (B,q_chunk,K,G,hd)
    return torch.cat(outs, dim=1).reshape(B, S, K * G, hd)


# --------------------------------------------------------------------------- mlp
def swiglu(x, wg, wu, wd):
    h = F.silu(x @ wg) * (x @ wu)
    return h @ wd
