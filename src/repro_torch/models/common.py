"""Shared model building blocks (port of `repro/models/common.py`): norms,
rotary embeddings, attention, MLPs and the causal depthwise conv.

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


def _yarn_correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention-temperature factor 0.1 mscale ln(scale) + 1 (1 where
    scale <= 1)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_freqs(dim: int, cfg, device) -> torch.Tensor:
    """YaRN's inverse frequencies (DeepSeek-V2's `DeepseekV2YarnRotaryEmbedding`):
    the plain ones extrapolated above the correction range found from
    `yarn_beta_fast` / `yarn_beta_slow` at `yarn_original_max_pos`,
    interpolated (divided by `yarn_factor`) below it, and blended by a
    linear ramp across it."""
    base = cfg.rope_theta
    exps = torch.arange(0, dim // 2, dtype=F32, device=device) * 2.0 / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (cfg.yarn_factor * base ** exps)
    lo = math.floor(_yarn_correction_dim(cfg.yarn_beta_fast, dim, base, cfg.yarn_original_max_pos))
    hi = math.ceil(_yarn_correction_dim(cfg.yarn_beta_slow, dim, base, cfg.yarn_original_max_pos))
    lo, hi = max(lo, 0), min(hi, dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=F32, device=device) - lo) / max(hi - lo, 0.001)
            ).clamp(0, 1)
    keep = 1.0 - ramp  # 1: extrapolate (high frequencies), 0: interpolate
    return inter * (1 - keep) + extra * keep


def yarn_rope_scale(cfg) -> float:
    """The factor on cos and sin: mscale(factor, yarn_mscale) over
    mscale(factor, yarn_mscale_all_dim); 1.0 at DeepSeek-V2-Lite's equal pair."""
    return (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
            / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """The last axis's pairs (x0, x1), (x2, x3), ... regrouped as (x0, x2,
    ..., x1, x3, ...): DeepSeek-V2 rotates interleaved pairs, which the
    rotate-half convention reaches after this permutation."""
    *lead, d = x.shape
    return x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (B, S, 1, head_dim / 2) fp32, of the rotary embedding
    at `positions`: (B, S) int32, or (3, B, S) for M-RoPE, where the rows
    are (temporal, height, width) position streams and the frequency slots
    are split into `mrope_sections` (sums to head_dim // 2).  Every head and
    every layer of a call shares it."""
    inv_freq = rope_freqs(head_dim, theta, positions.device)  # (hd/2,)
    if mrope_sections:
        assert positions.dim() == 3, "M-RoPE expects (3, B, S) position ids"
        assert sum(mrope_sections) == head_dim // 2
        # which position stream drives each freq slot, built on the device
        # from host-known section bounds (no host->device copy)
        slot = torch.arange(head_dim // 2, device=positions.device)
        sec_id = torch.zeros_like(slot)
        for bound in itertools.accumulate(mrope_sections[:-1]):
            sec_id += (slot >= bound).to(sec_id.dtype)
        pos = positions.to(F32)  # (3, B, S)
        angles = pos[sec_id] * inv_freq[:, None, None]  # (hd/2, B, S)
        angles = torch.movedim(angles, 0, -1)  # (B, S, hd/2)
    else:
        angles = positions.to(F32)[..., None] * inv_freq  # (B, S, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def rope_apply(x: torch.Tensor, table: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """x (..., hd) rotated half against half by `rope_table`'s (cos, sin),
    which broadcast against x's leading axes: products and sums in fp32,
    rounded once to x.dtype."""
    cos, sin = table
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: tuple[int, ...] = ()) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, hd) at positions (B, S), or (3, B, S)
    for M-RoPE: `rope_apply` of `rope_table`."""
    return rope_apply(x, rope_table(positions, x.shape[-1], theta, mrope_sections))


# ---------------------------------------------------------------------- attention
def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B,S,K,G,hd) x k (B,T,K,hd) -> (B,K,G,S,T) fp32 scores."""
    return torch.einsum("bskgh,btkh->bkgst", q.to(F32), k.to(F32))


def _masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis; rows with every entry -inf give 0."""
    probs = torch.softmax(scores, dim=-1)
    return torch.nan_to_num(probs, nan=0.0)


def _masked_scores(q, k, *, causal: bool, window: int, q_positions, kv_positions, kv_valid,
                   scale: Optional[float] = None):
    """(B, K, G, S, T) fp32 scaled scores of q (B, S, H, hd) against k
    (B, T, K, hd), -inf where masked (see `attention_dense`)."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    scores = _gqa_scores(q.reshape(B, S, K, H // K, hd), k) * scale  # (B,K,G,S,T) fp32

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
    return scores.masked_fill(~mask, float("-inf"))


def attention_dense(q, k, v, *, causal: bool, window: int = 0,
                    q_positions=None, kv_positions=None, kv_valid=None,
                    scale: Optional[float] = None):
    """Reference dense attention with GQA, causal and sliding-window masking.

    q: (B, S, H, hd); k: (B, T, K, hd); v: (B, T, K, hv) (hv is hd but for
    latent attention).  positions default to arange.  kv_valid: optional
    (B, T) bool — entries that hold real tokens (decode ring).  `scale`
    defaults to 1/sqrt(hd).  Returns (B, S, H, hv) in q.dtype.
    """
    B, S, H, hd = q.shape
    scores = _masked_scores(q, k, causal=causal, window=window, q_positions=q_positions,
                            kv_positions=kv_positions, kv_valid=kv_valid, scale=scale)
    probs = _masked_softmax(scores)  # fully-masked rows -> 0
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(q.dtype), v)
    return out.reshape(B, S, H, v.shape[-1])


def attention_partial(q, k, v, *, causal: bool, window: int = 0,
                      q_positions=None, kv_positions=None, kv_valid=None):
    """`attention_dense` over one slice of the keys, left unnormalised: the
    partials a flash-decode combine merges (`models.sharded`).  Returns
    (o, m, l): o (B, S, H, hd) fp32, the product of exp(scores - m) with v;
    m (B, S, H) fp32, each row's largest visible score (-inf where the
    slice holds none); l (B, S, H) fp32, the sum of exp(scores - m) (0
    there, and o 0 too)."""
    B, S, H, hd = q.shape
    scores = _masked_scores(q, k, causal=causal, window=window, q_positions=q_positions,
                            kv_positions=kv_positions, kv_valid=kv_valid)
    m = scores.amax(dim=-1)  # (B,K,G,S)
    p = torch.exp(scores - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    o = torch.einsum("bkgst,btkh->bskgh", p.to(q.dtype), v).to(F32).reshape(B, S, H, hd)
    rows = lambda t: t.permute(0, 3, 1, 2).reshape(B, S, H)  # noqa: E731  (B,K,G,S) -> (B,S,H)
    return o, rows(m), rows(p.sum(dim=-1))


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


def gelu_mlp(x, wi, bi, wo, bo):
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    h = F.gelu(x @ wi + bi, approximate="tanh")
    return h @ wo + bo


# ------------------------------------------------------------------------- conv1d
def causal_conv1d(x, w, state=None):
    """Depthwise causal conv. x: (B, S, C), w: (W, C).

    Prefill: state=None, left-pads with zeros; returns (y, new_state) where
    new_state = last (W-1) inputs.  Decode: x is (B, 1, C), state is
    (B, W-1, C); returns (y, shifted state).
    """
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)  # (B, S+W-1, C)
    S = x.shape[1]
    y = sum(xp[:, i : i + S, :] * w[i][None, None, :] for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else torch.zeros_like(pad)
    return y.to(x.dtype), new_state
