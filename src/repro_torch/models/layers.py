"""Layer-kind implementations (port of `repro/models/layers.py`): the "attn" /
"swa" transformer block with a dense SwiGLU MLP.

Each kind exposes:
  init_<kind>(gen, cfg, device)                  -> params (dict)
  <kind>_forward(params, x, cfg, ctx)            -> (y, layer_cache | None)
  <kind>_decode(params, x, cache, cfg, ctx)      -> (y, new_cache)
  <kind>_cache_spec(cfg, batch, cap)             -> dict of (shape, dtype)

Prefill attention goes through the flash kernel (`kernels.ops`), which
computes the same function as the reference's `attention_dense` for
prefill's arange positions.  The MoE MLP, Mamba2 ("ssd") and RG-LRU
("rglru") kinds have their parameter trees (so every architecture's tensor
records match the reference's) but their forward and decode raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.common import rms_norm, uniform_scaled

_NOT_PORTED = "not ported yet — see ROADMAP queue 1"


@dataclass
class SeqCtx:
    """Per-call sequence context threaded through the layer stack."""

    positions: torch.Tensor  # (B, S) int32 absolute positions
    mrope_positions: Optional[torch.Tensor] = None  # (3, B, S) for M-RoPE
    make_cache: bool = False  # prefill: emit decode caches
    cache_cap: int = 0  # KV capacity for full-attention layers
    # positions == arange(S) for every row (the prefill case); the flash
    # kernel's causal mask assumes it, so attention_forward requires it
    arange_positions: bool = False


def kv_capacity(cfg: ModelConfig, kind: str, cache_cap: int) -> int:
    if kind == "swa" and cfg.sliding_window:
        return min(cfg.sliding_window, cache_cap)
    return cache_cap


# =============================================================== attention block
def init_attention(gen, cfg: ModelConfig, kind: str, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.torch_dtype
    p = {
        "wq": uniform_scaled(gen, (d, H, hd), dt, d, device),
        "wk": uniform_scaled(gen, (d, K, hd), dt, d, device),
        "wv": uniform_scaled(gen, (d, K, hd), dt, d, device),
        "wo": uniform_scaled(gen, (H, hd, d), dt, H * hd, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=device)
        p["bk"] = torch.zeros((K, hd), dtype=dt, device=device)
        p["bv"] = torch.zeros((K, hd), dtype=dt, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(p, x, cfg: ModelConfig):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.reshape(h * k, d)


def attention_forward(p, x, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    """Full-sequence causal attention (prefill) through the flash kernel."""
    if not ctx.arange_positions:
        raise ValueError("prefill attention requires positions == arange(S)")
    q, k, v = _project_qkv(p, x, cfg)
    rope_pos = ctx.mrope_positions if cfg.mrope_sections else ctx.positions
    q = common.apply_rope(q, rope_pos, cfg.rope_theta, cfg.mrope_sections)
    k = common.apply_rope(k, rope_pos, cfg.rope_theta, cfg.mrope_sections)
    window = cfg.sliding_window if kind == "swa" else 0
    o = kops.flash_attention(q, k, v, causal=True, window=window)
    y = _out_proj(o, p["wo"])

    cache = None
    if ctx.make_cache:
        cap = kv_capacity(cfg, kind, ctx.cache_cap)
        cache = _fill_kv_cache(k, v, ctx.positions, cap)
    return y, cache


def _fill_kv_cache(k, v, positions, cap: int):
    """Scatter the last `cap` tokens into a ring cache keyed by pos % cap."""
    B, S, K, hd = k.shape
    take = min(S, cap)
    kt, vt, pt = k[:, -take:], v[:, -take:], positions[:, -take:]
    slots = (pt % cap).long()  # (B, take)
    b_idx = torch.arange(B, device=k.device)[:, None]
    kc = torch.zeros((B, cap, K, hd), dtype=k.dtype, device=k.device)
    vc = torch.zeros((B, cap, K, hd), dtype=v.dtype, device=v.device)
    pos_c = torch.full((B, cap), -1, dtype=torch.int32, device=k.device)
    kc[b_idx, slots] = kt
    vc[b_idx, slots] = vt
    pos_c[b_idx, slots] = pt.to(torch.int32)
    return {"k": kc, "v": vc, "kv_pos": pos_c}


def attention_decode(p, x, cache, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    """Single-token decode over the ring cache. x: (B, 1, D); ctx.positions:
    (B, 1) current pos.  Returns a new cache (the input cache is untouched,
    as in the reference)."""
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)
    pos = ctx.positions  # (B, 1)
    rope_pos = ctx.mrope_positions if cfg.mrope_sections else pos
    q = common.apply_rope(q, rope_pos, cfg.rope_theta, cfg.mrope_sections)
    k = common.apply_rope(k, rope_pos, cfg.rope_theta, cfg.mrope_sections)

    cap = cache["k"].shape[1]
    slot = (pos[:, 0] % cap).long()  # (B,)
    b_idx = torch.arange(B, device=x.device)
    kc, vc, kv_pos = cache["k"].clone(), cache["v"].clone(), cache["kv_pos"].clone()
    kc[b_idx, slot] = k[:, 0]
    vc[b_idx, slot] = v[:, 0]
    kv_pos[b_idx, slot] = pos[:, 0].to(torch.int32)

    window = cfg.sliding_window if kind == "swa" else 0
    valid = kv_pos >= 0
    if window > 0:
        valid = valid & (kv_pos > pos[:, :1] - window)  # ring may hold stale slots
    o = common.attention_dense(q, kc, vc, causal=False, q_positions=pos,
                               kv_positions=kv_pos, kv_valid=valid)
    y = _out_proj(o, p["wo"])
    return y, {"k": kc, "v": vc, "kv_pos": kv_pos}


def attention_cache_spec(cfg: ModelConfig, kind: str, batch: int, cap: int):
    cap = kv_capacity(cfg, kind, cap)
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = cfg.torch_dtype
    return {
        "k": ((batch, cap, K, hd), dt),
        "v": ((batch, cap, K, hd), dt),
        "kv_pos": ((batch, cap), torch.int32),
    }


# ==================================================================== dense MLP
def init_mlp(gen, cfg: ModelConfig, device):
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {
        "wg": uniform_scaled(gen, (d, f), dt, d, device),
        "wu": uniform_scaled(gen, (d, f), dt, d, device),
        "wd": uniform_scaled(gen, (f, d), dt, f, device),
    }


def mlp_forward(p, x):
    return common.swiglu(x, p["wg"], p["wu"], p["wd"])


# ======================================================================= MoE MLP
def init_moe(gen, cfg: ModelConfig, device):
    d, fe, E = cfg.d_model, cfg.expert_ff, cfg.num_experts
    dt = cfg.torch_dtype
    return {
        "router": uniform_scaled(gen, (d, E), torch.float32, d, device),
        "wg": uniform_scaled(gen, (E, d, fe), dt, d, device),
        "wu": uniform_scaled(gen, (E, d, fe), dt, d, device),
        "wd": uniform_scaled(gen, (E, fe, d), dt, fe, device),
    }


# ============================================================== transformer block
def init_block(gen, cfg: ModelConfig, kind: str, device):
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "attn": init_attention(gen, cfg, kind, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "mlp": (init_moe if cfg.is_moe else init_mlp)(gen, cfg, device),
    }


def _mlp(p, h, cfg: ModelConfig):
    if cfg.is_moe:
        raise NotImplementedError(f"MoE MLP {_NOT_PORTED}")
    return mlp_forward(p["mlp"], h)


def block_forward(p, x, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    a, cache = attention_forward(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                 cfg, ctx, kind)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(p, h, cfg), cache


def block_decode(p, x, cache, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    a, cache = attention_decode(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                cache, cfg, ctx, kind)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(p, h, cfg), cache


# ============================================ Mamba2 (SSD) and RG-LRU parameters
def init_ssd(gen, cfg: ModelConfig, device):
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    dt = cfg.torch_dtype
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": torch.zeros((d,), **f32),
        "z_proj": uniform_scaled(gen, (d, d_in), dt, d, device),
        "xbc_proj": uniform_scaled(gen, (d, conv_dim), dt, d, device),
        "dt_proj": uniform_scaled(gen, (d, H), dt, d, device),
        "conv_w": uniform_scaled(gen, (cfg.ssm_conv_width, conv_dim), dt,
                                 cfg.ssm_conv_width, device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), math.log(math.expm1(1e-2)), **f32),
        "gnorm": torch.zeros((d_in,), **f32),
        "out_proj": uniform_scaled(gen, (d_in, d), dt, d_in, device),
    }


def init_rglru(gen, cfg: ModelConfig, device):
    d = cfg.d_model
    w = cfg.lru_width or d
    dt = cfg.torch_dtype
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "ln": torch.zeros((d,), **f32),
        "wx": uniform_scaled(gen, (d, w), dt, d, device),
        "wy": uniform_scaled(gen, (d, w), dt, d, device),
        "conv_w": uniform_scaled(gen, (4, w), dt, 4, device),
        "wa": uniform_scaled(gen, (w, w), dt, w, device),
        "ba": torch.zeros((w,), **f32),
        "wi": uniform_scaled(gen, (w, w), dt, w, device),
        "bi": torch.zeros((w,), **f32),
        "Lambda": torch.linspace(2.0, 6.0, w, **f32),
        "out": uniform_scaled(gen, (w, d), dt, w, device),
    }


# ============================================================== kind dispatch
def _check_kind(kind: str):
    if kind in ("ssd", "rglru"):
        raise NotImplementedError(f"layer kind {kind!r} {_NOT_PORTED}")
    if kind not in ("attn", "swa"):
        raise ValueError(kind)


def init_layer(gen, cfg: ModelConfig, kind: str, device):
    if kind == "ssd":
        return init_ssd(gen, cfg, device)
    if kind == "rglru":
        return init_rglru(gen, cfg, device)
    _check_kind(kind)
    return init_block(gen, cfg, kind, device)


def layer_forward(p, x, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    _check_kind(kind)
    return block_forward(p, x, cfg, ctx, kind)


def layer_decode(p, x, cache, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    _check_kind(kind)
    return block_decode(p, x, cache, cfg, ctx, kind)


def layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, cap: int):
    _check_kind(kind)
    return attention_cache_spec(cfg, kind, batch, cap)
