"""Layer-kind implementations (port of `repro/models/layers.py`): "attn" /
"swa" transformer blocks (dense or MoE), "ssd" Mamba2 blocks, "rglru"
RecurrentGemma blocks.

Each kind exposes:
  init_<kind>(gen, cfg, device)                  -> params (dict)
  <kind>_forward(params, x, cfg, ctx)            -> (y, layer_cache | None)
  <kind>_decode(params, x, cache, cfg, ctx)      -> (y, new_cache)
  <kind>_cache_spec(cfg, batch, cap)             -> dict of (shape, dtype)

Attention takes one of two routes, chosen by `SeqCtx.kernel_attention`.
Prefill goes through the flash kernel (`kernels.ops`), which computes the
same function as the reference's `attention_dense` for prefill's arange
positions.  The loss takes the reference's own plain attention
(`attention_dense` at ``ctx.positions``, or `attention_chunked` when
``ctx.attn_chunked``), which autograd differentiates: the kernels have no
backward, in the reference as here.  The MoE MLP has the reference's three
dispatches (`SeqCtx.moe_impl`): scatter (`moe_forward`), per-sequence
grouped (`moe_forward_grouped`) and GShard one-hot einsums
(`moe_forward_gshard`).  Sliding-window layers keep a ring cache of
`kv_capacity` slots keyed by ``pos % cap``.  The SSD scan and the RG-LRU
recurrence are plain PyTorch, as the reference computes them outside any
Pallas kernel.  Over DTensors (`distributed.steps`) the ops that need it go
through `models.sharded`.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common, sharded
from repro_torch.models.common import F32, rms_norm, uniform_scaled
from repro_torch.models.sharded import grad_placed, placed_like  # noqa: F401  (encdec, lm)


# The capacity factors the reference's callers give the MoE dispatch:
# 1.25 in prefill and training (`lm.forward`'s default,
# src/repro/models/lm.py:87) and 4.0 in every decode step
# (`lm.decode_step`, src/repro/models/lm.py:109; the paged step,
# src/repro/serving/engine.py:1783).
PREFILL_CAPACITY_FACTOR = 1.25
DECODE_CAPACITY_FACTOR = 4.0


@dataclass
class SeqCtx:
    """Per-call sequence context threaded through the layer stack."""

    positions: torch.Tensor  # (B, S) int32 absolute positions
    mrope_positions: Optional[torch.Tensor] = None  # (3, B, S) for M-RoPE
    make_cache: bool = False  # prefill: emit decode caches
    cache_cap: int = 0  # KV capacity for full-attention layers
    # the attention route: the flash kernel (prefill) or the reference's
    # plain attention at `positions` (the loss, under autograd)
    kernel_attention: bool = True
    # positions == arange(S) for every row (the prefill case); the flash
    # kernel's causal mask assumes it, so its route requires it
    arange_positions: bool = False
    attn_chunked: bool = False  # plain route: blockwise attention (long sequences)
    q_chunk: int = 512
    kv_chunk: int = 1024
    moe_capacity_factor: float = PREFILL_CAPACITY_FACTOR
    moe_impl: str = "scatter"  # scatter | grouped | gshard
    moe_ep_axis: str = ""  # mesh axis for expert-parallel constraints (gshard)


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
    """Full-sequence causal attention: the flash kernel (prefill) or the
    reference's plain attention (the loss), as `ctx.kernel_attention` says."""
    if ctx.kernel_attention and not ctx.arange_positions:
        raise ValueError("prefill attention requires positions == arange(S)")
    q, k, v = _project_qkv(p, x, cfg)
    rope_pos = ctx.mrope_positions if cfg.mrope_sections else ctx.positions
    q = common.apply_rope(q, rope_pos, cfg.rope_theta, cfg.mrope_sections)
    k = common.apply_rope(k, rope_pos, cfg.rope_theta, cfg.mrope_sections)
    window = cfg.sliding_window if kind == "swa" else 0

    def attend(q, k, v, positions):
        if ctx.kernel_attention:
            return kops.flash_attention(q, k, v, causal=True, window=window)
        if ctx.attn_chunked:
            return common.attention_chunked(q, k, v, causal=True, window=window,
                                            q_chunk=ctx.q_chunk, kv_chunk=ctx.kv_chunk)
        return common.attention_dense(q, k, v, causal=True, window=window,
                                      q_positions=positions, kv_positions=positions)

    o = run_attention(attend, q, k, v, ctx.positions)
    y = _out_proj(o, p["wo"])

    cache = None
    if ctx.make_cache:
        cap = kv_capacity(cfg, kind, ctx.cache_cap)
        cache = _fill_kv_cache(k, v, ctx.positions, cap)
    return y, cache


def run_attention(attend, q, k, v, *rows):
    """`attend(q, k, v, *rows)`, per rank (`sharded.attention`) where q is a
    DTensor."""
    if isinstance(q, DTensor):
        return sharded.attention(attend, q, k, v, *rows)
    return attend(q, k, v, *rows)


def slot_write(cache, value, pos):
    """`cache` (B, C, ...) with each row's new `value` (B, ...) at ring slot
    pos % C (B,); the input cache is untouched, as in the reference.  A
    DTensor cache is written per rank (`sharded.slot_write`)."""
    if isinstance(cache, DTensor):
        return sharded.slot_write(cache, value, pos)
    out = cache.clone()
    out[torch.arange(cache.shape[0], device=cache.device),
        (pos % cache.shape[1]).long()] = value
    return out


def _fill_kv_cache(k, v, positions, cap: int):
    """Scatter the last `cap` tokens into a ring cache keyed by pos % cap."""
    if isinstance(k, DTensor):
        return sharded.fill_kv_cache(_fill_kv_cache, k, v, positions, cap)
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
    q, k, v = _project_qkv(p, x, cfg)
    pos = ctx.positions  # (B, 1)
    rope_pos = ctx.mrope_positions if cfg.mrope_sections else pos
    q = common.apply_rope(q, rope_pos, cfg.rope_theta, cfg.mrope_sections)
    k = common.apply_rope(k, rope_pos, cfg.rope_theta, cfg.mrope_sections)

    kc = slot_write(cache["k"], k[:, 0], pos[:, 0])
    vc = slot_write(cache["v"], v[:, 0], pos[:, 0])
    kv_pos = slot_write(cache["kv_pos"], pos[:, 0].to(torch.int32), pos[:, 0])

    window = cfg.sliding_window if kind == "swa" else 0
    valid = kv_pos >= 0
    if window > 0:
        valid = valid & (kv_pos > pos[:, :1] - window)  # ring may hold stale slots

    def attend(q, k, v, pos, kv_pos, valid):
        return common.attention_dense(q, k, v, causal=False, q_positions=pos,
                                      kv_positions=kv_pos, kv_valid=valid)

    o = run_attention(attend, q, kc, vc, pos, kv_pos, valid)
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


def moe_capacity(tokens: int, k: int, experts: int, capacity_factor: float) -> int:
    """Slots per expert: ceil(T*k/E*cf) rounded up to a multiple of 8, at
    least 8.  A host integer from static shapes, so dispatch never reads the
    device."""
    cap = int(math.ceil(tokens * k / experts * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """Top-k expert choice of each token, xf (..., D): fp32 router logits,
    softmax, `torch.topk`, weights renormalised over the k choices.
    `torch.topk` orders equal probabilities as it likes; the reference's
    `jax.lax.top_k` puts the lower expert first, so the two agree wherever
    the top-k probabilities do not tie.  Returns (w, idx), each (..., k)."""
    probs = torch.softmax(xf.to(F32) @ router, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """One-hot of `idx` over `n` classes, as a comparison with an arange (an
    elementwise op, which DTensor shards like `idx`; a scatter into a fresh
    tensor has no DTensor sharding strategy)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _slots(flat_e: torch.Tensor, experts: int, cap: int, dim: int):
    """Slot of each (token, choice) pair in its expert: the running count of
    earlier pairs routed there along `dim` (a cumsum over the one-hot),
    or `cap` once the expert is full.  Returns (slot, keep)."""
    onehot = _one_hot(flat_e, experts, torch.int32)
    pos = (torch.cumsum(onehot, dim=dim) * onehot).sum(-1) - 1
    keep = pos < cap
    return torch.where(keep, pos, cap), keep


def _experts(xe: torch.Tensor, p) -> torch.Tensor:
    """SwiGLU of every expert over its slots, xe (E, N, D) -> (E, N, D)."""
    h = F.silu(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    return torch.bmm(h, p["wd"])


def moe_forward(p, x, cfg: ModelConfig, capacity_factor: float, first_expert: int = 0):
    """Top-k expert dispatch with per-expert capacity (the reference's scatter
    dispatch).

    Each (token, choice) pair takes the next slot of its expert in flattened
    (T*k) order; pairs past an expert's capacity are dropped (their slot is
    `cap`, one spare row per expert that is written, never read back, and
    sliced off before the expert products).  Sync-free on CUDA: the
    capacity is a host integer, the one-hot is a comparison, and dispatch
    and combine are one `index_copy_` / `index_select` over linear slot ids.

    `p`'s expert weights may hold experts [first_expert, first_expert + El)
    of the E (one rank's experts, `sharded.moe_forward`): pairs routed to
    the others are dropped, so the output is this slice's share of the sum.
    """
    if isinstance(x, DTensor):
        return sharded.moe_forward(moe_forward, p, x, cfg, capacity_factor)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    El = p["wg"].shape[0]
    T = B * S
    xf = x.reshape(T, D)
    w, idx = route(xf, p["router"], k)  # (T, k)

    cap = moe_capacity(T, k, E, capacity_factor)
    flat_e = idx.reshape(-1)  # (T*k,)
    slot, keep = _slots(flat_e, E, cap, dim=0)
    if El < E:  # this rank's experts only: the others' pairs take a spare row
        mine = (flat_e >= first_expert) & (flat_e < first_expert + El)
        keep, slot = keep & mine, torch.where(mine, slot, cap)
        flat_e = (flat_e - first_expert).clamp(0, El - 1)
    row = flat_e * (cap + 1) + slot  # row of the (El*(cap+1), D) buffer

    xr = xf[:, None, :].expand(T, k, D).reshape(T * k, D)
    buf = torch.zeros((El * (cap + 1), D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, row, xr)
    ye = _experts(buf.view(El, cap + 1, D)[:, :cap], p)  # (El, cap, D)

    ye_pad = torch.cat([ye, ye.new_zeros((El, 1, D))], dim=1).reshape(El * (cap + 1), D)
    y_tok = ye_pad.index_select(0, row)  # (T*k, D)
    y_tok = y_tok * (w.reshape(-1, 1) * keep[:, None]).to(y_tok.dtype)
    y = y_tok.reshape(T, k, D).sum(dim=1)
    return y.reshape(B, S, D)


@torch.library.custom_op("repro_torch::moe_y", mutates_args=())
def _moe_y(y: torch.Tensor) -> torch.Tensor:
    """The GShard combine output, under a name a remat policy can save (the
    reference's ``checkpoint_name(y, "moe_y")``): an identity op."""
    return y.clone()


_moe_y.register_fake(lambda y: torch.empty_like(y))
_moe_y.register_autograd(lambda ctx, grad: grad)


sharded.register_identity_sharding(torch.ops.repro_torch.moe_y.default)


def _save_moe_y(ctx, op, *args, **kwargs):
    """Per-unit remat policy: keep the named MoE combine output, recompute
    every other op (the reference's ``save_only_these_names("moe_y")``)."""
    if op is torch.ops.repro_torch.moe_y.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_requires_grad(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat(fn, *args):
    """`fn(*args)` with its activations recomputed in backward, saving only
    the MoE combine outputs: `jax.checkpoint` with the reference's policy.
    Where autograd records nothing (serving: grad off, or no input that
    requires grad) `fn` just runs, as `jax.checkpoint` is a no-op unless
    differentiated."""
    if not (torch.is_grad_enabled() and _requires_grad(args)):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   _save_moe_y))


def moe_forward_gshard(p, x, cfg: ModelConfig, capacity_factor: float,
                       ep_axis: Optional[str] = None):
    """GShard-style one-hot einsum dispatch and combine (the reference's
    `moe_forward_gshard`): per-sequence capacity, (B, S, E, cap) dispatch
    and combine tensors summed over the k choices.  On DTensors both are
    placed for the expert products (`sharded.experts_placed`: P(None, None,
    ep_axis, None) where `ep_axis` is named, the reference's
    `with_sharding_constraint`); values do not change.
    An overflow slot `cap` gets an all-zero position row (`jax.nn.one_hot`
    of an out-of-range index), built as a one-hot over cap + 1 slots with
    the last sliced off.  The combine output is named for the remat policy
    (`remat`)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    # routed as (B, S, D), as the reference routes (the gradient of a
    # (B*S, D) view of a batch-sharded DTensor would come back sharded over
    # every mesh dim, which B cannot unflatten)
    w, idx = route(x, p["router"], k)  # (B, S, k)

    cap = moe_capacity(S, k, E, capacity_factor)
    slot, _ = _slots(idx.reshape(B, S * k), E, cap, dim=1)  # (B, S*k)
    onehot_e = _one_hot(idx, E, x.dtype)
    pos_oh = _one_hot(slot.view(B, S, k), cap + 1, x.dtype)[..., :cap]  # overflow -> zeros

    disp = torch.einsum("bske,bskc->bsec", onehot_e, pos_oh)
    # bske,bskc,bsk->bsec: each token's k experts differ, so one term of the
    # sum over k is nonzero and folding w into the one-hot is exact
    comb = torch.einsum("bske,bskc->bsec", onehot_e.to(F32) * w[..., None],
                        pos_oh.to(F32)).to(x.dtype)
    if isinstance(disp, DTensor):
        disp, comb = sharded.experts_placed(disp, comb, p["wg"], ep_axis)

    xe = torch.einsum("bsec,bsd->becd", disp, x)  # (B, E, cap, D)
    ye = _experts(xe.transpose(0, 1).reshape(E, B * cap, D), p)
    ye = ye.view(E, B, cap, D).transpose(0, 1)  # (B, E, cap, D)
    y = torch.einsum("bsec,becd->bsd", comb, ye)
    return _moe_y(y)


def moe_forward_grouped(p, x, cfg: ModelConfig, capacity_factor: float):
    """Grouped dispatch (the reference's `moe_forward_grouped`): each
    sequence is its own dispatch group, with capacity from S.  The scatter
    dispatch's sync-free idiom over a (E, B, cap + 1, D) buffer."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    w, idx = route(x.reshape(B * S, D), p["router"], k)

    cap = moe_capacity(S, k, E, capacity_factor)
    flat_e = idx.reshape(B, S * k)
    slot, keep = _slots(flat_e, E, cap, dim=1)  # (B, S*k)
    b_idx = torch.arange(B, device=x.device)[:, None]
    row = ((flat_e * B + b_idx) * (cap + 1) + slot).reshape(-1)

    xr = x[:, :, None, :].expand(B, S, k, D).reshape(B * S * k, D)
    buf = torch.zeros((E * B * (cap + 1), D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, row, xr)
    xe = buf.view(E, B, cap + 1, D)[:, :, :cap].reshape(E, B * cap, D)
    ye = _experts(xe, p).view(E, B, cap, D)

    ye_pad = torch.cat([ye, ye.new_zeros((E, B, 1, D))], dim=2)
    y_tok = ye_pad.reshape(E * B * (cap + 1), D).index_select(0, row)
    y_tok = y_tok * (w.reshape(-1, 1) * keep.reshape(-1, 1)).to(y_tok.dtype)
    return y_tok.reshape(B, S, k, D).sum(dim=2)


# ============================================================== transformer block
def init_block(gen, cfg: ModelConfig, kind: str, device):
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "attn": init_attention(gen, cfg, kind, device),
        "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
        "mlp": (init_moe if cfg.is_moe else init_mlp)(gen, cfg, device),
    }


def _moe_dispatch(pm, h, cfg: ModelConfig, ctx: SeqCtx, cf: float):
    if ctx.moe_impl == "gshard":
        return moe_forward_gshard(pm, h, cfg, cf, ep_axis=ctx.moe_ep_axis or None)
    if ctx.moe_impl == "grouped":
        return moe_forward_grouped(pm, h, cfg, cf)
    return moe_forward(pm, h, cfg, cf)


def _mlp(p, h, cfg: ModelConfig, ctx: SeqCtx):
    if cfg.is_moe:
        return _moe_dispatch(p["mlp"], h, cfg, ctx, ctx.moe_capacity_factor)
    return mlp_forward(p["mlp"], h)


def embed_lookup(embed, tokens):
    """`embed[tokens]`, vocab-parallel (`sharded.embedding`) over a DTensor
    table."""
    return sharded.embedding(tokens, embed) if isinstance(embed, DTensor) else embed[tokens]


def block_forward(p, x, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    a, cache = attention_forward(p["attn"], grad_placed(rms_norm(x, p["ln1"], cfg.norm_eps)),
                                 cfg, ctx, kind)
    x = x + placed_like(a, x)
    h = grad_placed(rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + placed_like(_mlp(p, h, cfg, ctx), x), cache


def block_decode(p, x, cache, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    a, cache = attention_decode(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                cache, cfg, ctx, kind)
    x = x + placed_like(a, x)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + placed_like(_mlp(p, h, cfg, ctx), x), cache


# ================================================================== Mamba2 (SSD)
def _ssd_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_dim = d_in + 2 * N  # x, B, C share the causal conv (ngroups = 1)
    return d_in, nheads, N, conv_dim


def init_ssd(gen, cfg: ModelConfig, device):
    d = cfg.d_model
    d_in, H, _, conv_dim = _ssd_dims(cfg)
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


def segsum(x):
    """x: (..., T) -> (..., T, T); out[i, j] = sum_{j < k <= i} x_k (lower-tri),
    -inf above the diagonal (so exp gives 0 there, never NaN)."""
    T = x.shape[-1]
    ones = torch.ones((T, T), dtype=torch.bool, device=x.device)
    xr = x[..., :, None].expand(*x.shape, T)
    xr = xr.masked_fill(~torch.tril(ones, -1), 0.0)
    cs = torch.cumsum(xr, dim=-2)
    return cs.masked_fill(~torch.tril(ones), float("-inf"))


def ssd_chunked(x, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked state-space-duality scan (Mamba2, arXiv:2405.21060 listing 1).

    x: (b, s, h, p) dt-scaled inputs; A: (b, s, h) = dt * A (negative);
    Bm, Cm: (b, s, n) (single group, broadcast over heads).
    Returns (y: (b, s, h, p), final_state: (b, h, p, n)).  The reference's
    three- and four-operand einsums run as pairwise products in its operand
    order, so no (b, h, c, l, s, p) intermediate is ever built.
    """
    b, s, h, p_ = x.shape
    n = Bm.shape[-1]
    assert s % chunk == 0
    c = s // chunk
    xr = x.reshape(b, c, chunk, h, p_).to(F32)
    Ar = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2).to(F32)  # (b,h,c,l)
    Br = Bm.reshape(b, c, chunk, n).to(F32)
    Cr = Cm.reshape(b, c, chunk, n).to(F32)

    A_cs = torch.cumsum(Ar, dim=-1)  # (b,h,c,l)
    L = torch.exp(segsum(Ar))  # (b,h,c,l,l)

    # diagonal (intra-chunk) term: bcln,bcsn,bhcls,bcshp->bclhp
    CB = torch.einsum("bcln,bcsn->bcls", Cr, Br)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", CB[:, None] * L, xr)

    # per-chunk end states: bcln,bhcl,bclhp->bchpn
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)  # (b,h,c,l)
    xd = xr * decay_states.permute(0, 2, 3, 1)[..., None]  # (b,c,l,h,p)
    states = torch.einsum("bcln,bclhp->bchpn", Br, xd)

    init = (torch.zeros((b, 1, h, p_, n), dtype=F32, device=x.device)
            if init_state is None else init_state.to(F32)[:, None])
    states = torch.cat([init, states], dim=1)  # (b, c+1, h, p, n)
    chunk_decay = torch.exp(segsum(F.pad(A_cs[..., -1], (1, 0))))  # (b,h,c+1,c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)
    states_in, final_state = new_states[:, :-1], new_states[:, -1]

    # off-diagonal term: bcln,bchpn,bhcl->bclhp
    state_decay_out = torch.exp(A_cs)  # (b,h,c,l)
    y_off = (torch.einsum("bcln,bchpn->bclhp", Cr, states_in)
             * state_decay_out.permute(0, 2, 3, 1)[..., None])
    y = (y_diag + y_off).reshape(b, s, h, p_)
    return y.to(x.dtype), final_state


def _silu(x):
    """jax.nn.silu's roundings: sigmoid in the input's dtype, then the
    product (F.silu rounds once, from float32)."""
    return x * torch.sigmoid(x)


def _ssd_project(p, x, cfg: ModelConfig):
    # each column-parallel output's gradient placed as the output is, so the
    # weights' gradients are products of shards (DTensor gathers xbc whole
    # to split it into x, B and C, and would hand back a whole gradient)
    z = grad_placed(x @ p["z_proj"])
    xbc = grad_placed(x @ p["xbc_proj"])
    dt = grad_placed(x @ p["dt_proj"])
    dt = F.softplus(dt.to(F32) + p["dt_bias"])  # (B,S,H)
    return z, xbc, dt


def ssd_forward(p, x, cfg: ModelConfig, ctx: SeqCtx):
    B, S, _ = x.shape
    d_in, H, N, _ = _ssd_dims(cfg)
    u = grad_placed(rms_norm(x, p["ln"], cfg.norm_eps))
    z, xbc, dt = _ssd_project(p, u, cfg)
    xbc, conv_state = common.causal_conv1d(xbc, p["conv_w"])
    xbc = _silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [d_in, N, N], dim=-1)
    xh = xs.reshape(B, S, H, cfg.ssm_head_dim)
    A = -torch.exp(p["A_log"])  # (H,)
    chunk = min(cfg.ssm_chunk, S)
    pad = (-S) % chunk
    if pad:
        # dt = 0 on padded steps -> no decay, no input: final_state stays exact
        xh_p = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt_p, Bm_p, Cm_p = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    else:
        xh_p, dt_p, Bm_p, Cm_p = xh, dt, Bm, Cm
    y, state = ssd_chunked(xh_p * dt_p[..., None].to(xh_p.dtype), dt_p * A, Bm_p, Cm_p,
                           chunk)
    y = y[:, :S]
    y = y + p["D"][:, None].to(y.dtype) * xh
    y = y.reshape(B, S, d_in)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), p["gnorm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    cache = {"conv": conv_state, "state": state} if ctx.make_cache else None
    return x + placed_like(out, x), cache


def ssd_decode(p, x, cache, cfg: ModelConfig, ctx: SeqCtx):
    B = x.shape[0]
    d_in, H, N, _ = _ssd_dims(cfg)
    u = rms_norm(x, p["ln"], cfg.norm_eps)
    z, xbc, dt = _ssd_project(p, u, cfg)  # S = 1
    xbc, conv_state = common.causal_conv1d(xbc, p["conv_w"], state=cache["conv"])
    xbc = _silu(xbc)
    xs, Bm, Cm = torch.split(xbc[:, 0], [d_in, N, N], dim=-1)
    xh = xs.reshape(B, H, cfg.ssm_head_dim).to(F32)
    dt1 = dt[:, 0]  # (B, H)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt1 * A)  # (B, H)
    # bh,bn,bhp->bhpn
    dbx = (dt1[:, :, None] * xh)[..., None] * Bm.to(F32)[:, None, None, :]
    state = cache["state"] * dA[..., None, None] + dbx
    y = torch.einsum("bn,bhpn->bhp", Cm.to(F32), state)
    y = y + p["D"][:, None] * xh
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), p["gnorm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    return x + placed_like(out, x), {"conv": conv_state, "state": state}


def ssd_cache_spec(cfg: ModelConfig, batch: int):
    _, H, N, conv_dim = _ssd_dims(cfg)
    return {
        "conv": ((batch, cfg.ssm_conv_width - 1, conv_dim), cfg.torch_dtype),
        "state": ((batch, H, cfg.ssm_head_dim, N), F32),
    }


# ================================================================ RG-LRU (Griffin)
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
        # Lambda init so that a = sigmoid(Lambda)^(8r) sits in [0.9, 0.999]
        "Lambda": torch.linspace(2.0, 6.0, w, **f32),
        "out": uniform_scaled(gen, (w, d), dt, w, device),
    }


_RG_C = 8.0


def _rglru_gates(p, xb):
    r = torch.sigmoid((xb @ p["wa"]).to(F32) + p["ba"])
    i = torch.sigmoid((xb @ p["wi"]).to(F32) + p["bi"])
    log_a = _RG_C * r * sharded.pointwise(F.logsigmoid, p["Lambda"])  # (B,S,W) negative
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * i * xb.to(F32)
    return a, b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, for (B, S, W)
    tensors: `jax.lax.associative_scan` of the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``, in its odd/even
    recursion (the same products in the same order, log2(S) levels of a
    few whole-tensor operations each, no loop over S).  Returns (prod a, h)."""
    S = a.shape[1]
    if S < 2:
        return a, b
    # combine adjacent pairs, scan the half-length sequence recursively
    a0, b0, a1, b1 = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = linear_scan(a0 * a1, b0 * a1 + b1)
    # even outputs: the previous odd output combined with the even input
    a2, b2 = a[:, 2::2], b[:, 2::2]
    if S % 2 == 0:
        pa, pb = odd_a[:, :-1], odd_b[:, :-1]
    else:
        pa, pb = odd_a, odd_b
    even_a = torch.cat([a[:, :1], pa * a2], dim=1)
    even_b = torch.cat([b[:, :1], pb * a2 + b2], dim=1)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = even_a, odd_a
    out_b[:, 0::2], out_b[:, 1::2] = even_b, odd_b
    return out_a, out_b


def rglru_forward(p, x, cfg: ModelConfig, ctx: SeqCtx):
    u = grad_placed(rms_norm(x, p["ln"], cfg.norm_eps))
    xb = u @ p["wx"]
    xb, conv_state = common.causal_conv1d(xb, p["conv_w"])
    a, b = _rglru_gates(p, xb)
    _, h = linear_scan(a, b)  # (B,S,W) fp32
    gate = F.gelu((u @ p["wy"]).to(F32), approximate="tanh")
    out = (h * gate).to(x.dtype) @ p["out"]
    cache = None
    if ctx.make_cache:
        cache = {"conv": conv_state, "h": h[:, -1]}
    return x + placed_like(out, x), cache


def rglru_decode(p, x, cache, cfg: ModelConfig, ctx: SeqCtx):
    u = rms_norm(x, p["ln"], cfg.norm_eps)
    xb = u @ p["wx"]
    xb, conv_state = common.causal_conv1d(xb, p["conv_w"], state=cache["conv"])
    a, b = _rglru_gates(p, xb)  # (B,1,W)
    h = a[:, 0] * cache["h"] + b[:, 0]  # (B,W)
    gate = F.gelu((u @ p["wy"]).to(F32), approximate="tanh")
    out = (h[:, None] * gate).to(x.dtype) @ p["out"]
    return x + placed_like(out, x), {"conv": conv_state, "h": h}


def rglru_cache_spec(cfg: ModelConfig, batch: int):
    w = cfg.lru_width or cfg.d_model
    return {
        "conv": ((batch, 3, w), cfg.torch_dtype),
        "h": ((batch, w), F32),
    }


# ============================================================== kind dispatch
def init_layer(gen, cfg: ModelConfig, kind: str, device):
    if kind in ("attn", "swa"):
        return init_block(gen, cfg, kind, device)
    if kind == "ssd":
        return init_ssd(gen, cfg, device)
    if kind == "rglru":
        return init_rglru(gen, cfg, device)
    raise ValueError(kind)


def layer_forward(p, x, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    if kind in ("attn", "swa"):
        return block_forward(p, x, cfg, ctx, kind)
    if kind == "ssd":
        return ssd_forward(p, x, cfg, ctx)
    if kind == "rglru":
        return rglru_forward(p, x, cfg, ctx)
    raise ValueError(kind)


def layer_decode(p, x, cache, cfg: ModelConfig, ctx: SeqCtx, kind: str):
    if kind in ("attn", "swa"):
        return block_decode(p, x, cache, cfg, ctx, kind)
    if kind == "ssd":
        return ssd_decode(p, x, cache, cfg, ctx)
    if kind == "rglru":
        return rglru_decode(p, x, cache, cfg, ctx)
    raise ValueError(kind)


def layer_cache_spec(cfg: ModelConfig, kind: str, batch: int, cap: int):
    if kind in ("attn", "swa"):
        return attention_cache_spec(cfg, kind, batch, cap)
    if kind == "ssd":
        return ssd_cache_spec(cfg, batch)
    if kind == "rglru":
        return rglru_cache_spec(cfg, batch)
    raise ValueError(kind)
