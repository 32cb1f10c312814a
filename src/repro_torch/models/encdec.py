"""Whisper-style encoder-decoder backbone (port of `repro/models/encdec.py`,
audio family).

The conv/mel frontend is a stub: `enc_frames` arrives as precomputed frame
embeddings (B, encoder_seq, d_model).  LayerNorm + GeLU MLP (+ biases) per
the Whisper architecture; sinusoidal encoder positions, learned decoder
positions; cross-attention K/V computed once at prefill and cached.

Attention: at prefill the encoder's non-causal self-attention and the
decoder's causal self-attention (equal query and key lengths, arange
positions) run the flash kernel (`kernels.ops`); cross-attention (query and
key lengths differ), every decode step and the whole loss (``kernel_attention
=False``: the kernel has no backward) run the plain `attention_dense`, as the
reference computes all of them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common
from repro_torch.models.common import F32, resolve_device, uniform_scaled
from repro_torch.models import layers as L
from repro_torch.models.layers import _out_proj, _proj
from repro_torch.models.lm import next_token_loss, stack_trees, unbind_tree


def layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.to(F32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * (1.0 + scale) + bias).to(x.dtype)


def _init_mha(gen, cfg: ModelConfig, device):
    d, hd, H = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads
    dt = cfg.torch_dtype
    return {
        "wq": uniform_scaled(gen, (d, H, hd), dt, d, device),
        "bq": torch.zeros((H, hd), dtype=dt, device=device),
        "wk": uniform_scaled(gen, (d, H, hd), dt, d, device),
        "wv": uniform_scaled(gen, (d, H, hd), dt, d, device),
        "bv": torch.zeros((H, hd), dtype=dt, device=device),
        "wo": uniform_scaled(gen, (H, hd, d), dt, H * hd, device),
        "bo": torch.zeros((d,), dtype=dt, device=device),
    }


def _init_mlp(gen, cfg: ModelConfig, device):
    d, f = cfg.d_model, cfg.d_ff
    dt = cfg.torch_dtype
    return {
        "wi": uniform_scaled(gen, (d, f), dt, d, device),
        "bi": torch.zeros((f,), dtype=dt, device=device),
        "wo": uniform_scaled(gen, (f, d), dt, f, device),
        "bo": torch.zeros((d,), dtype=dt, device=device),
    }


def _norms(cfg: ModelConfig, device, *names):
    return {n: torch.zeros((cfg.d_model,), dtype=F32, device=device) for n in names}


def _init_enc_layer(gen, cfg, device):
    return {**_norms(cfg, device, "ln1_s", "ln1_b", "ln2_s", "ln2_b"),
            "attn": _init_mha(gen, cfg, device), "mlp": _init_mlp(gen, cfg, device)}


def _init_dec_layer(gen, cfg, device):
    return {**_norms(cfg, device, "ln1_s", "ln1_b", "ln2_s", "ln2_b", "ln3_s", "ln3_b"),
            "self_attn": _init_mha(gen, cfg, device),
            "cross_attn": _init_mha(gen, cfg, device),
            "mlp": _init_mlp(gen, cfg, device)}


def init_params(gen, cfg: ModelConfig, *, max_positions: int = 4096, device="cuda"):
    device = resolve_device(device)
    d = cfg.d_model
    return {
        "embed": uniform_scaled(gen, (cfg.padded_vocab, d), cfg.torch_dtype, d, device),
        "dec_pos": uniform_scaled(gen, (max_positions, d), cfg.torch_dtype, d, device),
        "enc_layers": stack_trees([_init_enc_layer(gen, cfg, device)
                                   for _ in range(cfg.encoder_layers)]),
        "dec_layers": stack_trees([_init_dec_layer(gen, cfg, device)
                                   for _ in range(cfg.num_layers)]),
        **_norms(cfg, device, "enc_ln_s", "enc_ln_b", "dec_ln_s", "dec_ln_b"),
    }


def _mha(p, xq, xkv, *, causal: bool, kernel_attention: bool = True):
    """Self-attention at prefill (xq is xkv: the flash kernel, unless the
    caller asks for the plain route) or cross-attention (the plain dense
    attention).  Returns (y, (k, v))."""
    q = _proj(xq, p["wq"]) + p["bq"]
    k = _proj(xkv, p["wk"])
    v = _proj(xkv, p["wv"]) + p["bv"]

    def attend(q, k, v):
        if xq is xkv and kernel_attention:
            return kops.flash_attention(q, k, v, causal=causal)
        return common.attention_dense(q, k, v, causal=causal)

    return _out_proj(L.run_attention(attend, q, k, v), p["wo"]) + p["bo"], (k, v)


def _sinusoid_pos(S, d, dtype, device):
    pos = torch.arange(S, dtype=F32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=F32, device=device)[None, :]
    ang = pos / 10_000.0 ** (2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _layers(stacked, n):
    layers = unbind_tree(stacked)
    assert len(layers) == n
    return layers


def encode(params, cfg: ModelConfig, enc_frames, *, kernel_attention: bool = True):
    """enc_frames: (B, Se, D) stub embeddings -> encoder hidden states."""
    x = enc_frames + _sinusoid_pos(enc_frames.shape[1], cfg.d_model, enc_frames.dtype,
                                   enc_frames.device)
    for p in _layers(params["enc_layers"], cfg.encoder_layers):
        h = L.grad_placed(layer_norm(x, p["ln1_s"], p["ln1_b"]))
        a, _ = _mha(p["attn"], h, h, causal=False, kernel_attention=kernel_attention)
        x = x + L.placed_like(a, x)
        m = common.gelu_mlp(L.grad_placed(layer_norm(x, p["ln2_s"], p["ln2_b"])),
                            p["mlp"]["wi"], p["mlp"]["bi"], p["mlp"]["wo"], p["mlp"]["bo"])
        x = x + L.placed_like(m, x)
    return L.grad_placed(layer_norm(x, params["enc_ln_s"], params["enc_ln_b"]))


def _dec_layer(p, x, enc_out_or_kv, ctx_positions, *, cached_cross=False,
               self_kv=None, kv_positions=None, kv_valid=None, kernel_attention=True):
    """One decoder layer. Returns (x, (self_k, self_v), (cross_k, cross_v))."""
    h = L.grad_placed(layer_norm(x, p["ln1_s"], p["ln1_b"]))
    if self_kv is None:  # prefill / loss: positions are arange(S)
        a, skv = _mha(p["self_attn"], h, h, causal=True,
                      kernel_attention=kernel_attention)
    else:
        # decode: caller provides updated cache (k, v) incl. current token
        q = _proj(h, p["self_attn"]["wq"]) + p["self_attn"]["bq"]

        def attend(q, k, v, qp, kp, valid):
            return common.attention_dense(q, k, v, causal=False, q_positions=qp,
                                          kv_positions=kp, kv_valid=valid)

        o = L.run_attention(attend, q, self_kv[0], self_kv[1], ctx_positions, kv_positions,
                            kv_valid)
        a = _out_proj(o, p["self_attn"]["wo"]) + p["self_attn"]["bo"]
        skv = self_kv
    x = x + L.placed_like(a, x)

    h = L.grad_placed(layer_norm(x, p["ln2_s"], p["ln2_b"]))
    if cached_cross:
        ck, cv = enc_out_or_kv
        q = _proj(h, p["cross_attn"]["wq"]) + p["cross_attn"]["bq"]
        o = L.run_attention(lambda q, k, v: common.attention_dense(q, k, v, causal=False),
                            q, ck, cv)
        c = _out_proj(o, p["cross_attn"]["wo"]) + p["cross_attn"]["bo"]
        ckv = (ck, cv)
    else:
        c, ckv = _mha(p["cross_attn"], h, enc_out_or_kv, causal=False)
    x = x + L.placed_like(c, x)

    m = common.gelu_mlp(L.grad_placed(layer_norm(x, p["ln3_s"], p["ln3_b"])),
                        p["mlp"]["wi"], p["mlp"]["bi"], p["mlp"]["wo"], p["mlp"]["bo"])
    return x + L.placed_like(m, x), skv, ckv


def _dec_body(p, x, enc, kernel_attention):
    return _dec_layer(p, x, enc, None, kernel_attention=kernel_attention)


def forward(params, cfg: ModelConfig, tokens, enc_frames, *, make_cache=False,
            cache_cap=0, remat=True, kernel_attention=True):
    """Teacher-forced decode over the full token sequence (train / prefill).
    `remat` recomputes each decoder layer in backward (the reference's
    `jax.checkpoint` of its decoder scan body; the encoder is not remat'd)."""
    B, S = tokens.shape
    enc = encode(params, cfg, enc_frames, kernel_attention=kernel_attention)
    x = L.embed_lookup(params["embed"], tokens) + params["dec_pos"][:S][None]
    kvs = []
    for p in _layers(params["dec_layers"], cfg.num_layers):
        if remat:
            x, skv, ckv = L.remat(_dec_body, p, x, enc, kernel_attention)
        else:
            x, skv, ckv = _dec_body(p, x, enc, kernel_attention)
        if make_cache:
            kvs.append((skv, ckv))
    x = L.grad_placed(layer_norm(x, params["dec_ln_s"], params["dec_ln_b"]))
    logits = x @ params["embed"].T

    cache = None
    if make_cache:
        (sk, sv), (ck, cv) = stack_trees(kvs)
        cap = cache_cap or S
        # re-pack self-attention KV into a fixed-capacity cache
        sk, sv = _pad_cache(sk, cap), _pad_cache(sv, cap)
        slots = torch.arange(cap, dtype=torch.int32, device=tokens.device)
        kv_pos = torch.where(slots < S, slots, -1).expand(B, cap).contiguous()
        cache = {"self_k": sk, "self_v": sv, "kv_pos": kv_pos,
                 "cross_k": ck, "cross_v": cv}
    return logits, cache


def _pad_cache(kv, cap):
    # kv: (L, B, S, H, hd) -> (L, B, cap, H, hd)
    S = kv.shape[2]
    if S >= cap:
        return kv[:, :, :cap]
    return F.pad(kv, (0, 0, 0, 0, 0, cap - S))


def decode_step(params, cfg: ModelConfig, token, pos, cache):
    """One decoder token. token: (B,), pos: (B,), cache from forward().
    The new token's K/V go to ring slot ``pos % cap``; the input cache is
    untouched, as in the reference."""
    x = (L.embed_lookup(params["embed"], token)[:, None, :]
         + L.embed_lookup(params["dec_pos"], pos)[:, None, :])
    positions = pos[:, None]
    kv_pos = L.slot_write(cache["kv_pos"], pos.to(torch.int32), pos)  # shared across layers
    kv_valid = kv_pos >= 0

    new_k, new_v = [], []
    for i, p in enumerate(_layers(params["dec_layers"], cfg.num_layers)):
        hq = layer_norm(x, p["ln1_s"], p["ln1_b"])
        nk = _proj(hq, p["self_attn"]["wk"])
        nv = _proj(hq, p["self_attn"]["wv"]) + p["self_attn"]["bv"]
        sk = L.slot_write(cache["self_k"][i], nk[:, 0], pos)
        sv = L.slot_write(cache["self_v"][i], nv[:, 0], pos)
        x, _, _ = _dec_layer(p, x, (cache["cross_k"][i], cache["cross_v"][i]), positions,
                             cached_cross=True, self_kv=(sk, sv), kv_positions=kv_pos,
                             kv_valid=kv_valid)
        new_k.append(sk)
        new_v.append(sv)
    x = layer_norm(x, params["dec_ln_s"], params["dec_ln_b"])
    logits = (x @ params["embed"].T)[:, 0]
    new_cache = {"self_k": torch.stack(new_k), "self_v": torch.stack(new_v),
                 "kv_pos": kv_pos, "cross_k": cache["cross_k"],
                 "cross_v": cache["cross_v"]}
    return logits, new_cache


def cache_specs(cfg: ModelConfig, batch: int, cap: int):
    H, hd, Ld = cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers
    dt = cfg.torch_dtype
    Se = cfg.encoder_seq
    return {
        "self_k": ((Ld, batch, cap, H, hd), dt),
        "self_v": ((Ld, batch, cap, H, hd), dt),
        "kv_pos": ((batch, cap), torch.int32),
        "cross_k": ((Ld, batch, Se, H, hd), dt),
        "cross_v": ((Ld, batch, Se, H, hd), dt),
    }


def loss(params, cfg: ModelConfig, tokens, enc_frames, **kw):
    """Next-token cross-entropy of the teacher-forced decoder on the plain
    attention route, mean over B*(S-1) tokens."""
    logits, _ = forward(params, cfg, tokens, enc_frames, kernel_attention=False, **kw)
    return next_token_loss(logits, tokens)
