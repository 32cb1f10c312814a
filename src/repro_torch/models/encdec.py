"""Whisper-style encoder-decoder backbone (port of `repro/models/encdec.py`):
the parameter tree only, so the audio family's tensor records match the
reference's.  Its forward and decode are not ported yet (`Model.prefill` /
`Model.decode` raise for the audio family)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import F32, resolve_device, uniform_scaled
from repro_torch.models.lm import stack_trees


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
