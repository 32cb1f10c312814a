"""Unified model API (port of `repro/models/api.py`): build an attention-family
architecture and get its init / prefill / decode functions, its parameter
shapes without materializing them, and concrete random input batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.models.common import resolve_device
from repro_torch.models.tensors import flatten_params

# Sequences longer than this use blockwise attention in the reference; the
# port's prefill always runs the flash kernel, which is blockwise already.
CHUNKED_ATTN_THRESHOLD = 2048


def _check_family(cfg: ModelConfig):
    if cfg.family == "audio":
        raise NotImplementedError(
            "encoder-decoder models are not ported yet — see ROADMAP queue 1")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, *, max_positions: int = 4096, device="cuda"):
        """The port's own random weights from `gen`, on `device` (the card
        unless the caller asks for the CPU)."""
        if self.cfg.family == "audio":
            return encdec.init_params(gen, self.cfg, max_positions=max_positions,
                                      device=device)
        return lm.init_params(gen, self.cfg, device)

    def param_specs(self, *, max_positions: int = 4096):
        """The parameter tree as ``meta`` tensors: names, shapes and dtypes
        in flatten order, with no bytes allocated (the reference's
        `jax.eval_shape(init)`)."""
        return self.init(None, max_positions=max_positions, device="meta")

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch, *, cache_cap: int = 0):
        _check_family(self.cfg)
        S = batch["tokens"].shape[1]
        return lm.forward(
            params, self.cfg, batch["tokens"],
            mrope_positions=batch.get("mrope_positions"),
            vision_embeds=batch.get("vision_embeds"),
            make_cache=True, cache_cap=cache_cap or S)

    # ---------------------------------------------------------------- decode
    def decode(self, params, token, pos, cache):
        _check_family(self.cfg)
        mrope = None
        if self.cfg.mrope_sections:
            # text continuation: all three M-RoPE streams advance together
            mrope = pos[None, :, None].expand(3, pos.shape[0], 1)
        return lm.decode_step(params, self.cfg, token, pos, cache,
                              mrope_positions=mrope)

    # ----------------------------------------------------------- cache specs
    def cache_specs(self, batch: int, cap: int):
        _check_family(self.cfg)
        return lm.cache_specs(self.cfg, batch, cap)

    # ------------------------------------------------- concrete smoke batches
    def make_batch(self, gen: torch.Generator, shape: ShapeConfig, *,
                   device="cuda") -> dict[str, Any]:
        """Concrete random prefill inputs: tokens uniform over the vocab, plus
        the VLM stub's patch embeddings and text-style M-RoPE positions."""
        _check_family(self.cfg)
        device = resolve_device(device)
        if shape.kind not in ("train", "prefill"):
            raise ValueError(f"make_batch builds prefill inputs, not {shape.kind!r}")
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                         dtype=torch.int32).to(device)}
        if cfg.family == "vlm":
            emb = torch.randn((B, cfg.vision_stub_patches, cfg.d_model),
                              generator=gen) * 0.02
            batch["vision_embeds"] = emb.to(device=device, dtype=cfg.torch_dtype)
            batch["mrope_positions"] = torch.arange(
                S, dtype=torch.int32, device=device).expand(3, B, S)
        return batch


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def param_count(params) -> int:
    return sum(t.numel() for _, t in flatten_params(params))


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for _, t in flatten_params(params))
