"""Unified model API (port of `repro/models/api.py`): build any assigned
architecture and get its init / loss / prefill / decode functions, its
parameter shapes without materializing them, and concrete random input
batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec, lm
from repro_torch.models.common import resolve_device
from repro_torch.models.tensors import flatten_params

# The loss of a sequence longer than this uses blockwise (online-softmax)
# attention so the score matrix never materializes.  Prefill always runs the
# flash kernel, which is blockwise already.
CHUNKED_ATTN_THRESHOLD = 2048


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

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, *, remat: bool = True,
             moe_capacity_factor: float = 1.25,
             moe_impl: str = "scatter") -> torch.Tensor:
        """Next-token cross-entropy (a 0-d fp32 tensor) on the plain
        attention route, which autograd differentiates."""
        cfg = self.cfg
        if cfg.family == "audio":
            return encdec.loss(params, cfg, batch["tokens"], batch["enc_frames"],
                               remat=remat)
        S = batch["tokens"].shape[1]
        return lm.lm_loss(
            params, cfg, batch["tokens"],
            mrope_positions=batch.get("mrope_positions"),
            vision_embeds=batch.get("vision_embeds"),
            attn_chunked=S > CHUNKED_ATTN_THRESHOLD,
            remat=remat, moe_capacity_factor=moe_capacity_factor,
            moe_impl=moe_impl)

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch, *, cache_cap: int = 0):
        """Logits and decode caches of the prompt, through the flash kernel."""
        cfg = self.cfg
        if cfg.family == "audio":
            return encdec.forward(params, cfg, batch["tokens"], batch["enc_frames"],
                                  make_cache=True, cache_cap=cache_cap, remat=False)
        S = batch["tokens"].shape[1]
        return lm.forward(
            params, cfg, batch["tokens"],
            mrope_positions=batch.get("mrope_positions"),
            vision_embeds=batch.get("vision_embeds"),
            make_cache=True, cache_cap=cache_cap or S, remat=False)

    # ---------------------------------------------------------------- decode
    def decode(self, params, token, pos, cache):
        if self.cfg.family == "audio":
            return encdec.decode_step(params, self.cfg, token, pos, cache)
        mrope = None
        if self.cfg.mrope_sections:
            # text continuation: all three M-RoPE streams advance together
            mrope = pos[None, :, None].expand(3, pos.shape[0], 1)
        return lm.decode_step(params, self.cfg, token, pos, cache,
                              mrope_positions=mrope)

    # ----------------------------------------------------------- cache specs
    def cache_specs(self, batch: int, cap: int):
        if self.cfg.family == "audio":
            return encdec.cache_specs(self.cfg, batch, cap)
        return lm.cache_specs(self.cfg, batch, cap)

    # ------------------------------------------------- concrete smoke batches
    def make_batch(self, gen: torch.Generator, shape: ShapeConfig, *,
                   device="cuda") -> dict[str, Any]:
        """Concrete random inputs of the reference's `make_batch` for `shape`.

        train / prefill: tokens uniform over the vocab, plus the audio stub's
        encoder frames (B, encoder_seq, d_model) or the VLM stub's patch
        embeddings (standard normal cast to the model's dtype, then scaled by
        0.02 in it) and text-style M-RoPE positions.  decode: one token per
        sequence, positions 0 and a cache of capacity `shape.seq_len` (float
        leaves drawn as the embeddings are, integer ones 0)."""
        device = resolve_device(device)
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len

        def tokens(*size):
            return torch.randint(0, cfg.vocab_size, size, generator=gen,
                                 dtype=torch.int32).to(device)

        def normal(size, dtype):
            return torch.randn(size, generator=gen).to(device=device, dtype=dtype) * 0.02

        if shape.kind in ("train", "prefill"):
            batch = {"tokens": tokens(B, S)}
            if cfg.family == "audio":
                batch["enc_frames"] = normal((B, cfg.encoder_seq, cfg.d_model),
                                             cfg.torch_dtype)
            if cfg.family == "vlm":
                batch["vision_embeds"] = normal((B, cfg.vision_stub_patches, cfg.d_model),
                                                cfg.torch_dtype)
                batch["mrope_positions"] = torch.arange(
                    S, dtype=torch.int32, device=device).expand(3, B, S)
            return batch

        def leaves(spec: dict):
            return {key: (torch.zeros(shp, dtype=dt, device=device)
                          if dt == torch.int32 else normal(shp, dt))
                    for key, (shp, dt) in spec.items()}

        specs = self.cache_specs(B, S)
        cache = (leaves(specs) if cfg.family == "audio"
                 else [tuple(leaves(unit) for unit in seg) for seg in specs])
        return {"token": tokens(B), "pos": torch.zeros((B,), dtype=torch.int32, device=device),
                "cache": cache}


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def param_count(params) -> int:
    return sum(t.numel() for _, t in flatten_params(params))


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for _, t in flatten_params(params))
