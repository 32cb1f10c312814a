"""Decoder-only LM assembly (port of `repro/models/lm.py`) covering the dense,
MoE, SSM, hybrid and VLM families.

The parameter tree keeps the reference's stacked layout: `segments[i]` is a
tuple with one dict per layer kind of the segment's repeating unit, and
every leaf carries a leading `repeat` axis.  Where the reference scans over
that axis, the port loops over it: the full-sequence forward unbinds the
stacked leaves (`unbind_tree`), a decode step indexes them (views, no
copies either way); with `remat` each unit is recomputed in backward, as the
reference's `jax.checkpoint` of its scan body is.  A hybrid's segments may
differ in their units (RecurrentGemma: (rglru, rglru, swa) x 12, then
(rglru, rglru)), and one unit's caches may mix ring K/V with recurrence
states.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.common import F32, resolve_device, rms_norm, uniform_scaled


def stack_trees(trees: list):
    """Stack a list of identical trees leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def unbind_tree(tree) -> list:
    """The trees of every index along axis 0 of the leaves (`torch.unbind`:
    views, and in backward one node per stacked leaf that stacks the
    per-index gradients once, where indexing each index apart would add a
    full-size gradient of the stacked leaf per index)."""
    if isinstance(tree, dict):
        parts = {k: unbind_tree(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unbind_tree(v) for v in tree]
        return [type(tree)(p[i] for p in parts) for i in range(len(parts[0]))]
    return list(tree.unbind(0))


def _index_tree(tree, i: int):
    """Leaf `i` along axis 0 of every leaf (views)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index_tree(v, i) for v in tree)
    return tree[i]


# ------------------------------------------------------------------------ init
def init_segment(gen, cfg: ModelConfig, unit: tuple[str, ...], repeat: int,
                 device):
    return stack_trees([tuple(L.init_layer(gen, cfg, kind, device) for kind in unit)
                        for _ in range(repeat)])


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, device="cuda"):
    """The port's own random init (never compared with the reference's),
    drawn from `gen` and placed on `device`.  With ``device="meta"`` it
    yields shapes and dtypes only (`gen` unused)."""
    device = resolve_device(device)
    params: dict[str, Any] = {
        "embed": uniform_scaled(gen, (cfg.padded_vocab, cfg.d_model), cfg.torch_dtype,
                                cfg.d_model, device),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
    }
    params["segments"] = [init_segment(gen, cfg, unit, repeat, device)
                          for unit, repeat in cfg.segments]
    if not cfg.tie_embeddings:
        params["lm_head"] = uniform_scaled(gen, (cfg.d_model, cfg.padded_vocab),
                                           cfg.torch_dtype, cfg.d_model, device)
    return params


# -------------------------------------------------------------------- embedding
def embed_tokens(params, cfg: ModelConfig, tokens, vision_embeds=None):
    x = L.embed_lookup(params["embed"], tokens)  # (B, S, D)
    if vision_embeds is not None:
        # VLM stub frontend: the first `P` positions carry precomputed patch
        # embeddings
        P = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, P:]], dim=1)
    return x


def unembed(params, cfg: ModelConfig, x):
    x = L.grad_placed(rms_norm(x, params["final_norm"], cfg.norm_eps))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


# ---------------------------------------------------------------------- forward
def _unit_forward(unit_params, x, cfg, ctx, unit):
    caches = []
    for i, kind in enumerate(unit):
        x, c = L.layer_forward(unit_params[i], x, cfg, ctx, kind)
        caches.append(c)
    return x, tuple(caches)


def forward(params, cfg: ModelConfig, tokens, *, positions=None,
            mrope_positions=None, vision_embeds=None, make_cache=False,
            cache_cap=0, attn_chunked=False, remat=True,
            moe_capacity_factor=L.PREFILL_CAPACITY_FACTOR, moe_impl="scatter",
            moe_ep_axis="", q_chunk=512, kv_chunk=1024, kernel_attention=True):
    """Full-sequence forward (train / prefill).  Returns (logits, caches|None);
    caches have the reference's layout, `caches[seg][unit_idx][key]` with a
    leading repeat axis.

    `kernel_attention` picks the attention route: the flash kernel (prefill,
    at positions arange(S)) or the reference's plain attention at
    `positions` (the loss; `attn_chunked` then selects the blockwise form).
    `remat` recomputes each unit of a segment in backward (the reference's
    `jax.checkpoint` of its scan body), saving only the MoE combine output."""
    B, S = tokens.shape
    arange = positions is None
    if arange:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    ctx = L.SeqCtx(positions=positions, mrope_positions=mrope_positions,
                   make_cache=make_cache, cache_cap=cache_cap or S,
                   kernel_attention=kernel_attention, arange_positions=arange,
                   attn_chunked=attn_chunked, q_chunk=q_chunk, kv_chunk=kv_chunk,
                   moe_capacity_factor=moe_capacity_factor, moe_impl=moe_impl,
                   moe_ep_axis=moe_ep_axis)
    x = embed_tokens(params, cfg, tokens, vision_embeds)
    caches = []
    for seg_params, (unit, _) in zip(params["segments"], cfg.segments):
        per_layer = []
        for unit_params in unbind_tree(seg_params):
            if remat:
                x, unit_caches = L.remat(_unit_forward, unit_params, x, cfg, ctx, unit)
            else:
                x, unit_caches = _unit_forward(unit_params, x, cfg, ctx, unit)
            per_layer.append(unit_caches)
        caches.append(stack_trees(per_layer) if make_cache else None)
    logits = unembed(params, cfg, x)
    return logits, (caches if make_cache else None)


# ----------------------------------------------------------------------- decode
def decode_step(params, cfg: ModelConfig, token, pos, caches, *,
                mrope_positions=None, moe_capacity_factor=L.DECODE_CAPACITY_FACTOR):
    """One decode step over the ring caches and recurrence states. token:
    (B,) int32; pos: (B,) int32 absolute position; caches: as produced by
    forward(make_cache=True).  Returns (logits, caches)."""
    positions = pos[:, None]  # (B, 1)
    ctx = L.SeqCtx(positions=positions, mrope_positions=mrope_positions,
                   moe_capacity_factor=moe_capacity_factor)
    x = L.embed_lookup(params["embed"], token)[:, None, :]  # (B, 1, D)

    new_caches = []
    for seg_params, seg_cache, (unit, repeat) in zip(
            params["segments"], caches, cfg.segments):
        per_layer = []
        for r in range(repeat):
            unit_params = _index_tree(seg_params, r)
            unit_cache = _index_tree(seg_cache, r)
            new_unit_cache = []
            for i, kind in enumerate(unit):
                x, c = L.layer_decode(unit_params[i], x, unit_cache[i], cfg, ctx, kind)
                new_unit_cache.append(c)
            per_layer.append(tuple(new_unit_cache))
        new_caches.append(stack_trees(per_layer))
    logits = unembed(params, cfg, x)[:, 0]  # (B, V)
    return logits, new_caches


# ------------------------------------------------------------------ cache specs
def cache_specs(cfg: ModelConfig, batch: int, cap: int):
    """(shape, dtype) tree matching forward(make_cache=True) output."""
    segs = []
    for unit, repeat in cfg.segments:
        unit_specs = tuple(
            {k: ((repeat, *shape), dt)
             for k, (shape, dt) in L.layer_cache_spec(cfg, kind, batch, cap).items()}
            for kind in unit
        )
        segs.append(unit_specs)
    return segs


# -------------------------------------------------------------------------- loss
def next_token_loss(logits, tokens):
    """Next-token cross-entropy (fp32 logsumexp), mean over B*(S-1) tokens."""
    logits = logits[:, :-1].to(F32)
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # DTensor's gather over a vocab-sharded dim leaves a masked partial
        # sum that its reduction cannot take after the [..., 0]; a mask of
        # the gold column summed over the vocab reduces one (B, S) tensor
        hit = torch.arange(logits.shape[-1], device=logits.device) == targets[..., None]
        gold = torch.where(hit, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold).mean()


def lm_loss(params, cfg: ModelConfig, tokens, **fwd_kwargs):
    """Next-token cross-entropy of `forward` on the plain attention route
    (the kernels have no backward), mean over B*(S-1) tokens."""
    logits, _ = forward(params, cfg, tokens, kernel_attention=False, **fwd_kwargs)
    return next_token_loss(logits, tokens)
