"""A model's random weights, drawn on the device from the run's seed.

One uniform draw per leaf of the program's parameter tree (12 to 15 leaves
a model: every layer's copy of a weight is one stacked leaf), on the card
from a `torch.Generator` there, in the dtype the leaf is served in, then
copied once into page-locked host memory.  The host copy is the model
store a serverless node keeps: the `Engine` gets it as `init_fn`, so its
host tier holds these very buffers, and the reference reads the same ones.

Bounds: a weight matrix U(-1/sqrt(fan_in), 1/sqrt(fan_in)), as the
program's own init draws it; an RMSNorm scale (applied as 1 + w) and a
q/k/v bias U(-0.1, 0.1) and U(-0.5, 0.5), so that both change the output
and a path that dropped them would show.

A configuration's ``draw`` section says what differs between
architectures (`rule` below):

  * ``qk_gain`` widens the bounds of `wq` and `wk` by that factor.  At gain
    1 the attention scores of such weights spread by about 0.3: every head
    averages its whole context nearly evenly, so a decode step that lost
    its recent tokens, or read a stale cache, serves about the same tokens.
    At gain 3 they spread by about 3 (gain squared), each head leans on a
    few positions, and a lost context changes the served tokens.
  * ``fan_in`` maps a leaf's base name to its contraction width: a number,
    a field of the program's configuration (``"kv_lora_rank"``), or a list
    of those, multiplied (``["num_heads", "v_head_dim"]``).  It overrides
    the llama-style widths of `fan_in`.
  * ``norms`` lists further base names drawn as norm scales.

Without ``fan_in`` and ``norms`` every leaf's bound is the llama-style rule
alone.
"""
from __future__ import annotations

import math
from typing import Mapping

import torch

NORM_BOUND = 0.1
BIAS_BOUND = 0.5
NORMS = ("ln1", "ln2", "final_norm")


def _width(value, cfg) -> int:
    """A ``draw.fan_in`` value: a number, a field of `cfg`, or a list of
    those, multiplied."""
    if isinstance(value, (list, tuple)):
        return math.prod(_width(v, cfg) for v in value)
    return getattr(cfg, value) if isinstance(value, str) else int(value)


def fan_in(name: str, shape: tuple, cfg, rule: Mapping | None = None) -> int:
    """The contraction width of leaf `name`: the configuration's
    ``draw.fan_in`` of its base name where that gives one; else D for the
    embedding, the head and every projection out of the model width, H hd
    for `wo`, the MLP's width for `wd`."""
    base = name.rsplit("/", 1)[-1]
    given = (rule or {}).get("fan_in", {})
    if base in given:
        return _width(given[base], cfg)
    if base == "wo":
        return cfg.num_heads * cfg.resolved_head_dim
    if base == "wd":
        return shape[-2]
    return cfg.d_model


def leaf_bound(name: str, shape: tuple, cfg, rule: Mapping | None = None) -> float:
    """The bound of leaf `name`'s uniform draw under a configuration's
    ``draw`` section `rule`."""
    rule = rule or {}
    base = name.rsplit("/", 1)[-1]
    if base in NORMS or base in rule.get("norms", ()):
        return NORM_BOUND
    if base in ("bq", "bk", "bv"):
        return BIAS_BOUND
    gain = rule.get("qk_gain", 1.0) if base in ("wq", "wk") else 1.0
    return gain / math.sqrt(fan_in(name, shape, cfg, rule))


def draw(cfg, seed: int, device, rule: Mapping | None = None
         ) -> tuple[object, dict[str, torch.Tensor]]:
    """(tree, flat): the program's parameter tree over host tensors
    (page-locked when `device` is a card), and the same tensors by leaf
    name; `rule` is the configuration's ``draw`` section."""
    from repro_torch.models import build_model
    from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten

    dev = torch.device(device)
    specs = build_model(cfg).param_specs()
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = {}
    for name, spec in flatten_params(specs):
        b = leaf_bound(name, tuple(spec.shape), cfg, rule)
        leaf = torch.empty(spec.shape, dtype=spec.dtype, device=dev).uniform_(-b, b, generator=gen)
        if dev.type == "cuda":
            host = torch.empty(spec.shape, dtype=spec.dtype, pin_memory=True)
            host.copy_(leaf)
            leaf = host
        flat[name] = leaf
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    tree = tree_unflatten(tree_structure(specs), list(flat.values()))
    return tree, flat
