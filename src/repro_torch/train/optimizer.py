"""AdamW over the port's parameter trees (port of `repro/train/optimizer.py`):
bf16 params, fp32 moments, global-norm clip, linear warmup.

Plain functions over nested dicts / lists / tuples of tensors, leaf for leaf
in `models.tensors.flatten_params` order.  Each update is computed in fp32
and cast back to the param's dtype once, in place (the reference returns
new trees; at qwen3-moe's width a second copy of the moments does not fit
the card beside the first); decay applies to matrices only
(``ndim >= 2``; norms and biases are exempt).  `torch.optim.AdamW` is not
this function: it keeps its moments in the param's dtype and decays every
tensor.  The step counter is a 0-d int32 tensor on the params' device, so a
training loop never reads the device to update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def _leaves(tree) -> list[torch.Tensor]:
    return [t for _, t in flatten_params(tree)]


def _like(tree, leaves):
    return tree_unflatten(tree_structure(tree), leaves)


def init_opt_state(params) -> dict[str, Any]:
    leaves = _leaves(params)
    zeros = [torch.zeros(p.shape, dtype=F32, device=p.device) for p in leaves]
    return {
        "m": _like(params, zeros),
        "v": _like(params, [z.clone() for z in zeros]),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).to(F32) / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.to(F32).square().sum() for x in _leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step. Returns (params, new_state, metrics).  The params and
    the moments are updated in place, leaf by leaf, so a step holds one copy
    of the optimizer state and a few fp32 temporaries of its largest leaf;
    every value stays on the device (metrics: the raw gradient norm and the
    lr)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, state["step"])
    b1c = 1 - cfg.b1 ** step.to(F32)
    b2c = 1 - cfg.b2 ** step.to(F32)

    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(state["m"]),
                          _leaves(state["v"])):
        g = g.to(F32) * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        denom = torch.div(v, b2c, out=g).sqrt_().add_(cfg.eps)
        delta = torch.div(m, b1c).div_(denom)
        del g, denom
        if p.dim() >= 2:  # decay matrices only (norms/bias exempt)
            delta.add_(p.to(F32), alpha=cfg.weight_decay)
        p.copy_(p.to(F32).sub_(delta.mul_(lr)))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
