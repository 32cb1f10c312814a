"""Gradient compression for data-parallel reduction (port of
`repro/distributed/compress.py`).

`int8_all_reduce` implements compressed DP gradient aggregation with true
int8 wire traffic: each shard quantizes its gradient (symmetric, per-tensor
scale), ALL-GATHERS the int8 payloads (int8 on the wire — 4x less than an
fp32 ring all-reduce, 2x less than bf16), and dequantizes + averages
locally.  Error feedback (residual carried to the next step) keeps the
quantization noise unbiased over time, per 1-bit-Adam-style schemes.

The collectives are `torch.distributed`'s functional ones
(`all_gather_into_tensor` of the int8 payload and of the fp32 scales, and
an `all_reduce` of the loss), over one dim of a `DeviceMesh` or several
flattened into one group; NCCL and gloo both gather int8 tensors.  Params
are replicated across the compressed axes (the pure-DP tier, e.g. the pod
axis of the production mesh).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor

from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten

F32 = torch.float32


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: scale = max|g| / 127 (+1e-30), values
    rounded half to even (`torch.round`, as `jnp.round`) and clipped to
    +-127.  Returns (q int8, scale fp32 0-d)."""
    scale = g.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def _group(mesh, dp_axes: tuple[str, ...]):
    """The process group of the mesh dims `dp_axes` (flattened into one
    when there are several, the first major)."""
    sub = mesh[tuple(dp_axes)] if len(dp_axes) > 1 else mesh[dp_axes[0]]
    return sub._flatten() if sub.ndim > 1 else sub


# `all_gather_single` succeeds `all_gather_tensor` (same signature) in newer
# PyTorch, which warns on the old name
_all_gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """(N, *t.shape): every rank's `t`, stacked in group order."""
    return funcol.wait_tensor(_all_gather(t[None], 0, group))


def int8_all_reduce(g: torch.Tensor, group) -> torch.Tensor:
    """Mean of `g` across `group` with int8 wire traffic.

    all_gather moves (N-1)/N x 1 byte/elem vs the ring all-reduce's
    ~2 x 4 bytes/elem — an ~8x wire reduction at f32, ~4x at bf16.
    """
    q, scale = quantize_int8(g)
    qs = _gather(q, group)  # (N, ...) int8 on the wire
    ss = _gather(scale, group)  # (N,) f32 (tiny)
    deq = qs.to(F32) * ss.reshape((-1,) + (1,) * g.ndim)
    return deq.mean(dim=0)


def _local(x: torch.Tensor, batch_axis: int, rank: int, n: int) -> torch.Tensor:
    """This rank's rows of a batch leaf: a DTensor's local shard, or chunk
    `rank` of `n` of a full tensor every rank holds (the reference's
    shard_map in_spec)."""
    if isinstance(x, DTensor):
        return x.to_local()
    return x.chunk(n, dim=batch_axis)[rank]


def compressed_grad_fn(loss_fn, mesh, dp_axes: tuple[str, ...], *,
                       batch_axis: int = 0, error_feedback: bool = True):
    """Wrap `loss_fn(params, batch) -> scalar` into a gradient function
    whose DP reduction is int8-compressed.

    Params (and the residual) are replicated across `dp_axes`: every rank
    holds the same values.  Batch leaves are sharded on `batch_axis` (a
    DTensor's local shard, or a full tensor of which each rank takes its
    chunk).  Returns grads_fn(params, batch, residual) -> (grads,
    new_residual, loss), the loss averaged over the group (`pmean`)."""
    group = _group(mesh, tuple(dp_axes))
    n, rank = group.size(), group.get_local_rank()

    def grads_fn(params, batch, residual):
        local = {k: _local(x, batch_axis, rank, n) for k, x in batch.items()}
        leaves = [t.detach().requires_grad_() for _, t in flatten_params(params)]
        structure = tree_structure(params)
        loss = loss_fn(tree_unflatten(structure, leaves), local)
        g = torch.autograd.grad(loss, leaves, materialize_grads=True)

        grads, new_res = [], []
        for gi, (_, ri) in zip(g, flatten_params(residual)):
            gi = gi.to(F32) + ri
            q, scale = quantize_int8(gi)
            new_res.append(gi - q.to(F32) * scale if error_feedback
                           else torch.zeros_like(gi))
            qs = _gather(q, group)
            ss = _gather(scale, group)
            deq = qs.to(F32) * ss.reshape((-1,) + (1,) * gi.ndim)
            grads.append(deq.mean(dim=0))
        loss = funcol.wait_tensor(funcol.all_reduce(loss.detach(), "sum", group)) / n
        return (tree_unflatten(structure, grads), tree_unflatten(structure, new_res), loss)

    return grads_fn


def residual_like(params: Any) -> Any:
    """Zero fp32 residuals shaped like `params` (the first step's)."""
    return tree_unflatten(tree_structure(params),
                          [torch.zeros(t.shape, dtype=F32, device=t.device)
                           for _, t in flatten_params(params)])
