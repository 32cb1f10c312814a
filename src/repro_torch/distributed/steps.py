"""Distributed step builders (port of `repro/distributed/steps.py`): train /
prefill / serve for any (arch x shape) over a `DeviceMesh`.

Each builder returns a `StepBundle`: the step, ``meta`` stand-ins for its
arguments and their partition specs.  `StepBundle.place` puts concrete (or
fake) trees on the mesh as DTensors by those specs (the reference's
`in_shardings`); the step runs the model's eager PyTorch on the DTensors,
each op sharded by DTensor's propagation, and leaves its outputs placed as
the reference's `out_shardings` say.  Ops with no DTensor sharding strategy
run per rank in `local_map` regions (`models.layers`: the flash kernel K2,
the prefill cache fill, the decode step's cache write).  Plain tensors the
model makes (positions, masks) count as replicated
(`implicit_replication`).

Distributed-optimization features (flags):
  * remat            per-layer activation checkpointing (default on)
  * microbatches     gradient accumulation over a Python loop (memory ceiling)
  * bf16 grads       parameters are bf16, so DP grad all-reduce moves 2 B/elem
  * seq_shard_kv     the decode cache's sequence dim over the model axis

The reference's `donate_argnums` has no PyTorch counterpart: the train step
updates the parameters and AdamW moments in place (`adamw_update`) and
returns them, the serve step returns a new cache, as `launch.train`'s
`train_step` and `Model.decode` do.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import build_model
from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state


@dataclass
class StepBundle:
    fn: Any  # the step, over DTensors placed by `specs`
    args: tuple  # meta tensors (trees) to place and call it with
    desc: str
    specs: tuple = ()  # one partition-spec tree (or one `P`) per argument
    mesh: Any = None

    def place(self, *trees) -> tuple:
        """The step's arguments, each tree's leaves DTensors placed by its
        spec (every rank holds the same full values: no broadcast).  A shard
        may share storage with the tensor it came from (a 1x1 mesh keeps it
        whole), and the train step updates its parameters in place."""
        return tuple(shd.distribute(t, s, self.mesh) for t, s in zip(trees, self.specs))


def _params_shape(model, cfg: ModelConfig, shape: ShapeConfig):
    max_pos = shape.seq_len + 8 if cfg.family == "audio" else 4096
    return model.param_specs(max_positions=max_pos)


def _to_spec(t, spec, mesh):
    """One output leaf placed by `spec` (a plain tensor counts as
    replicated)."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want = shd.placements(spec, mesh)
    return t if tuple(t.placements) == want else t.redistribute(mesh, want)


def _place_out(tree, specs, mesh):
    leaves = [t for _, t in flatten_params(tree)]
    return tree_unflatten(tree_structure(tree),
                          [_to_spec(t, s, mesh) for t, s in zip(leaves, shd.spec_leaves(specs))])


def _microbatch(x, i: int, n: int, dim: int):
    """Microbatch `i` of `n` along the batch dim `dim`: chunk i of every
    rank's own rows, so no data moves (the reference's reshape takes chunk i
    of the global rows; with equal microbatches the accumulated gradient is
    the same sum)."""
    if not isinstance(x, DTensor):
        return x.chunk(n, dim=dim)[i]
    local = x.to_local().chunk(n, dim=dim)[i]
    shape = list(x.shape)
    shape[dim] //= n
    return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                              shape=torch.Size(shape), stride=local.stride())


def loss_and_grads(model, params, batch, **loss_kw):
    """The loss (detached) and a gradient tree like `params`, each gradient
    placed as its parameter: the data-parallel reduction of the partial sums
    over the batch shards (`launch.train.loss_and_grads` over DTensors; call
    it under `implicit_replication`)."""
    leaves = [t.detach().requires_grad_() for _, t in flatten_params(params)]
    loss = model.loss(tree_unflatten(tree_structure(params), leaves), batch, **loss_kw)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(g, DTensor) and g.placements != p.placements else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(tree_structure(params), grads)


def make_train_step(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
                    microbatches: int = 1, remat: bool = True,
                    moe_capacity_factor: float = 1.25,
                    moe_impl: str = "gshard", moe_ep_axis: str = "",
                    opt: Optional[AdamWConfig] = None) -> StepBundle:
    """Loss on the plain attention route (`Model.loss`, as `launch.train`),
    `torch.autograd.grad`, AdamW.  Returns (params, opt_state, loss)."""
    model = build_model(cfg)
    opt = opt or AdamWConfig()
    p_shape = _params_shape(model, cfg, shape)
    o_shape = init_opt_state(p_shape)

    p_spec = shd.params_pspecs(cfg, p_shape, mesh)
    o_spec = shd.opt_pspecs(cfg, o_shape, p_spec)
    b_spec = shd.batch_pspecs(cfg, shape, mesh)

    loss_kw = dict(remat=remat, moe_capacity_factor=moe_capacity_factor,
                   moe_impl=moe_impl, moe_ep_axis=moe_ep_axis)

    def train_step(params, opt_state, batch):
        with implicit_replication():
            if microbatches == 1:
                loss, grads = loss_and_grads(model, params, batch, **loss_kw)
            else:
                grads, losses = None, []
                for i in range(microbatches):
                    mb = {k: _microbatch(x, i, microbatches, 1 if k == "mrope_positions" else 0)
                          for k, x in batch.items()}  # (3, B, S) splits on axis 1
                    loss, g = loss_and_grads(model, params, mb, **loss_kw)
                    g32 = [x.to(torch.float32) for _, x in flatten_params(g)]
                    grads = g32 if grads is None else [a + x for a, x in zip(grads, g32)]
                    losses.append(loss)
                grads = tree_unflatten(tree_structure(params), [g / microbatches for g in grads])
                loss = torch.stack(losses).mean()
            params, opt_state, _ = adamw_update(params, grads, opt_state, opt)
            return params, opt_state, _to_spec(loss, shd.P(), mesh)

    return StepBundle(fn=train_step, args=(p_shape, o_shape, model.input_specs(shape)),
                      desc=f"train_step[{cfg.name} x {shape.name}]",
                      specs=(p_spec, o_spec, b_spec), mesh=mesh)


def make_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig) -> StepBundle:
    """Prefill through the flash kernel (K2 on each rank's own heads).
    Returns (last-position logits, cache).  The reference's `remat` flag is
    not taken: prefill records no autograd, so it changes nothing in either
    package."""
    model = build_model(cfg)
    p_shape = _params_shape(model, cfg, shape)
    p_spec = shd.params_pspecs(cfg, p_shape, mesh)
    b_spec = shd.batch_pspecs(cfg, shape, mesh)
    # the cache prefill leaves is the decode step's (capacity seq_len)
    cache_shape = model.input_specs(dataclasses.replace(shape, kind="decode"))["cache"]
    c_spec = shd.cache_pspecs(cfg, cache_shape, mesh, batch=shape.global_batch)
    dp = shd._dp_for(mesh, shape.global_batch)

    @torch.no_grad()
    def prefill_step(params, batch):
        with implicit_replication():
            logits, cache = model.prefill(params, batch, cache_cap=shape.seq_len)
            return (_to_spec(logits[:, -1], shd.P(dp, "model"), mesh),
                    _place_out(cache, c_spec, mesh))

    return StepBundle(fn=prefill_step, args=(p_shape, model.input_specs(shape)),
                      desc=f"prefill_step[{cfg.name} x {shape.name}]",
                      specs=(p_spec, b_spec), mesh=mesh)


def make_serve_step(cfg: ModelConfig, mesh, shape: ShapeConfig, *,
                    seq_shard_kv: bool = True) -> StepBundle:
    """Single-token decode against a resident KV/state cache of seq_len.

    seq_shard_kv=True shards the cache's sequence dim over the model axis
    (flash-decode placement): each rank writes the new token only into its
    own slice of the ring; the attention over the sharded cache is
    DTensor's own plan.  Returns (logits, cache)."""
    model = build_model(cfg)
    p_shape = _params_shape(model, cfg, shape)
    specs = model.input_specs(shape)  # token, pos, cache
    p_spec = shd.params_pspecs(cfg, p_shape, mesh)
    c_spec = shd.cache_pspecs(cfg, specs["cache"], mesh,
                              batch=shape.global_batch, seq_shard=seq_shard_kv)
    dp = shd._dp_for(mesh, shape.global_batch)

    @torch.no_grad()
    def serve_step(params, token, pos, cache):
        with implicit_replication():
            logits, cache = model.decode(params, token, pos, cache)
            return (_to_spec(logits, shd.P(dp, "model"), mesh),
                    _place_out(cache, c_spec, mesh))

    return StepBundle(
        fn=serve_step, args=(p_shape, specs["token"], specs["pos"], specs["cache"]),
        desc=f"serve_step[{cfg.name} x {shape.name}]",
        specs=(p_spec, shd.P(dp), shd.P(dp), c_spec), mesh=mesh)


def make_step(cfg: ModelConfig, mesh, shape: ShapeConfig, **kw) -> StepBundle:
    if shape.kind == "train":
        train_kw = {k: v for k, v in kw.items()
                    if k in ("microbatches", "remat", "moe_capacity_factor",
                             "moe_impl", "moe_ep_axis", "opt")}
        return make_train_step(cfg, mesh, shape, **train_kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape)
    serve_kw = {k: v for k, v in kw.items() if k in ("seq_shard_kv",)}
    return make_serve_step(cfg, mesh, shape, **serve_kw)
