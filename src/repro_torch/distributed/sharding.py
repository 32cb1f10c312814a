"""Name-based sharding rules (port of `repro/distributed/sharding.py`): map
every parameter / input / cache leaf to a partition spec over the
production mesh axes ("pod", "data", "model"), then to DTensor placements.

Strategy (DESIGN.md §5):
  DP   batch over ("pod", "data")
  TP   Megatron-style column->row pairs: attention heads & ffn over "model";
       GQA models whose kv-head count doesn't divide the axis shard head_dim
       instead (or replicate tiny tensors);
  EP   MoE experts over "model" when divisible (qwen3: 128/16), otherwise the
       per-expert ffn dim (mixtral: 8 experts, shard d_ff);
  SP   optional sequence sharding for long prefill (see train_step).

Every rule degrades to replication when nothing divides — correctness first,
the roofline/perf loop tightens the rest.

The rules are the reference's, entry for entry, over `P`: one entry per
tensor dim, each None (replicated), a mesh axis name, or a tuple of axis
names (one tensor dim split over several mesh dims, the first major), as
JAX's `PartitionSpec`.  `placements` turns a `P` into one `Shard(d)` /
`Replicate()` per dim of a `DeviceMesh` and `distribute` places a tree by
its specs (together the reference's `named` and `in_shardings`).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import make_mesh_compat  # noqa: F401  (re-export, as
# the reference's snippets build their meshes through this module)
from repro_torch.models.tensors import flatten_params, tree_structure, tree_unflatten

DP_AXES = ("pod", "data")  # batch axes (pod present only in multi-pod mesh)
TP = "model"


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` (or any object with its
    `mesh_dim_names` and `shape`)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _dp(mesh):
    axes = tuple(a for a in DP_AXES if a in mesh.mesh_dim_names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _dp_size(mesh) -> int:
    sizes = _axis_sizes(mesh)
    n = 1
    for a in DP_AXES:
        n *= sizes.get(a, 1)
    return n


def _dp_for(mesh, batch: int):
    """DP axes when the batch divides them, else None (replicate batch)."""
    return _dp(mesh) if batch % _dp_size(mesh) == 0 else None


def _div(n: int, k: int) -> bool:
    return n % k == 0 and n >= k


def param_spec(path: str, shape: tuple[int, ...], cfg: ModelConfig,
               tp_size: int) -> P:
    """Partition spec for one parameter leaf (path = 'segments/0/1/attn/wq')."""
    ndim = len(shape)
    stacked = path.startswith(("segments/", "enc_layers", "dec_layers"))
    base = 1 if stacked else 0  # leading scan-stack dim stays unsharded

    def at(dim: int) -> P:
        spec = [None] * ndim
        spec[dim] = TP
        return P(*spec)

    rep = P(*([None] * ndim))
    if ndim - base <= 1:  # norms, biases, 1-D gates
        last = ndim - 1
        if ndim and _div(shape[last], tp_size) and shape[last] >= 4 * tp_size \
                and any(t in path for t in ("Lambda", "ba", "bi", "gnorm")):
            return at(last)
        return rep

    leaf = path.rsplit("/", 1)[-1]

    # ---- attention projections (coherent GQA scheme: if Q heads shard, KV
    # heads shard when divisible and REPLICATE otherwise — Megatron-GQA.
    # Only when Q heads don't divide either does everything fall to head_dim.)
    heads_ok = _div(cfg.num_heads, tp_size)
    kv_ok = _div(cfg.num_kv_heads, tp_size)
    if leaf in ("wq", "bq"):
        heads_dim = base + 1 if leaf == "wq" else base
        if heads_ok:
            return at(heads_dim)
        return at(ndim - 1) if _div(shape[ndim - 1], tp_size) else rep
    if leaf in ("wk", "wv", "bk", "bv"):
        heads_dim = base + 1 if leaf.startswith("w") else base
        if kv_ok:
            return at(heads_dim)
        if heads_ok:
            return rep  # replicated KV heads (small), Q stays head-sharded
        return at(ndim - 1) if _div(shape[ndim - 1], tp_size) else rep
    if leaf == "wo" and "attn" in path:
        if heads_ok:
            return at(base)  # (H, hd, d)
        return at(base + 1) if _div(shape[base + 1], tp_size) else rep
    if leaf == "bo":
        return rep

    # ---- MoE
    if leaf == "router":
        return rep
    if "mlp" in path and cfg.is_moe and leaf in ("wg", "wu", "wd"):
        e_dim = base  # (E, d, fe) / (E, fe, d)
        if _div(shape[e_dim], tp_size):
            return at(e_dim)
        fe_dim = e_dim + 2 if leaf in ("wg", "wu") else e_dim + 1
        if _div(shape[fe_dim], tp_size):
            return at(fe_dim)
        return rep

    # ---- dense MLP (column/column/row)
    if leaf in ("wg", "wu", "wi"):
        if _div(shape[ndim - 1], tp_size):
            return at(ndim - 1)
        return rep
    if leaf in ("wd", "wo"):
        if _div(shape[base], tp_size):
            return at(base)
        return rep

    # ---- Mamba2 SSD (z/xBC/dt split so every output dim shards cleanly)
    if leaf in ("in_proj", "z_proj", "xbc_proj", "dt_proj"):
        return at(ndim - 1) if _div(shape[ndim - 1], tp_size) else rep
    if leaf == "out_proj":
        return at(base) if _div(shape[base], tp_size) else rep
    if leaf == "conv_w":
        return at(ndim - 1) if _div(shape[ndim - 1], tp_size) else rep

    # ---- RG-LRU
    if leaf in ("wx", "wy", "wa", "wi"):
        return at(ndim - 1) if _div(shape[ndim - 1], tp_size) else rep
    if leaf == "out":
        return at(base) if _div(shape[base], tp_size) else rep

    # ---- embeddings / heads: vocab-parallel (avoids the (B,S,V) logits
    # all-reduce a d_model-sharded head would need; lookup costs one (B,S,D)
    # reduce instead)
    if leaf == "embed":
        if _div(shape[0], tp_size):
            return at(0)
        return at(ndim - 1) if _div(shape[ndim - 1], tp_size) else rep
    if leaf == "lm_head":
        return at(ndim - 1) if _div(shape[ndim - 1], tp_size) else rep
    if leaf in ("dec_pos",):
        return rep

    # fallback: replicate
    return rep


def _map_named(fn, tree):
    """`fn(path, leaf)` over every leaf, keeping the tree's structure."""
    return tree_unflatten(tree_structure(tree),
                          [fn(name, leaf) for name, leaf in flatten_params(tree)])


def params_pspecs(cfg: ModelConfig, params_shape: Any, mesh) -> Any:
    tp_size = _axis_sizes(mesh)[TP]
    return _map_named(lambda name, leaf: param_spec(name, tuple(leaf.shape), cfg, tp_size),
                      params_shape)


def opt_pspecs(cfg: ModelConfig, opt_shape: Any, params_pspec: Any) -> Any:
    """Adam moments mirror the parameter specs; step is replicated."""
    return {
        "m": params_pspec,
        "v": params_pspec,
        "step": P(),
    }


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Any:
    dp = _dp_for(mesh, shape.global_batch)
    specs: dict[str, P] = {"tokens": P(dp, None)}
    if cfg.family == "audio":
        specs["enc_frames"] = P(dp, None, None)
    if cfg.family == "vlm":
        specs["vision_embeds"] = P(dp, None, None)
        specs["mrope_positions"] = P(None, dp, None)
    return specs


def cache_pspecs(cfg: ModelConfig, cache_shape: Any, mesh, *,
                 batch: int = 0, seq_shard: bool = False) -> Any:
    """Decode caches: batch over DP; kv-heads (or head_dim) over TP.

    seq_shard=True shards the cache SEQUENCE dim over TP instead
    (flash-decode): attention statistics reduce over tiny (B, H) tensors
    rather than resharding whole caches/scores."""
    tp_size = _axis_sizes(mesh)[TP]
    dp = _dp_for(mesh, batch) if batch else _dp(mesh)

    def one(name, leaf):
        shp = tuple(leaf.shape)
        nd = len(shp)
        if name.endswith(("/k", "/v")) or "self_k" in name or "self_v" in name \
                or "cross_k" in name or "cross_v" in name:
            # (L?, B, C, K, hd): batch -> dp; KV sharding mirrors wk/wv rules
            b_dim = nd - 4
            spec = [None] * nd
            spec[b_dim] = dp
            if seq_shard and _div(shp[nd - 3], tp_size):
                spec[nd - 3] = TP  # flash-decode: shard cache positions
                return P(*spec)
            # memory trumps layout matching: a replicated 32k cache would be
            # ~17 GB/chip (mixtral decode); shard K else head_dim
            if _div(shp[nd - 2], tp_size):
                spec[nd - 2] = TP
            elif _div(shp[nd - 1], tp_size):
                spec[nd - 1] = TP
            return P(*spec)
        if "kv_pos" in name:
            spec = [None] * nd
            spec[nd - 2] = dp
            if seq_shard and _div(shp[nd - 1], tp_size):
                spec[nd - 1] = TP
            return P(*spec)
        if name.endswith("/state"):  # SSD state (L, B, H, P, N)
            spec = [None] * nd
            spec[nd - 4] = dp
            if _div(shp[nd - 3], tp_size):
                spec[nd - 3] = TP
            return P(*spec)
        if name.endswith("/h"):  # RG-LRU (L, B, W)
            spec = [None] * nd
            spec[nd - 2] = dp
            if _div(shp[nd - 1], tp_size):
                spec[nd - 1] = TP
            return P(*spec)
        if name.endswith("/conv"):  # (L, B, W-1, C)
            spec = [None] * nd
            spec[nd - 3] = dp
            if _div(shp[nd - 1], tp_size):
                spec[nd - 1] = TP
            return P(*spec)
        return P(*([None] * nd))

    return _map_named(one, cache_shape)


# ------------------------------------------------------------------ DTensor
def placements(spec: P, mesh) -> tuple:
    """One placement per dim of `mesh`: ``Shard(d)`` where tensor dim `d`
    names that mesh axis (alone or in a tuple), else ``Replicate()``.  A
    tuple entry such as ("pod", "data") shards its dim over both mesh dims;
    DTensor splits a dim sharded twice in mesh-dim order, so the first axis
    is major, as in JAX."""
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple) and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    order = [a for entry in spec if isinstance(entry, tuple) for a in entry]
    if order != sorted(order, key=list(mesh.mesh_dim_names).index):
        raise ValueError(f"{spec}: a tuple entry must list its axes in mesh order")
    return tuple(out)


def spec_leaves(specs: Any) -> list[P]:
    """The specs of a tree in `flatten_params` order (a `P` is a leaf)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for sub in specs for s in spec_leaves(sub)]


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """`tree` with every leaf a DTensor placed by its spec (one `P` for
    every leaf, or a tree of them like `tree`).  Each rank keeps its own
    shard of the full leaf it holds (no broadcast: every rank must hold the
    same values, as seeded inits do).  A ``meta`` leaf (shapes only)
    becomes a DTensor over this rank's ``meta`` shard."""
    leaves = [t for _, t in flatten_params(tree)]
    specs = [specs] * len(leaves) if isinstance(specs, P) else spec_leaves(specs)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(specs)} specs")
    placed = [_place(t, mesh, placements(s, mesh)) for t, s in zip(leaves, specs)]
    return tree_unflatten(tree_structure(tree), placed)


def _place(t: torch.Tensor, mesh, pl: tuple) -> DTensor:
    if t.is_meta:  # shapes only (the dry-run): this rank's shard, made directly
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return DTensor.from_local(torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
                                  run_check=False, shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, pl, src_data_rank=None)
