"""The model layers' ops over DTensors (port only: the reference leaves this
to GSPMD).  `models.layers` calls into this module only where an input is a
DTensor, so the serving and training paths on plain tensors never reach it.

Ops with no DTensor sharding strategy run per rank in `local_map` regions:
every attention route (the flash kernel K2 is a custom op; the plain
attention's (B, S, K, G, hd) view of q has no strategy where K does not
divide the model axis), the flash-decode combine over a sequence-sharded
cache, the prefill cache fill and the decode step's slot write (index
writes), the scatter MoE dispatch, Mamba2's chunked scan by heads, the
vocab-parallel embedding and `log_sigmoid`'s backward.  The residual stream takes
Megatron's f / g placements (`placed_like`, `grad_placed`), and the GShard
dispatch the experts' sharding (`experts_placed`).  Each departure from the
reference's GSPMD partitioning is listed in ROADMAP queue 3.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map, register_sharding


def _placed(t: DTensor, want) -> DTensor:
    """`t` redistributed to the placements `want` (itself where it has them)."""
    want = tuple(want)
    return t if want == tuple(t.placements) else t.redistribute(t.device_mesh, want)


def _keep(t: DTensor, dims: tuple[int, ...], like=None) -> DTensor:
    """`t` redistributed so that only tensor dims in `dims` stay sharded
    (each mesh dim keeps its `Shard(d)` for d in `dims`, or takes `like`'s
    placement there where `like` is given); every other mesh dim, a partial
    sum included, becomes `Replicate()`."""
    src = like if like is not None else t.placements
    return _placed(t, (p if isinstance(p, Shard) and p.dim in dims else Replicate()
                       for p in src))


def _offset(t: DTensor) -> tuple[int, ...]:
    """This rank's global offset of `t`'s local shard, per tensor dim."""
    return tuple(compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                       t.placements)[1])


def _as_dtensor(t, mesh) -> DTensor:
    """A plain tensor every rank holds whole (an arange of positions) as a
    replicated DTensor."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


# ------------------------------------------------------------------ attention
def _kv_heads_of(q_heads: range, G: int, k0: int, Kl: int) -> Optional[list[int]]:
    """Local KV heads of the local query heads `q_heads` (global ids; the
    global KV head of query head h is h // G), as indices into a local KV
    shard that starts at global head `k0` and holds `Kl` heads.  None where
    the shard is already laid out for them (local query head i reads local
    KV head i // (len(q_heads) // Kl))."""
    want = [h // G - k0 for h in q_heads]
    if len(q_heads) % Kl == 0 and want == [i // (len(q_heads) // Kl)
                                           for i in range(len(q_heads))]:
        return None
    heads = sorted(set(want))
    per = len(q_heads) // len(heads)
    if len(q_heads) % len(heads) == 0 and want == [heads[i // per]
                                                    for i in range(len(q_heads))]:
        return heads  # each KV head serves `per` consecutive query heads
    return want  # one KV head per query head (G 1 locally)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a local
    gradient leaving `local_map` (the attention's einsum gradients are
    permuted) reaches DTensor's backward of the projections' reshape, whose
    local `view` needs contiguous memory."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def _contiguous_grad(t: torch.Tensor) -> torch.Tensor:
    return _ContiguousGrad.apply(t) if t.requires_grad else t


def attention(attend, q, k, v, *rows):
    """`attend(q, k, v, *rows)` (any of the attention routes) over DTensors
    q (B, S, H, hd) and k, v (B, T, K, hd), run per rank on its own batch
    rows and query heads (`local_map`).  `rows` are per-row tensors
    (positions, validity masks), which follow q's batch shards.

    - A sequence-sharded decode cache (`seq_shard_kv`) stays where it is:
      `flash_decode` combines each rank's partial softmax statistics.
    - Otherwise a sharded head dim, or a partial sum, is first
      redistributed to whole heads: attention over a slice of hd is wrong
      (the head-dim fallback of `distributed.sharding`, where neither H
      nor K divides the model axis, shards hd).
    - Megatron-GQA: where Q heads are sharded and KV heads replicated, a
      rank holds H/tp query heads and every KV head; its local call takes
      the KV heads of its own query-head range (global query head h reads
      global KV head h // G, not its local index), and the gradient of the
      replicated K and V is the sum of every rank's."""
    if any(p == Shard(1) for p in k.placements):
        return flash_decode(attend, q, k, v, *rows)
    mesh = q.device_mesh
    G = q.shape[2] // k.shape[2]
    q = _keep(q, (0, 2))
    # k, v follow q's batch shards; where q's heads shard, k's heads may
    # shard along (heads aligned) or replicate (Megatron-GQA)
    want = tuple(qp if isinstance(qp, Shard) and qp.dim == 0
                 else (kp if isinstance(qp, Shard) and kp == qp else Replicate())
                 for qp, kp in zip(q.placements, k.placements))
    k, v = _placed(k, want), _placed(v, want)
    rows = [_keep(_as_dtensor(r, mesh), (0,), like=q.placements) for r in rows]
    h0, k0 = _offset(q)[2], _offset(k)[2]
    Hl = compute_local_shape_and_global_offset(q.shape, mesh, q.placements)[0][2]
    Kl = compute_local_shape_and_global_offset(k.shape, mesh, k.placements)[0][2]
    heads = _kv_heads_of(range(h0, h0 + Hl), G, k0, Kl)
    kv_grad = tuple(Partial() if isinstance(qp, Shard) and qp.dim == 2 and kp != qp else kp
                    for qp, kp in zip(q.placements, k.placements))

    def local(ql, kl, vl, *rl):
        ql, kl, vl = (_contiguous_grad(t) for t in (ql, kl, vl))
        if heads is not None:
            idx = torch.tensor(heads, device=kl.device)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return attend(ql, kl.contiguous(), vl.contiguous(), *rl)

    row_pl = [r.placements for r in rows]
    # one output: its placements as a list (a tuple would read as one
    # placement list per output)
    return local_map(local, out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements, v.placements, *row_pl),
                     in_grad_placements=(q.placements, kv_grad, kv_grad, *row_pl),
                     device_mesh=mesh)(q, k, v, *rows)


def flash_decode(attend, q, k, v, *rows):
    """Attention over a sequence-sharded cache (k, v (B, T, K, hd) with T
    sharded, `seq_shard_kv`), as GSPMD partitions the reference's serve
    step: each rank takes every query head of its batch rows (q gathered
    whole over the sequence-sharded mesh dims: (B, 1, H, hd) is small)
    against its own slice of cache slots and validity rows, giving its row
    max m, its sum l of exp(score - m) and its unnormalised P.V
    (`attend(..., attn=common.attention_partial)`).  The combine reduces
    only those: an all-reduce-max of m, each rank's l and P.V rescaled by
    exp(m - max), one all-reduce-sum of both, and a division.  A row no
    rank can see stays 0; a rank whose slice holds no live slot adds 0.
    `rows` are per-row tensors: those as long as the cache ((B, T): slot
    positions, validity) follow its slots, the others (query positions) its
    batch rows.  Runs without autograd (the serve step)."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.models.common import attention_partial

    mesh = k.device_mesh
    k = _keep(k, (0, 1))
    v = _placed(v, k.placements)
    batch_pl = tuple(p if p == Shard(0) else Replicate() for p in k.placements)
    q = _placed(q, batch_pl)
    T = k.shape[1]
    rows = [_keep(r, (0, 1), like=k.placements) if r.ndim == 2 and r.shape[1] == T
            else _keep(r, (0,), like=batch_pl)
            for r in (_as_dtensor(r, mesh) for r in rows)]
    seq_dims = [d for d, p in enumerate(k.placements) if p == Shard(1)]

    def reduce(t, op):
        for d in seq_dims:
            t = funcol.all_reduce(t, op, (mesh, d))
            t = t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t
        return t

    def local(ql, kl, vl, *rl):
        o, m, l = attend(ql, kl, vl, *rl, attn=attention_partial)
        top = reduce(m, "max")
        w = torch.exp(m - torch.where(torch.isfinite(top), top, 0.0))  # 0 where m is -inf
        ol = reduce(torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1), "sum")
        o, l = ol[..., :-1], ol[..., -1]
        return (o / torch.where(l > 0, l, 1.0)[..., None]).to(ql.dtype)

    return local_map(local, out_placements=list(batch_pl),
                     in_placements=(q.placements, k.placements, v.placements,
                                    *(r.placements for r in rows)),
                     device_mesh=mesh)(q, k, v, *rows)


# ---------------------------------------------------------------- cache writes
def fill_kv_cache(fill, k, v, positions, cap: int):
    """`fill(k, v, positions, cap)` (the prefill's ring-cache fill) over
    DTensors: an index write into a fresh cache has no DTensor sharding
    strategy, so each rank fills its own rows, heads and head-dim slice
    (`local_map`); the positions follow k's batch shards."""
    k = _keep(k, (0, 2, 3))
    v = _keep(v, (0, 2, 3), like=k.placements)
    positions = _keep(_as_dtensor(positions, k.device_mesh), (0,), like=k.placements)
    pos_pl = positions.placements
    run = local_map(lambda kl, vl, pl: tuple(fill(kl, vl, pl, cap).values()),
                    out_placements=(k.placements, k.placements, pos_pl),
                    in_placements=(k.placements, k.placements, pos_pl),
                    device_mesh=k.device_mesh)
    return dict(zip(("k", "v", "kv_pos"), run(k, v, positions)))


def slot_write(cache: DTensor, value, pos):
    """`layers.slot_write` on a DTensor cache, per rank (`local_map`): an
    index write at a device position has no DTensor sharding strategy, and a
    sequence-sharded cache (`seq_shard_kv`) holds each slot on one rank
    only, which writes the rows whose slot falls inside its slice."""
    mesh, cap = cache.device_mesh, cache.shape[1]
    cache = _keep(cache, tuple(range(cache.ndim)))
    # the value: the cache's batch and trailing shards; every sequence
    # shard gets the whole of it
    val_pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
                   else (p if isinstance(p, Shard) and p.dim == 0 else Replicate())
                   for p in cache.placements)
    value = _placed(_as_dtensor(value, mesh), val_pl)
    pos = _keep(_as_dtensor(pos, mesh), (0,), like=cache.placements)
    first = _offset(cache)[1]

    def local(cl, vl, pl):
        C = cl.shape[1]
        slot = (pl % cap).long() - first
        hit = (slot >= 0) & (slot < C)
        s = slot.clamp(0, C - 1)
        b = torch.arange(cl.shape[0], device=cl.device)
        out = cl.clone()
        out[b, s] = torch.where(hit.view(-1, *[1] * (vl.ndim - 1)), vl.to(cl.dtype), cl[b, s])
        return out

    return local_map(local, out_placements=list(cache.placements),
                     in_placements=(cache.placements, val_pl, pos.placements),
                     device_mesh=mesh)(cache, value, pos)


def pointwise(fn, t):
    """`fn(t)` for an elementwise `fn`, on a DTensor's local shard where
    DTensor has no strategy for it (`aten.log_sigmoid_backward`)."""
    if not isinstance(t, DTensor):
        return fn(t)
    return local_map(fn, out_placements=list(t.placements), in_placements=(t.placements,),
                     device_mesh=t.device_mesh)(t)


# ----------------------------------------------------------------- Mamba2 SSD
def _by_heads(dt: DTensor) -> tuple:
    """dt's (B, S, H) batch and head shards, replicated elsewhere: the
    placement of every per-head SSD tensor (B, S, H, ...)."""
    return tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in dt.placements)


def heads_like(x: DTensor, dt: DTensor) -> DTensor:
    """The SSD input x (B, S, H, P) placed by heads as dt (B, S, H) is.  x
    comes whole out of the split of the conv's output into x, B and C, so
    the slice is local."""
    return _placed(x, _by_heads(dt))


def ssd_scan(scan, x, dA, Bm, Cm, chunk: int):
    """`scan(x, dA, Bm, Cm, chunk)` (`layers.ssd_chunked`) per rank over its
    own heads (`local_map`), as GSPMD partitions the reference's scan: x
    (B, S, H, P) and dA (B, S, H) sharded by heads as dA is, the single
    group's B and C (B, S, N) whole on every rank.  Returns (y (B, S, H, P),
    final state (B, H, P, N)), both by heads.  The gradients of x and dA
    keep their placements; those of B and C are the partial sums of every
    rank's heads."""
    mesh = dA.device_mesh
    head_pl = _by_heads(dA)
    row_pl = tuple(p if p == Shard(0) else Replicate() for p in head_pl)
    x, dA = _placed(x, head_pl), _placed(dA, head_pl)
    Bm, Cm = (_placed(_as_dtensor(t, mesh), row_pl) for t in (Bm, Cm))
    state_pl = tuple(Shard(1) if p == Shard(2) else p for p in head_pl)
    bc_grad = tuple(Partial() if p == Shard(2) else r for p, r in zip(head_pl, row_pl))
    return local_map(lambda *a: scan(*(_contiguous_grad(t) for t in a), chunk),
                     out_placements=(head_pl, state_pl),
                     in_placements=(head_pl, head_pl, row_pl, row_pl),
                     in_grad_placements=(head_pl, head_pl, bc_grad, bc_grad),
                     device_mesh=mesh)(x, dA, Bm, Cm)


def batch_only(t):
    """`t` gathered over every mesh dim but its batch shards, where it is a
    DTensor: the input of a column-parallel product that contracts over a
    sharded dim (the RG-LRU's square gates), as GSPMD gathers it.  DTensor
    would instead shard the weight's rows to match and reduce-scatter every
    gate's float32 output.  A plain tensor as it is."""
    return _keep(t, (0,)) if isinstance(t, DTensor) else t


# ------------------------------------------------------------------------ MoE
def moe_forward(local_moe, p, x, cfg, capacity_factor: float):
    """The scatter dispatch `local_moe(p, x, cfg, capacity_factor,
    first_expert=)` over DTensors.  Its capacity, slots and drops are global
    over the flattened batch, and an index write into a fresh buffer has no
    DTensor sharding strategy; so every rank routes every token (x gathered
    whole) and runs only its own experts (EP, experts over the model axis)
    or its own slice of every expert's ffn (mixtral), per rank in
    `local_map`.  The output is the partial sum of every rank's share, and
    so are the gradients of x and the router."""
    mesh = x.device_mesh
    x, router = _keep(x, ()), _keep(p["router"], ())
    wg, wu, wd = p["wg"], p["wu"], p["wd"]
    first = _offset(wg)[0]
    part = tuple(Partial() if isinstance(q, Shard) else Replicate() for q in wg.placements)

    def local(xl, rl, g, u, d):
        return local_moe({"router": rl, "wg": g, "wu": u, "wd": d}, xl, cfg,
                         capacity_factor, first_expert=first)

    ins = (x.placements, router.placements, wg.placements, wu.placements, wd.placements)
    return local_map(local, out_placements=list(part), in_placements=ins,
                     in_grad_placements=(part, part, *ins[2:]), device_mesh=mesh)(
                         x, router, wg, wu, wd)


def expert_parallel(t: DTensor, ep_axis: str) -> DTensor:
    """A (B, S, E, cap) dispatch or combine tensor placed P(None, None,
    ep_axis, None): experts over that mesh axis, replicated over the rest
    (the reference's `with_sharding_constraint`)."""
    return _placed(t, (Shard(2) if name == ep_axis else Replicate()
                       for name in t.device_mesh.mesh_dim_names))


def experts_placed(disp: DTensor, comb: DTensor, wg: DTensor, ep_axis: Optional[str]):
    """The GShard dispatch and combine tensors (B, S, E, cap) placed for the
    expert products: P(None, None, ep_axis, None) where an axis is named
    (`expert_parallel`), else the experts' own sharding carried into them,
    as GSPMD propagates it from the expert weights `wg` (DTensor would
    compute both over every expert on every rank, then slice)."""
    if ep_axis:
        return expert_parallel(disp, ep_axis), expert_parallel(comb, ep_axis)
    ep = [Shard(2) if w == Shard(0) else d for w, d in zip(wg.placements, disp.placements)]
    return _placed(disp, ep), _placed(comb, ep)


def register_identity_sharding(op):
    """Give `op`, an identity, the sharding strategy that keeps whatever
    placement its input has (per mesh dim)."""

    @register_sharding(op)
    def _identity(y):
        return ([([Replicate()], [Replicate()]), ([Partial()], [Partial()])]
                + [([Shard(d)], [Shard(d)]) for d in range(y.ndim)])


# ---------------------------------------------------- embedding and residuals
def embedding(tokens, embed: DTensor):
    """`embed[tokens]` for a DTensor table, vocab-parallel as the reference
    plans it: each rank looks up the tokens of its own vocab rows (zeros for
    the others') and one (B, S, D) reduce sums them; the output ends in the
    tokens' batch placement, replicated over the rest (`local_map`: DTensor's
    own strategies shard D instead, or leave a masked partial sum whose
    backward it cannot redistribute)."""
    mesh = embed.device_mesh
    tokens = _as_dtensor(tokens, mesh)
    tok_pl = tuple(t if t == Shard(0) and e != Shard(0) else Replicate()
                   for t, e in zip(tokens.placements, embed.placements))
    tokens = _placed(tokens, tok_pl)
    emb_pl = tuple(Replicate() if t == Shard(0) else (e if isinstance(e, Shard) else Replicate())
                   for t, e in zip(tok_pl, embed.placements))
    embed = _placed(embed, emb_pl)
    out_pl = tuple(Shard(0) if t == Shard(0) else Partial() if e == Shard(0)
                   else Shard(2) if e == Shard(1) else Replicate()
                   for t, e in zip(tok_pl, emb_pl))
    first = _offset(embed)[0]

    def local(tl, el):
        idx = tl.long() - first
        hit = (idx >= 0) & (idx < el.shape[0])
        return F.embedding(idx.clamp(0, el.shape[0] - 1), el) * hit[..., None].to(el.dtype)

    # each rank's table gradient covers its own batch rows: summed over the
    # batch shards
    emb_grad = tuple(Partial() if t == Shard(0) else e for t, e in zip(tok_pl, emb_pl))
    x = local_map(local, out_placements=list(out_pl), in_placements=(tok_pl, emb_pl),
                  in_grad_placements=(tok_pl, emb_grad), device_mesh=mesh)(tokens, embed)
    return _Reduce.apply(x, tuple(p if p == Shard(0) else Replicate() for p in tok_pl))


class _Reduce(torch.autograd.Function):
    """A DTensor redistributed to `placements` (a partial sum reduced) whose
    gradient passes through as it arrives: Megatron's all-reduce, whose
    backward is the identity.  DTensor's own backward would hand the
    gradient back as a partial sum, and its next product would then gather
    whole weights to multiply it."""

    @staticmethod
    def forward(ctx, t, placements):
        return t.redistribute(t.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GradPlaced(torch.autograd.Function):
    """Identity whose gradient is placed as its input was: Megatron's
    all-reduce of the partial gradient that a column-parallel product hands
    back to its (replicated) input.  DTensor would keep that gradient a
    partial sum down the residual stream, and the row-parallel products'
    backward would then gather whole activations and weights."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def grad_placed(t):
    """`t`, its gradient placed as `t` is (`_GradPlaced`) where it is a
    DTensor that autograd records; a plain tensor as it is."""
    return _GradPlaced.apply(t) if isinstance(t, DTensor) and t.requires_grad else t


def placed_like(t, ref):
    """`t` (a branch output) with `ref`'s placements where both are DTensors:
    the Megatron all-reduce of a row-parallel product back into the residual
    stream's placement.  DTensor would otherwise keep the partial sum and
    gather the next layer's weights to multiply it, computing that layer
    whole on every rank of the model axis.  A plain tensor as it is."""
    if isinstance(t, DTensor) and isinstance(ref, DTensor) and t.placements != ref.placements:
        return _Reduce.apply(t, tuple(ref.placements))
    return t
