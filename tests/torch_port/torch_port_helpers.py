"""Shared helpers for the port's parity tests: carry arrays between the JAX
reference and the PyTorch port as numpy, in both directions; the paged
decode steps as they were before the rope + K/V write kernel and before
the two formats shared one layer loop, each with its residual adds and
norms by a `norm` function given to it (by default the chain of PyTorch
kernels the step ran before the add + RMSNorm kernel)."""
import itertools

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import common, lm
from repro_torch.models import layers as Lmod
from repro_torch.models.common import rms_norm

# tests/test_kernels.py's tolerances: fp32 sums in another order, bf16 rounds
# at other places in the two frameworks
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def ref_named_numpy(params) -> dict:
    """Flatten a reference parameter tree to {leaf_path: numpy array}."""
    import jax

    from repro.models.tensors import leaf_path

    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {leaf_path(path): np.asarray(leaf) for path, leaf in leaves}


def to_torch(a, device="cpu") -> torch.Tensor:
    """A reference array (jax or numpy, bf16 included) as a torch tensor."""
    from repro_torch.models.convert import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a)).to(device)


def to_f32(x) -> np.ndarray:
    """Either framework's array as float32 numpy, for comparison."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def max_err(a, b) -> float:
    return float(np.max(np.abs(to_f32(a) - to_f32(b))))


def close_to(port, ref, dtype) -> bool:
    """Within tests/test_kernels.py's tolerance: absolute for fp32, relative
    to the reference's scale (at least 1) for bf16."""
    scale = max(1.0, float(np.abs(to_f32(ref)).max())) if dtype == "bfloat16" else 1.0
    return max_err(port, ref) <= TOL[dtype] * scale


def paired_engines(models, cap=64 << 20, ref_cls=None, port_cls=None, **kw):
    """A reference and a port engine (CPU) with the same models registered
    over the same weights, drawn once by the reference.  `models`:
    {model_id: (ref_cfg, port_cfg, seed)}.  Returns (ref, port, weights)
    with weights {model_id: reference param tree}."""
    import jax

    from repro.models import build_model as ref_build
    from repro.serving.engine import Engine as RefEngine
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serving.engine import Engine as PortEngine

    ref = (ref_cls or RefEngine)(cap, **kw)
    port = (port_cls or PortEngine)(cap, device="cpu", **kw)
    weights = {}
    for mid, (rc, pc, seed) in models.items():
        params = ref_build(rc).init(jax.random.PRNGKey(seed))
        named = ref_named_numpy(params)
        ref.register(mid, rc, init_fn=lambda p=params: p)
        port.register(mid, pc, init_fn=lambda n=named, c=pc: params_from_numpy(n, c, device="cpu"))
        weights[mid] = params
    return ref, port, weights


def load_ledger(eng):
    """Everything the load path accounts, timings aside."""
    s = {k: v for k, v in eng.last_load.as_dict().items() if "seconds" not in k}
    return (s, eng.host_store.snapshot().as_dict(), eng.persistent_store.nbytes(),
            sorted(eng.store.tensor_map), sorted(eng._tensors))


def load_report(rep):
    return (rep.bytes_total, rep.bytes_transferred, rep.bytes_from_host,
            rep.bytes_from_store, rep.reuse_fraction, rep.load_seconds)


class RecordingCapture:
    """`serving.step_graph.CudaGraphCapture`'s double for a CPU engine: the
    capture runs the eager step once (a real capture runs the step's
    Python, whose wrappers count launches only a replay makes); a replay
    reruns it into the static outputs, a flat list of tensors, without
    counting (a real replay runs no Python).  An output that is one of the
    step's static inputs is copied onto itself, as a real replay leaves
    it.  Each capture reports `pool_bytes` of private pool."""

    def __init__(self, pool_bytes: int = 0):
        self.replayed = 0
        self.pool_bytes = pool_bytes

    def __call__(self, fn):
        outputs = fn()
        rec = self

        class Graph:
            def replay(self):
                fresh, _ = ops.launches_of(fn)
                for static, new in zip(outputs, fresh):
                    static.copy_(new)
                rec.replayed += 1

            def reset(self):
                pass

        return Graph(), outputs, self.pool_bytes


def chain_apply_rope(x, positions, theta, mrope_sections=()):
    """`common.apply_rope` before its table was split out of it."""
    hd = x.shape[-1]
    inv_freq = common.rope_freqs(hd, theta, x.device)
    if mrope_sections:
        slot = torch.arange(hd // 2, device=x.device)
        sec_id = torch.zeros_like(slot)
        for bound in itertools.accumulate(mrope_sections[:-1]):
            sec_id += (slot >= bound).to(sec_id.dtype)
        pos = positions.to(torch.float32)
        angles = pos[sec_id] * inv_freq[:, None, None]
        angles = torch.movedim(angles, 0, -1)
    else:
        angles = positions.to(torch.float32)[..., None] * inv_freq
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def chain_add_norm(h, delta, scale, eps):
    """The residual add and the `rms_norm` after it as the paged step ran
    them before `ops.add_rms_norm`: separate PyTorch kernels.  Returns
    (h + delta, the norm of it); `h` itself where `delta` is None."""
    h = h if delta is None else h + delta
    return h, rms_norm(h, scale, eps)


def _after_norms(params, layers):
    """The scale of the norm after each layer's MLP: the next layer's ln1,
    the last layer's the final norm."""
    return [p["ln1"] for p in layers[1:]] + [params["final_norm"]]


def chain_step(params, cfg, token, tables, lengths, pages, *, attn="kernel",
               norm=chain_add_norm):
    """The paged decode step of a llama-style model as it was before the
    rope + K/V write kernel: two `apply_rope` and two `index_copy_` a layer.
    A latent-attention model's step is `chain_mla_step`.  `norm(h, delta,
    scale, eps)` adds and normalises (`chain_add_norm`, or the step's own
    `ops.add_rms_norm`, so that a comparison on the card sees the rope and
    the K/V write alone)."""
    if cfg.is_mla:
        return chain_mla_step(params, cfg, token, tables, lengths, *pages, attn=attn,
                              norm=norm)
    k_pages, v_pages = pages
    B = token.shape[0]
    _, P, T, K, hd = k_pages.shape
    pos = lengths
    h = params["embed"][token][:, None, :]
    seg_params = params["segments"][0]
    positions = pos[:, None]
    mrope = pos[None, :, None].expand(3, B, 1) if cfg.mrope_sections else None
    rp = mrope if cfg.mrope_sections else positions
    b_idx = torch.arange(B, device=token.device)
    pbn = tables[b_idx, (pos // T).long()]
    row = pbn.long() * T + (pos % T).long()
    new_lens = lengths + 1
    attn_fn = ops.paged_attention if attn == "kernel" else ops.paged_attention_ref
    layers = [lm._index_tree(seg_params, l)[0] for l in range(k_pages.shape[0])]
    h, hn = norm(h, None, layers[0]["ln1"], cfg.norm_eps)
    for l, (p, ln_next) in enumerate(zip(layers, _after_norms(params, layers))):
        q, knew, vnew = Lmod._project_qkv(p["attn"], hn, cfg)
        q = chain_apply_rope(q, rp, cfg.rope_theta, cfg.mrope_sections)
        knew = chain_apply_rope(knew, rp, cfg.rope_theta, cfg.mrope_sections)
        kp_l, vp_l = k_pages[l], v_pages[l]
        kp_l.view(P * T, K, hd).index_copy_(0, row, knew[:, 0])
        vp_l.view(P * T, K, hd).index_copy_(0, row, vnew[:, 0])
        o = attn_fn(q[:, 0], kp_l, vp_l, tables, new_lens)
        h, hm = norm(h, Lmod._out_proj(o, p["attn"]["wo"])[:, None, :], p["ln2"],
                     cfg.norm_eps)
        h, hn = norm(h, (Lmod.moe_forward(p["mlp"], hm, cfg, Lmod.DECODE_CAPACITY_FACTOR)
                         if cfg.is_moe else Lmod.mlp_forward(p["mlp"], hm)),
                     ln_next, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (hn @ head)[:, 0], new_lens


def chain_mla_step(params, cfg, token, tables, lengths, lat_pages, *, attn="kernel",
                   norm=chain_add_norm):
    """The paged decode step of a latent-attention model as it was when it
    had a layer loop of its own: each layer writes the token's latent row
    [c | k_pe] to its page, then attends in the absorbed form through K1's
    latent mode over lat_pages (L, P, T, 1, r + dr).  `norm` as in
    `chain_step`."""
    B = token.shape[0]
    _, P, T, _, W = lat_pages.shape
    r = cfg.kv_lora_rank
    pos = lengths
    h = params["embed"][token][:, None, :]
    positions = pos[:, None]
    b_idx = torch.arange(B, device=token.device)
    pbn = tables[b_idx, (pos // T).long()]
    row = pbn.long() * T + (pos % T).long()
    new_lens = lengths + 1
    attn_fn = ops.paged_latent_attention if attn == "kernel" else ops.paged_latent_attention_ref
    scale = Lmod.mla_softmax_scale(cfg)
    table = Lmod.mla_rope_table(positions, cfg)
    ctx = Lmod.SeqCtx(positions=positions, moe_capacity_factor=Lmod.DECODE_CAPACITY_FACTOR)
    layers = [lm._index_tree(seg_params, i)[0]
              for seg_params, (_, repeat) in zip(params["segments"], cfg.segments)
              for i in range(repeat)]
    h, hn = norm(h, None, layers[0]["ln1"], cfg.norm_eps)
    for layer, (p, ln_next) in enumerate(zip(layers, _after_norms(params, layers))):
        pa = p["attn"]
        q, lat = Lmod.mla_project(pa, hn, cfg, table)
        pages = lat_pages[layer]
        pages.view(P * T, W).index_copy_(0, row, lat[:, 0])
        o_lat = attn_fn(Lmod.mla_absorb_q(q, pa["wkv_b"], cfg)[:, 0], pages, tables,
                        new_lens, v_dim=r, scale=scale)
        h, hm = norm(h, Lmod._out_proj(Lmod.mla_expand_o(o_lat[:, None], pa["wkv_b"], cfg),
                                       pa["wo"]), p["ln2"], cfg.norm_eps)
        h, hn = norm(h, Lmod._mlp(p, hm, cfg, ctx), ln_next, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (hn @ head)[:, 0], new_lens
