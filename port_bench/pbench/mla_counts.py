"""Operations and bytes of a multi-head latent attention (MLA) model's served
work, from its configuration's own fields alone: DeepSeek-V2's latent
widths, its leading dense layers, routed and shared experts.

The counterpart of `counts.py` (whose peaks and `bound` it uses) for the
cells of such models, read by the ``mla.*`` metrics.  As there, each count
is of what the inputs need, not of what the code happens to read: each
input byte read once, each output byte written once, causal attention over
the visible (query, key) pairs only.  The prefill counts the published,
un-absorbed equations (attention at q/k width dn + dr and v width dv); a
decode step the absorbed form the program serves (the query through W_UK
into the latent width, attention over the cached latent rows, the output
back through W_UV).

`cfg` is a configuration file's ``port`` section, read as plain numbers.
"""
from __future__ import annotations

from typing import Mapping

from pbench.counts import BF16, HBM_BYTES_PER_S, PEAK_FLOPS, bound, visible_pairs  # noqa: F401

BLOCK_TOKENS = 16  # the Engine's KV block
TABLE_BLOCKS = 64  # Engine.start_instance's max_blocks_per_seq, widened by powers of two


def is_mla(cfg: Mapping) -> bool:
    return bool(cfg.get("kv_lora_rank"))


def _w(cfg: Mapping):
    return (cfg["d_model"], cfg["num_heads"], cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
            cfg["qk_rope_head_dim"], cfg["v_head_dim"])


def latent_width(cfg: Mapping) -> int:
    return cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]


def attn_params(cfg: Mapping) -> int:
    """Weights of one layer's wq, wkv_a, wkv_b and wo (the latent norm aside)."""
    D, H, r, dn, dr, dv = _w(cfg)
    return D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D


def layer_counts(cfg: Mapping) -> tuple[int, int]:
    """(leading dense layers, MoE layers)."""
    dense = cfg.get("first_k_dense", 0) if cfg.get("num_experts") else cfg["num_layers"]
    return dense, cfg["num_layers"] - dense


def mlp_params(cfg: Mapping) -> tuple[int, int]:
    """Weights a token uses in (a dense layer's MLP, a MoE layer's experts:
    its k routed ones and the shared ones), routers aside."""
    D = cfg["d_model"]
    fe = cfg.get("moe_d_ff", 0)
    moe = 3 * D * fe * (cfg.get("experts_per_token", 0) + cfg.get("num_shared_experts", 0))
    return 3 * D * cfg["d_ff"], moe


def router_params(cfg: Mapping) -> int:
    return cfg["d_model"] * cfg.get("num_experts", 0)


def active_params(cfg: Mapping) -> int:
    """Weights one token's forward multiplies by, over every layer, the
    output head aside."""
    dense, moe = layer_counts(cfg)
    mlp_dense, mlp_moe = mlp_params(cfg)
    return (cfg["num_layers"] * attn_params(cfg) + dense * mlp_dense
            + moe * (mlp_moe + router_params(cfg)))


def prefill_flops(cfg: Mapping, S: int) -> int:
    """One B 1 prefill of S tokens: every token's projections and active
    MLP, causal attention at 2 H (dn + dr + dv) operations a visible pair,
    and the logits of the last position."""
    D, H, r, dn, dr, dv = _w(cfg)
    attn = 2 * H * (dn + dr + dv) * visible_pairs(S) * cfg["num_layers"]
    return 2 * active_params(cfg) * S + attn + 2 * D * cfg["vocab_size"]


def decode_flops(cfg: Mapping, length: float) -> float:
    """One absorbed B 1 decode step whose token attends to `length` latent
    rows: the projections, q_nope through W_UK and the output through
    W_UV, 2 H (r + dr + r) operations a row, the active MLP, the logits."""
    D, H, r, dn, dr, dv = _w(cfg)
    L = cfg["num_layers"]
    absorb = 2 * H * dn * r + 2 * H * r * dv  # of wkv_b's products: W_UK and W_UV
    proj = 2 * (D * H * (dn + dr) + D * (r + dr) + H * dv * D)
    attn = 2 * H * (latent_width(cfg) + r) * length
    dense, moe = layer_counts(cfg)
    mlp_dense, mlp_moe = mlp_params(cfg)
    mlp = 2 * (dense * mlp_dense + moe * (mlp_moe + router_params(cfg)))
    return L * (absorb + proj + attn) + mlp + 2 * D * cfg["vocab_size"]


def decode_bytes(cfg: Mapping, length: float) -> float:
    """Bytes one B 1 decode step needs: every weight it uses read once (a
    MoE layer's k routed experts, its shared ones and its fp32 router; the
    dense layers' MLP; fp32 norms), the token's embedding row, the `length`
    cached latent rows read and the new one written, the logits written."""
    D, H, r, dn, dr, dv = _w(cfg)
    L = cfg["num_layers"]
    dense, moe = layer_counts(cfg)
    mlp_dense, mlp_moe = mlp_params(cfg)
    norms = (2 * D + r) * 4  # ln1, ln2, the latent norm: fp32 scales
    weights = (L * (attn_params(cfg) * BF16 + norms) + dense * mlp_dense * BF16
               + moe * (mlp_moe * BF16 + router_params(cfg) * 4))
    rows = latent_width(cfg) * BF16 * (length + 1) * L
    head = D * cfg["vocab_size"] * BF16 + D * 4
    return weights + head + D * BF16 + rows + 4 * cfg["vocab_size"]


def table_width(tokens: int) -> int:
    """The block table's width an instance of `tokens` tokens ends with: 64
    blocks, doubled until they hold them (`Instance`'s rule)."""
    blocks = -(-tokens // BLOCK_TOKENS)
    width = TABLE_BLOCKS
    while width < blocks:
        width *= 2
    return width


def k1_bytes(cfg: Mapping, length: float, table_blocks: int) -> float:
    """One latent-mode K1 call at B 1 over `length` live rows: the H
    absorbed queries read, the rows read once (as K, and their first r
    columns as V), the block table and the length read, the H latent
    outputs written."""
    D, H, r, dn, dr, dv = _w(cfg)
    W = latent_width(cfg)
    return H * W * BF16 + W * BF16 * length + 4 * table_blocks + 4 + H * r * BF16


def k2_bound(cfg: Mapping, S: int) -> float:
    """Least time (s) of one split-width K2 call: a B 1 causal prompt of S
    tokens, q and k at dn + dr, v and the output at dv, 2 H (dn + dr + dv)
    operations a visible pair."""
    D, H, r, dn, dr, dv = _w(cfg)
    nbytes = S * H * (2 * (dn + dr) + 2 * dv) * BF16
    return bound(nbytes, 2 * H * (dn + dr + dv) * visible_pairs(S))[0]


def steps_of(ctx) -> list:
    """The probe's readings of the cell's latent-attention models."""
    return [r for r in ctx.steps if is_mla(ctx.cfgs[r.model_id])]
