"""Operations and bytes that the served work needs, from the shapes alone.

The benchmark's yardstick for roofline shares and model-FLOP shares: used
here and nowhere else.  The peaks and `bound` are frozen copies of
`chip_smoke.py`'s `HBM_BYTES_PER_S`, `PEAK_FLOPS` and `_bound`; `decode_bytes`
follows `chip_smoke.weight_floor` (every weight read once, the embedding
table aside) but counts only the experts a MoE layer's inputs are routed
to.  Each count is of what the inputs need, not of what the code happens
to read: each input byte read once, each output byte written once, causal
attention over the visible (query, key) pairs only.

`cfg` is a configuration file's ``port`` section: the program's field
names, read as plain numbers.
"""
from __future__ import annotations

from typing import Mapping

# NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BF16 = 2


def bound(nbytes: float, flops: float, dtype: str = "bfloat16") -> tuple[float, str]:
    """The least time (s) the card needs, and which of its two limits sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dims(cfg: Mapping):
    D, H, K, hd = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    return D, H, K, hd


def attn_params(cfg: Mapping) -> int:
    """Weights of one layer's q, k, v and o projections (biases included)."""
    D, H, K, hd = _dims(cfg)
    n = D * H * hd * 2 + D * K * hd * 2
    if cfg.get("qkv_bias"):
        n += (H + 2 * K) * hd
    return n


def mlp_params(cfg: Mapping, experts: int | None = None) -> int:
    """Weights of one layer's MLP that `experts` routed experts use (the
    dense MLP where the model has no experts), router aside."""
    D = cfg["d_model"]
    if not cfg.get("num_experts"):
        return 3 * D * cfg["d_ff"]
    return 3 * D * cfg["moe_d_ff"] * experts


def router_params(cfg: Mapping) -> int:
    return cfg["d_model"] * cfg["num_experts"] if cfg.get("num_experts") else 0


def visible_pairs(S: int) -> int:
    """Causal (query, key) pairs of an S-token prompt."""
    return S * (S + 1) // 2


def prefill_flops(cfg: Mapping, S: int) -> int:
    """One B 1 prefill of S tokens: the projections and the active MLP of
    every token, causal attention, the router, and the logits of the last
    position (the only ones the request needs)."""
    D, H, K, hd = _dims(cfg)
    L, k = cfg["num_layers"], cfg.get("experts_per_token") or 0
    per_token = attn_params(cfg) + mlp_params(cfg, k) + router_params(cfg)
    return (2 * per_token * S * L + 4 * H * hd * visible_pairs(S) * L
            + 2 * D * cfg["vocab_size"])


def decode_flops(cfg: Mapping, length: float) -> float:
    """One B 1 decode step whose token attends to `length` keys."""
    D, H, K, hd = _dims(cfg)
    L, k = cfg["num_layers"], cfg.get("experts_per_token") or 0
    per_layer = attn_params(cfg) + mlp_params(cfg, k) + router_params(cfg)
    return 2 * per_layer * L + 4 * H * hd * length * L + 2 * D * cfg["vocab_size"]


def decode_bytes(cfg: Mapping, length: float) -> float:
    """Bytes one B 1 decode step needs: every weight it uses read once (of
    a MoE layer, the `experts_per_token` experts its token is routed to and
    the fp32 router), the token's embedding row, the `length` cached keys
    and values read and the new ones written, the logits written."""
    D, H, K, hd = _dims(cfg)
    L, k = cfg["num_layers"], cfg.get("experts_per_token") or 0
    norms = 2 * D * 4  # fp32 scales
    per_layer = (attn_params(cfg) + mlp_params(cfg, k)) * BF16 + router_params(cfg) * 4 + norms
    kv = 2 * K * hd * BF16 * (length + 1) * L
    head = D * cfg["vocab_size"] * BF16 + D * 4  # the output head and the final norm
    return per_layer * L + head + D * BF16 + kv + 4 * cfg["vocab_size"]


def k1_bytes(cfg: Mapping, length: float, table_blocks: int) -> float:
    """One K1 call at B 1 over `length` live tokens: q read, the live K and
    V rows read, the block table and the length read, the output written."""
    D, H, K, hd = _dims(cfg)
    return 2 * H * hd * BF16 + 2 * K * hd * BF16 * length + 4 * table_blocks + 4


def k2_bound(cfg: Mapping, S: int) -> float:
    """Least time (s) of one K2 call: a B 1 causal prompt of S tokens, q, k,
    v read and the output written, 4 H hd operations a visible pair."""
    D, H, K, hd = _dims(cfg)
    nbytes = (2 * H + 2 * K) * S * hd * BF16
    return bound(nbytes, 4 * H * hd * visible_pairs(S))[0]


def moe_layers(cfg: Mapping) -> int:
    """Layers whose MLP is routed experts: every layer of a model with
    experts (the program has no field for leading dense layers)."""
    return cfg["num_layers"] if cfg.get("num_experts") else 0


def moe_experts_bytes(cfg: Mapping) -> int:
    """One MoE layer's routed experts at B 1: the `experts_per_token` experts'
    gate, up and down projections read, the token read and its output
    written, the pairs' expert ids (int64), routing weights (fp32) and kept
    flags read."""
    D, k = cfg["d_model"], cfg["experts_per_token"]
    return k * 3 * D * cfg["moe_d_ff"] * BF16 + 2 * D * BF16 + k * (8 + 4 + 1)
