"""Model/shape configuration system.

Every assigned architecture is a `ModelConfig`; every assigned input shape is a
`ShapeConfig`.  The cross product defines the dry-run cells.  Reduced ("smoke")
variants of each config are generated by `ModelConfig.smoke()` for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (an experiment cell column)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


# The four assigned LM shapes.
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description covering all 10 assigned families.

    Layer kinds (`layer_pattern` entries):
      "attn"   full (causal) self-attention block
      "swa"    sliding-window attention block
      "rglru"  RG-LRU recurrent block (RecurrentGemma)
      "ssd"    Mamba2 state-space-duality block
    When `layer_pattern` is empty, all layers are "attn" (or "swa" if
    sliding_window > 0).
    """

    name: str
    family: str  # dense | moe | ssm | audio | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert ff width (qwen3-moe uses 768)
    norm_topk_prob: bool = True  # renormalise the k routing weights to sum to 1
    num_shared_experts: int = 0  # experts every token takes: one SwiGLU of n * moe_d_ff
    first_k_dense: int = 0  # leading layers whose MLP is the dense one (d_ff)

    # --- multi-head latent attention (DeepSeek-V2); kv_lora_rank 0: none ---
    kv_lora_rank: int = 0  # width of the cached latent c
    qk_nope_head_dim: int = 0  # per-head q/k width without rotary embedding
    qk_rope_head_dim: int = 0  # rotary width, one k_pe shared by every head
    v_head_dim: int = 0

    # --- YaRN rotary scaling; yarn_factor 0: none ---
    yarn_factor: float = 0.0
    yarn_original_max_pos: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    # --- attention extras ---
    sliding_window: int = 0  # >0 enables SWA for "swa"/local layers
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) sections
    qkv_bias: bool = False  # qwen-family uses attention bias

    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (recurrentgemma) ---
    layer_pattern: tuple[str, ...] = ()
    lru_width: int = 0  # RG-LRU recurrence width (0 -> d_model)

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend: frames fed to the encoder

    # --- vlm ---
    vision_stub_patches: int = 0  # patches supplied as precomputed embeddings

    # --- common ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # ---------------------------------------------------------------- helpers
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table width: padded to a 256 multiple when the assigned
        vocab doesn't divide the 16-way model axis (mamba2 50280, whisper
        51865) — standard vocab padding; logits for pad ids are never targets."""
        if self.vocab_size % 16 == 0:
            return self.vocab_size
        return -(-self.vocab_size // 256) * 256

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def latent_width(self) -> int:
        """Values a token a layer of the latent cache: c and k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def qk_head_dim(self) -> int:
        """Per-head width of q and k: the resolved head dim, or MLA's nope + rope."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim if self.is_mla \
            else self.resolved_head_dim

    def segment_is_moe(self, index: int) -> bool:
        """Whether segment `index`'s MLP is routed experts (the leading dense
        layers are segment 0 of their own)."""
        return self.is_moe and not (self.first_k_dense and index == 0)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pattern(self) -> tuple[str, ...]:
        if self.layer_pattern:
            assert len(self.layer_pattern) == self.num_layers
            return self.layer_pattern
        if self.family == "ssm":
            return ("ssd",) * self.num_layers
        kind = "swa" if self.sliding_window > 0 else "attn"
        return (kind,) * self.num_layers

    @property
    def attention_free(self) -> bool:
        return all(k == "ssd" for k in self.pattern)

    @property
    def segments(self) -> tuple[tuple[tuple[str, ...], int], ...]:
        """Decompose the layer pattern into scannable (unit, repeat) segments.

        Homogeneous models scan a 1-layer unit `num_layers` times; hybrids like
        RecurrentGemma scan their repeating group, with any non-tiling tail as
        a trailing repeat-1 segment.
        """
        pat = self.pattern
        if self.first_k_dense and len(set(pat)) == 1:
            k = self.first_k_dense  # two segments: the dense layers, then the MoE ones
            return (((pat[0],), k), ((pat[0],), len(pat) - k))
        if len(set(pat)) == 1:
            return (((pat[0],), len(pat)),)
        for u in range(1, 5):
            unit = pat[:u]
            reps = len(pat) // u
            if reps >= 2 and pat[: reps * u] == unit * reps:
                tail = pat[reps * u:]
                segs = [(unit, reps)]
                if tail:
                    segs.append((tail, 1))
                return tuple(segs)
        return ((pat, 1),)

    @property
    def subquadratic(self) -> bool:
        """True if decode state is bounded (window / recurrent / SSM)."""
        return all(k in ("ssd", "rglru", "swa") for k in self.pattern)

    # KV/state footprint per token of context, bytes (for ElasticKV sizing).
    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        per_layer = 2 * self.num_kv_heads * self.resolved_head_dim * dtype_bytes
        if self.is_mla:  # one latent row [c | k_pe], read as K and as V
            per_layer = self.latent_width * dtype_bytes
        n_attn = sum(1 for k in self.pattern if k in ("attn", "swa"))
        return per_layer * n_attn

    def param_count(self) -> int:
        """Analytic parameter count (matches models.params_for exactly)."""
        d, hd = self.d_model, self.resolved_head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        attn = q + kv + o
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd
        if self.is_mla:  # wq, wkv_a, the latent norm, wkv_b, wo
            H = self.num_heads
            attn = (d * H * self.qk_head_dim + d * self.latent_width + self.kv_lora_rank
                    + self.kv_lora_rank * H * (self.qk_nope_head_dim + self.v_head_dim)
                    + H * self.v_head_dim * d)
        dense_mlp = 3 * d * self.d_ff  # gate/up/down
        moe_mlp = self.num_experts * 3 * d * self.expert_ff + d * self.num_experts
        moe_mlp += 3 * d * self.num_shared_experts * self.expert_ff  # shared experts
        total = 0
        if self.is_moe:  # the leading dense layers' MLP
            total += self.first_k_dense * (dense_mlp - moe_mlp)
        for kind in self.pattern:
            if kind in ("attn", "swa"):
                total += attn + (moe_mlp if self.is_moe else dense_mlp)
                total += 2 * d  # 2 RMSNorm scales
            elif kind == "rglru":
                w = self.lru_width or d
                # conv1d(4) + gates + in/out proj (GriffinRecurrentBlock)
                total += 2 * d * w + w * d + 4 * w + 2 * w * w // 8 * 8  # approx gates
                total += 2 * d
            elif kind == "ssd":
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                zxbcdt = d * (2 * d_in + 2 * self.ssm_state + nheads)
                conv = self.ssm_conv_width * (d_in + 2 * self.ssm_state)
                total += zxbcdt + conv + 3 * nheads + d_in + d_in * d + d
        total += self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        total += d  # final norm
        if self.encoder_layers:
            enc = attn + dense_mlp + 2 * d
            total += self.encoder_layers * enc + d
            # decoder cross-attention per decoder layer
            total += self.num_layers * (attn + d)
        return total

    def param_bytes(self, dtype_bytes: int = 2) -> int:
        return self.param_count() * dtype_bytes

    # ------------------------------------------------------------- reduction
    def smoke(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        n_layers = min(self.num_layers, 4)
        pattern = self.pattern[:n_layers] if self.layer_pattern else ()
        if pattern and "attn" not in pattern and "swa" not in pattern and self.family == "hybrid":
            pattern = pattern[:-1] + ("attn",)  # keep the hybrid mix in smoke runs
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            num_layers=n_layers,
            d_model=128,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32,
            d_ff=256,
            moe_d_ff=64 if self.is_moe else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 8),
            experts_per_token=min(self.experts_per_token, 2),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=32,
            lru_width=128 if self.lru_width else 0,
            layer_pattern=pattern,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 32) if self.encoder_seq else 0,
            vision_stub_patches=min(self.vision_stub_patches, 8),
            mrope_sections=(8, 4, 4) if self.mrope_sections else (),
            num_shared_experts=min(self.num_shared_experts, 2),
            first_k_dense=min(self.first_k_dense, 1),
            kv_lora_rank=64 if self.is_mla else 0,
            qk_nope_head_dim=32 if self.is_mla else 0,
            qk_rope_head_dim=16 if self.is_mla else 0,
            v_head_dim=32 if self.is_mla else 0,
        )


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs  # noqa: F401  (triggers registration)
    from repro_torch.configs.port_only import PORT_ONLY

    # the port-only architectures, which `all_configs` leaves out
    if name not in _REGISTRY and name in PORT_ONLY:
        return PORT_ONLY[name]
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    from repro_torch import configs  # noqa: F401

    return dict(_REGISTRY)


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) pairs that are runnable (skips documented in DESIGN.md)."""
    cells = []
    for name, cfg in all_configs().items():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.subquadratic:
                continue  # quadratic full attention at 512k context: assigned skip
            cells.append((name, shape.name))
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for name, cfg in all_configs().items():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.subquadratic:
                out.append((name, shape.name, "full quadratic attention at 512k context"))
    return out
