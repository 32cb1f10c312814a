"""Qwen3-30B-A3B: 48L MoE, 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=6144,          # shared-path reference width (unused by MoE layers)
    moe_d_ff=768,       # per-expert intermediate
    vocab_size=151_936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1_000_000.0,
))
