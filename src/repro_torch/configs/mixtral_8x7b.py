"""Mixtral-8x7B: 32L MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=32_000,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,   # SWA -> bounded KV, long_500k runnable
    rope_theta=1_000_000.0,
))
