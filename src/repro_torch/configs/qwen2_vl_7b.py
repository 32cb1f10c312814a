"""Qwen2-VL-7B backbone: M-RoPE decoder; vision frontend stubbed as patch embeds.

[arXiv:2409.12191; hf] — `input_specs` supplies `vision_embeds` (precomputed
patch embeddings) merged into the token stream, and 3-row M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),  # (temporal, height, width) rotary sections
    rope_theta=1_000_000.0,
    vision_stub_patches=256,
))
