"""Mamba2-2.7B: attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=1,        # unused by SSD layers
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
))
