"""Llama-3.2-1B: small llama3, GQA kv=8, tied embeddings. [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128_256,
    rope_theta=500_000.0,
    tie_embeddings=True,
))
