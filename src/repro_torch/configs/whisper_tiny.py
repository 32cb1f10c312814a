"""Whisper-tiny: enc-dec transformer backbone; conv/mel frontend is a stub.

[arXiv:2212.04356] — the assignment specifies the BACKBONE only; `input_specs`
provides precomputed frame embeddings for the encoder.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,          # decoder layers
    encoder_layers=4,
    encoder_seq=1500,      # stub: mel-frame embeddings fed to the encoder
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    tie_embeddings=True,
))
