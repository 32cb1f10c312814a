"""RecurrentGemma-9B: RG-LRU recurrent blocks + local attention, 1:2 pattern.

[arXiv:2402.19427] — Griffin architecture: repeating (recurrent, recurrent,
local-attention) groups; MQA (kv=1), local window 2048.  38 layers = 12 full
(rec, rec, attn) groups + a trailing (rec, rec).
"""
from repro_torch.configs.base import ModelConfig, register

_PATTERN = ("rglru", "rglru", "swa") * 12 + ("rglru", "rglru")
assert len(_PATTERN) == 38

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    sliding_window=2048,
    lru_width=4096,
    layer_pattern=_PATTERN,
))
