"""CodeQwen1.5-7B: qwen1.5-arch dense (attention bias). [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92_416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
))
