"""Architectures only the port serves, kept out of the shared registry.

`base.get_config` finds them by name; `all_configs` and `arch_ids` leave
them out, so whatever is parametrised over every registered architecture
(the reference parity tests, the dry-run cells) keeps the reference's set.
"""
from repro_torch.configs.base import ModelConfig

# DeepSeek-V2-Lite: 27 layers, multi-head latent attention (no q LoRA), YaRN
# rotary scaling, layer 0 a dense SwiGLU, layers 1-26 64 routed experts of
# 1408 (top-6, softmax, not renormalised) beside 2 shared ones.
# [hf:deepseek-ai/DeepSeek-V2-Lite config.json]
DEEPSEEK_V2_LITE = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,  # layer 0's dense MLP
    moe_d_ff=1408,
    vocab_size=102_400,
    num_experts=64,
    experts_per_token=6,
    norm_topk_prob=False,
    num_shared_experts=2,
    first_k_dense=1,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    yarn_factor=40.0,
    yarn_original_max_pos=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
)

PORT_ONLY: dict[str, ModelConfig] = {c.name: c for c in (DEEPSEEK_V2_LITE,)}
