"""Architecture registry: importing this package registers all assigned configs."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_configs,
    get_config,
    runnable_cells,
    skipped_cells,
)
from repro_torch.configs import (  # noqa: F401
    codeqwen15_7b,
    deepseek_7b,
    llama32_1b,
    mamba2_27b,
    mixtral_8x7b,
    qwen2_vl_7b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    whisper_tiny,
    yi_9b,
)


def arch_ids() -> list[str]:
    return sorted(all_configs())
