"""Config registry: ``get_config("<arch-id>")`` / ``list_archs()``."""
from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    ArchConfig,
    HierAvgParams,
    InputShape,
    ParallelLayout,
    get_config,
    list_archs,
    register,
)

# importing the arch modules populates the registry
from repro_torch.configs import (  # noqa: F401
    deepseek_67b,
    deepseek_v2_lite_16b,
    hymba_1_5b,
    mistral_large_123b,
    phi3_5_moe_42b,
    qwen2_vl_2b,
    resnet18_cifar,
    rwkv6_1_6b,
    seamless_m4t_large_v2,
    starcoder2_15b,
    yi_34b,
)

ALL_ARCHS = (
    "yi-34b",
    "seamless-m4t-large-v2",
    "hymba-1.5b",
    "rwkv6-1.6b",
    "qwen2-vl-2b",
    "mistral-large-123b",
    "phi3.5-moe-42b-a6.6b",
    "deepseek-67b",
    "starcoder2-15b",
    "deepseek-v2-lite-16b",
)
