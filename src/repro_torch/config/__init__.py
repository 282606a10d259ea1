from repro_torch.config.base import (
    ATTN, LOCAL_ATTN, SSD, RGLRU,
    MLP_SWIGLU, MLP_RELU2, MLP_GELU, MLP_MOE, MLP_NONE,
    ModelConfig, ParallelConfig, TrainConfig,
)
from repro_torch.config.registry import (
    get_model_config, get_parallel_config, list_archs, ported_archs, register,
)

__all__ = [
    "ATTN", "LOCAL_ATTN", "SSD", "RGLRU",
    "MLP_SWIGLU", "MLP_RELU2", "MLP_GELU", "MLP_MOE", "MLP_NONE",
    "ModelConfig", "ParallelConfig", "TrainConfig", "get_model_config",
    "get_parallel_config", "list_archs", "ported_archs", "register",
]
