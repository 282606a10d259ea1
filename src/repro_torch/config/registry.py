"""--arch registry: maps arch ids to (full ModelConfig, smoke ModelConfig).

Each module in ``repro_torch.configs`` registers itself on import via
``register(full=..., smoke=..., parallel_overrides=...)``. Every arch of the
JAX package is here (its configs and production parallel layout), and the
port builds, serves and trains the model of each (``ported_archs()``).
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

from repro_torch.config.base import ModelConfig, ParallelConfig

_FULL: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}
_PAR_OVERRIDES: Dict[str, dict] = {}

_ARCH_MODULES = {
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}

# Archs whose model (serving and training) the port builds: all of them.
_PORTED = tuple(_ARCH_MODULES)


def register(full: ModelConfig, smoke: ModelConfig,
             parallel_overrides: Optional[dict] = None) -> None:
    _FULL[full.name] = full
    _SMOKE[full.name] = smoke
    _PAR_OVERRIDES[full.name] = dict(parallel_overrides or {})


def _ensure(name: str) -> None:
    if name not in _FULL:
        mod = _ARCH_MODULES.get(name)
        if mod is None:
            raise KeyError(
                f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
        importlib.import_module(mod)


def list_archs() -> list:
    return sorted(_ARCH_MODULES)


def ported_archs() -> list:
    """The archs whose model the port builds (every registered arch)."""
    return sorted(_PORTED)


def get_model_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure(name)
    return (_SMOKE if smoke else _FULL)[name]


def get_parallel_config(name: str, multi_pod: bool = False, **extra) -> ParallelConfig:
    """Production ParallelConfig for an arch (its registered overrides + extras)."""
    _ensure(name)
    kw = dict(_PAR_OVERRIDES[name])
    kw.update(extra)
    kw["multi_pod"] = multi_pod
    return ParallelConfig(**kw)
