"""--arch registry: maps arch ids to (full ModelConfig, smoke ModelConfig).

Each module in ``repro_torch.configs`` registers itself on import via
``register(full=..., smoke=...)``. An arch that the JAX package knows but the
port does not have yet raises, naming the slice of the port that brings it.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config.base import ModelConfig

_FULL: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, ModelConfig] = {}

_ARCH_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}

# Archs of the JAX package that later slices of the port bring.
_LATER = {
    "musicgen-large": "a slice after slice 3",
    "internlm2-1.8b": "a slice after slice 3",
    "nemotron-4-340b": "a slice after slice 3",
    "deepseek-67b": "a slice after slice 3",
    "phi3.5-moe-42b-a6.6b": "a slice after slice 3",
    "granite-moe-1b-a400m": "a slice after slice 3",
    "internvl2-2b": "a slice after slice 3",
}


def register(full: ModelConfig, smoke: ModelConfig) -> None:
    _FULL[full.name] = full
    _SMOKE[full.name] = smoke


def _ensure(name: str) -> None:
    if name in _FULL:
        return
    mod = _ARCH_MODULES.get(name)
    if mod is None:
        if name in _LATER:
            raise NotImplementedError(
                f"arch {name!r} is not ported yet; it comes with {_LATER[name]}")
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    importlib.import_module(mod)


def list_archs() -> list:
    return sorted(_ARCH_MODULES)


def get_model_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure(name)
    return (_SMOKE if smoke else _FULL)[name]
