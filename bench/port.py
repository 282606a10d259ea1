"""The program under test, as the benchmark reaches it: the ``repro_torch``
model of a configuration file, holding the benchmark's weights.

The configuration file's keys that name fields of ``repro_torch``'s
``ModelConfig`` are its configuration as run; its other keys (the source,
what the reference alone reads) are the benchmark's. The weights are copied
into the model's parameters by name; a parameter that the weights lack, or
one of another shape or dtype, is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def model_config(cfg: dict):
    from repro_torch.config.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if "block_pattern" in kw:
        kw["block_pattern"] = tuple(tuple(p) for p in kw["block_pattern"])
    return ModelConfig(**kw)


def build(cfg: dict, weights: Dict[str, torch.Tensor], device, remat: str = "block"):
    """The port's ``Model`` of ``cfg`` on ``device`` holding ``weights``."""
    from repro_torch.models.model import Model
    model = Model(model_config(cfg), device=device, remat=remat)
    own = dict(model.named_parameters())
    if set(own) != set(weights):
        raise ValueError(f"the weights do not name the model's parameters: missing "
                         f"{sorted(set(own) - set(weights))[:5]}, extra "
                         f"{sorted(set(weights) - set(own))[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            w = weights[name]
            if p.shape != w.shape or p.dtype != w.dtype:
                raise ValueError(f"{name}: the model holds {tuple(p.shape)} {p.dtype}, the "
                                 f"weights {tuple(w.shape)} {w.dtype}")
            p.copy_(w)
    return model.eval()
