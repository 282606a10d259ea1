"""The benchmark's weights, made from the seed: the same seed and device give
the same weights, for the program and for the reference alike.

A family's reference lists its parameters (``param_specs``: name, shape and
initial distribution, the JAX package's init); the draws are a few large
calls on the device's own generator: one float32 normal draw for every
normal leaf (in blocks of at most ``BLOCK`` numbers), one uniform draw for
the SSD's dt. Each leaf is then scaled and cast to its storage dtype: the
configuration's ``param_dtype``, or float32 for the leaves it names in
``f32_params``.
"""
from __future__ import annotations

import hashlib
import importlib
import math
from typing import Dict, List

import torch

BLOCK = 1 << 28


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    text = ":".join(str(t) for t in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def family(cfg: dict):
    """The reference module of the configuration's family."""
    return importlib.import_module(f"bench.reference.{cfg['family']}")


def storage_dtype(cfg: dict, name: str) -> torch.dtype:
    if name.rsplit(".", 1)[-1] in cfg.get("f32_params", ()):
        return torch.float32
    return getattr(torch, cfg["param_dtype"])


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> tensor of every parameter of ``cfg``, on ``device``."""
    specs: List[tuple] = family(cfg).param_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    normal = [s for s in specs if s[2] == "normal"]
    out: Dict[str, torch.Tensor] = {}
    it = iter(normal)
    pending = next(it, None)
    while pending is not None:
        group, n = [], 0                  # leaves drawn in one call
        while pending is not None and (not group or n + math.prod(pending[1]) <= BLOCK):
            group.append(pending)
            n += math.prod(pending[1])
            pending = next(it, None)
        draw = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
        at = 0
        for name, shape, _, std in group:
            size = math.prod(shape)
            out[name] = (draw[at:at + size].view(shape) * std).to(storage_dtype(cfg, name))
            at += size
        del draw
    dts = [s for s in specs if s[2] == "dt_bias"]
    u = torch.rand(sum(math.prod(s[1]) for s in dts), generator=gen, device=device)
    lo, hi = math.log(1e-3), math.log(1e-1)
    at = 0
    for name, shape, kind, _ in specs:
        dt = storage_dtype(cfg, name)
        if kind == "ones":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif kind == "zeros":
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        elif kind == "a_log":
            out[name] = torch.log(torch.linspace(1.0, 16.0, shape[0], dtype=torch.float64,
                                                 device=device)).to(dt)
        elif kind == "dt_bias":
            size = math.prod(shape)
            dt0 = torch.exp(u[at:at + size] * (hi - lo) + lo).view(shape)
            out[name] = torch.log(torch.expm1(dt0)).to(dt)           # inverse softplus
            at += size
        elif kind != "normal":
            raise ValueError(f"unknown init {kind!r} of {name}")
    return {name: out[name] for name, *_ in specs}
