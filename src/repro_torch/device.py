"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller says.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    visible: the port never carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on an NVIDIA GPU by default and torch sees no "
            "CUDA device; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch path on the CPU")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """torch dtype of a config dtype name ("bfloat16", "float32", ...)."""
    dt: Optional[torch.dtype] = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
