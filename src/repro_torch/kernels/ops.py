"""Public kernel ops: dispatch on the device of the tensors given.

A CPU tensor takes the plain PyTorch version (``kernels.ref``). A CUDA
tensor takes the hand-written kernel, or the call raises: there is no path
from a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    softcap: float = 0.0) -> torch.Tensor:
    """Causal GQA attention. q [B,S,Hq,D]; k,v [B,S,Hk,D] -> [B,S,Hq,D]."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_ref(q, k, v, softcap=softcap)
    return flash_attention_fwd(q, k, v, softcap=softcap)
