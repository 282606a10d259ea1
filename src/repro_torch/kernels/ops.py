"""Public kernel ops: dispatch on the device of the tensors given.

A CPU tensor takes the plain PyTorch version. A CUDA tensor takes the
hand-written kernel, or the call raises: there is no path from a CUDA tensor
to the plain version.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import attention_ref, rglru_ref
from repro_torch.kernels.rglru_scan import rglru_scan_fwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd


def _all_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Causal GQA attention. q [B,S,Hq,D]; k,v [B,S,Hk,D] -> [B,S,Hq,D].

    With ``window`` W > 0, query t attends keys [t-W+1, t] only."""
    if _all_cpu(q, k, v):
        return attention_ref(q, k, v, softcap=softcap, window=window)
    return flash_attention_fwd(q, k, v, softcap=softcap, window=window)


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, chunk: int, round_to: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: ``ssd_chunked`` computed in f32, y cast to x's dtype.

    With ``round_to``, xdt and C B^T * L are rounded to that dtype before the
    intra-chunk product, as the bf16 kernel rounds them (``round_to=
    torch.bfloat16``); the state path stays in f32."""
    from repro_torch.models.ssm import ssd_chunked   # models.ssm imports this module
    y, state = ssd_chunked(x.float(), dt.float(), A.float(), B.float(), C.float(),
                           chunk=chunk, round_to=round_to)
    return y.to(x.dtype), state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan. x [b,s,h,p]; dt [b,s,h]; A [h]; B,C [b,s,g,n] ->
    (y [b,s,h,p] in x's dtype, final state [b,h,n,p] f32)."""
    if _all_cpu(x, dt, A, B, C):
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    return ssd_scan_fwd(x, dt, A, B, C, chunk=chunk)


def rglru_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Diagonal recurrence h_t = a_t h_{t-1} + b_t from h = 0. a, b [B,S,W]
    -> h [B,S,W] f32."""
    if _all_cpu(a, b):
        return rglru_ref(a, b)
    return rglru_scan_fwd(a, b)
