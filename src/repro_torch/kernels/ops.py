"""Public kernel ops: one ``torch.autograd.Function`` per op.

Only a Function's forward dispatches on the device of the tensors given: a
CPU tensor takes the plain PyTorch version, a CUDA tensor takes the
hand-written kernel, or the call raises (there is no path from a CUDA tensor
to the plain version). The backward is the same code on both devices, so the
CPU tests run the backward that the card runs. The JAX package has no
backward Pallas kernel, and each backward mirrors what it differentiates:

* flash attention: the gradient of a recompute through the model path's
  attention (``models.attention.model_path_attention``: chunked causal, or
  banded local with a window), as the JAX op's ``_fa_bwd`` does;
* SSD scan: the gradient of a recompute through ``models.ssm.ssd_chunked``,
  which the JAX train path differentiates;
* RG-LRU recurrence: the reverse recurrence ``g_t = dL/dh_t + a_{t+1} g_{t+1}``,
  run by the forward op itself (the kernel on the card) on the flipped
  sequence, then ``dL/db_t = g_t`` and ``dL/da_t = g_t h_{t-1}``.

Each forward hands the raw launchers ``.detach()``ed tensors; the launchers
themselves raise on tensors that require grad. Under tensor-parallel compute
(``parallel.tensor``) a Function takes each rank's local tensors as they
are: flash attention its q heads and the kv heads they read, the SSD scan
its heads, the RG-LRU its slice of the width; no DTensor reaches a kernel.

On ``meta`` tensors (every input on ``meta``: the dry run, ``launch.dryrun``)
a forward does no arithmetic: it returns empty tensors of the output's shape
and dtype and records the kernel's operations and bytes (``kernels.cost``)
with the analysis that is recording. Neither a CPU nor a CUDA tensor reaches
that branch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import attention_ref, attention_tiled_ref, rglru_chunked_ref
from repro_torch.kernels.rglru_scan import CHUNK as RGLRU_CHUNK, rglru_scan_fwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd


def _all_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _all_meta(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "meta" for t in ts)


def _leaves(*ts: torch.Tensor):
    """Detached copies of the saved inputs that require grad, for a recompute."""
    return [t.detach().requires_grad_(True) for t in ts]


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, softcap: float, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.softcap, ctx.window = softcap, window
        q, k, v = q.detach(), k.detach(), v.detach()
        if _all_meta(q, k, v):
            b, s, hq, d = q.shape
            cost.record("flash_attention", cost.attention_cost(
                b, s, hq, k.shape[2], d, q.element_size(), window))
            return torch.empty_like(q)
        if _all_cpu(q, k, v):
            # the plain version of the kernel that dtype launches: bf16 rounds
            # each key tile's unnormalised p, f32 keeps P in f32
            if q.dtype == torch.bfloat16:
                return attention_tiled_ref(q, k, v, softcap=softcap, window=window)
            return attention_ref(q, k, v, softcap=softcap, window=window)
        return flash_attention_fwd(q, k, v, softcap=softcap, window=window)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models import attention   # models.attention imports this module
        q, k, v = _leaves(*ctx.saved_tensors)
        with torch.enable_grad():
            o = attention.model_path_attention(q, k, v, softcap=ctx.softcap, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Causal GQA attention. q [B,S,Hq,D]; k,v [B,S,Hk,D] -> [B,S,Hq,D].

    With ``window`` W > 0, query t attends keys [t-W+1, t] only."""
    return FlashAttention.apply(q, k, v, softcap, window)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

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


class SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)   # an unused final state's grad stays None
        args = [t.detach() for t in (x, dt, A, B, C)]
        if _all_meta(*args):
            b, s, h, p = x.shape
            g, n = B.shape[2:]
            cost.record("ssd_scan", cost.ssd_cost(b, s, h, p, g, n, chunk, x.element_size()))
            return (torch.empty_like(x),
                    torch.empty((b, h, n, p), dtype=torch.float32, device=x.device))
        if _all_cpu(*args):   # with the bf16 kernel's two roundings in bf16
            return ssd_scan_plain(*args, chunk=chunk, round_to=(
                torch.bfloat16 if x.dtype == torch.bfloat16 else None))
        return ssd_scan_fwd(*args, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        from repro_torch.models import ssm   # models.ssm imports this module
        inputs = _leaves(*ctx.saved_tensors)
        with torch.enable_grad():
            y, state = ssm.ssd_chunked(*inputs, chunk=ctx.chunk)
            pairs = [(o, g) for o, g in ((y, gy), (state, gstate)) if g is not None]
            if not pairs:
                return None, None, None, None, None, None
            grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                        [g for _, g in pairs], allow_unused=True)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD scan. x [b,s,h,p]; dt [b,s,h]; A [h]; B,C [b,s,g,n] ->
    (y [b,s,h,p] in x's dtype, final state [b,h,n,p] f32)."""
    return SSDScan.apply(x, dt, A, B, C, chunk)


# ---------------------------------------------------------------------------
# RG-LRU recurrence
# ---------------------------------------------------------------------------

def _recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h = 0: the kernel on the card, its
    association in plain PyTorch on the CPU (``rglru_chunked_ref``: the
    carry folded over chunks of RGLRU_CHUNK steps, bit-equal to the
    step-by-step recurrence while S <= 2 * RGLRU_CHUNK, since the first
    carry is the first chunk's last h); on meta, an empty h and the
    kernel's cost recorded."""
    if _all_meta(a, b):
        cost.record("rglru_scan", cost.rglru_cost(*a.shape, a.element_size()))
        return torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if _all_cpu(a, b):
        return rglru_chunked_ref(a, b, RGLRU_CHUNK)
    return rglru_scan_fwd(a, b)


def rglru_reverse(a: torch.Tensor, h: torch.Tensor, gh: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dL/da, dL/db) of h = recurrence(a, b), given h and dL/dh.

    g_t = dL/dh_t + a_{t+1} g_{t+1} (g_{S-1} = dL/dh_{S-1}) is the forward
    recurrence on the flipped sequence with a' = (a_1, ..., a_{S-1}, 0);
    dL/db_t = g_t and dL/da_t = g_t h_{t-1} with h_{-1} = 0."""
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1).to(gh.dtype)
    g = _recurrence(a_next.flip(1), gh.flip(1)).flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
    return g * h_prev, g


class RGLRURecurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = _recurrence(a.detach(), b.detach())
        ctx.save_for_backward(a, h)
        ctx.b_dtype = b.dtype
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h = ctx.saved_tensors
        da, db = rglru_reverse(a.detach(), h.detach(), gh.float())
        return da.to(a.dtype), db.to(ctx.b_dtype)


def rglru_recurrence(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Diagonal recurrence h_t = a_t h_{t-1} + b_t from h = 0. a, b [B,S,W]
    -> h [B,S,W] f32."""
    return RGLRURecurrence.apply(a, b)
