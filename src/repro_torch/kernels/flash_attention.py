"""Hopper flash attention (forward): wrapper around csrc/flash_attention.cu.

The CUDA counterpart of the TPU kernel ``flash_attention_fwd`` of
``repro.kernels.flash_attention``: causal GQA attention with an f32 online
softmax, optional tanh softcap, optional sliding window (query t attends
keys [t-W+1, t], as ``attention_ref(window=W)``; the TPU kernel has none),
any sequence length. It takes q [B,S,Hq,D] and k, v [B,S,Hk,D] in the
public layout (strides, no transposed copies), float32 or bfloat16, D in
{16, 32, 64, 128, 256}, and returns [B,S,Hq,D] in q's dtype. Forward only:
it raises if an input requires grad.

bfloat16 runs on the tensor cores (wgmma) and rounds the probabilities P to
bf16 before P.V, as the JAX model path does; its 16-byte copies need each
tensor's start on 16 bytes and its batch, sequence and head strides in
multiples of 8 elements, which ``check_inputs`` demands. float32 runs the
scalar kernel, with P in f32 as the TPU kernel keeps it.

``flash_attention_fwd.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_int64] * 12 + [ctypes.c_float] * 2 + [ctypes.c_int])


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int = 0) -> None:
    """Raises on anything the kernel does not take (device aside)."""
    if window < 0:
        raise ValueError(f"window {window} < 0 (0 means none)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,S,Hq,D] and k, v [B,S,Hk,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hk={k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: expected all "
                        f"float32 or all bfloat16")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the last dim of q, k and v must be contiguous")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"bf16 {name} must start on 16 bytes with batch, sequence and "
                    f"head strides in multiples of 8 elements; got address "
                    f"{t.data_ptr():#x}, strides {t.stride()}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention_fwd is forward-only; its autograd "
                           "Function comes with the training slice")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Launches the CUDA kernel on q's device and PyTorch's current stream.

    ``window`` W > 0 restricts query t to keys [t-W+1, t]; 0 means none."""
    check_inputs(q, k, v, window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_fwd needs q, k, v on one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    b, s, hq, d = q.shape
    o = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = _library()
    with torch.cuda.device(q.device):   # the kernel launches on the current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.device.index, stream, _DTYPES[q.dtype],
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, s, hq, k.shape[2], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            d ** -0.5, float(softcap), int(window))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{build.error_string(lib, err)} (cuda error {err})")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0
