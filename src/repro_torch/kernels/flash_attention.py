"""Hopper flash attention (forward): wrapper around csrc/flash_attention.cu.

The CUDA counterpart of the TPU kernel ``flash_attention_fwd`` of
``repro.kernels.flash_attention``: causal GQA attention with an f32 online
softmax, optional tanh softcap, optional sliding window (query t attends
keys [t-W+1, t], as ``attention_ref(window=W)``; the TPU kernel has none),
any sequence length. It takes q [B,S,Hq,D] and k, v [B,S,Hk,D] in the
public layout (strides, no transposed copies), float32 or bfloat16, D in
``HEAD_DIMS``, and returns [B,S,Hq,D] in q's dtype. The kernel is
instantiated at D in {16, 32, 64, 128, 192, 256}; D = 8, below one k-step
of the tensor cores, runs the D = 16 instantiation on copies zero-padded to
16 with the scale of the true D (``pad_head_dim``), and the output is sliced
back. This launcher is the forward alone and raises if an input requires
grad: ``ops.flash_attention`` is the autograd Function around it.

bfloat16 runs on the tensor cores (wgmma) and rounds each 64-key tile's
unnormalised probabilities to bf16 before P.V, as the JAX model path's
chunked attention does (``ref.attention_tiled_ref`` repeats it, and is the
op's CPU path in bf16); its 16-byte copies need each
tensor's start on 16 bytes and its batch, sequence and head strides in
multiples of 8 elements, which ``check_inputs`` demands (a padded copy
meets it by construction). float32 runs the scalar kernel, with P in f32 as
the TPU kernel keeps it.

``flash_attention_fwd.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

KERNEL_HEAD_DIMS = (16, 32, 64, 128, 192, 256)   # the kernel's instantiations
PADDED_HEAD_DIMS = {8: 16}                       # D -> the instantiation it runs
HEAD_DIMS = tuple(sorted((*KERNEL_HEAD_DIMS, *PADDED_HEAD_DIMS)))
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
    if q.dtype == torch.bfloat16 and d not in PADDED_HEAD_DIMS:   # padded: fresh copies
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"bf16 {name} must start on 16 bytes with batch, sequence and "
                    f"head strides in multiples of 8 elements; got address "
                    f"{t.data_ptr():#x}, strides {t.stride()}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention_fwd is the forward launcher alone; "
                           "differentiate through ops.flash_attention")


def pad_head_dim(attend: Callable[..., torch.Tensor], q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, **kwargs) -> torch.Tensor:
    """``attend(q, k, v, scale=, **kwargs)`` on copies of q, k, v zero-padded
    along D to the instantiation that D runs (``PADDED_HEAD_DIMS``), with the
    true D's scale D^-0.5; the output's padded columns are sliced off.

    Zero columns add nothing to q.k, and the padded columns of v give output
    columns that are dropped, so this is attention at the true D."""
    d = q.shape[-1]
    pad = PADDED_HEAD_DIMS[d] - d
    o = attend(*(F.pad(t, (0, pad)) for t in (q, k, v)), scale=d ** -0.5, **kwargs)
    return o[..., :d]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """Launches the CUDA kernel on q's device and PyTorch's current stream.

    ``window`` W > 0 restricts query t to keys [t-W+1, t]; 0 means none."""
    check_inputs(q, k, v, window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_fwd needs q, k, v on one CUDA device; "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.shape[-1] in PADDED_HEAD_DIMS:
        return pad_head_dim(_launch, q, k, v, softcap=softcap, window=window)
    return _launch(q, k, v, scale=q.shape[-1] ** -0.5, softcap=softcap, window=window)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
            softcap: float, window: int) -> torch.Tensor:
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
            float(scale), float(softcap), int(window))
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{build.error_string(lib, err)} (cuda error {err})")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0
