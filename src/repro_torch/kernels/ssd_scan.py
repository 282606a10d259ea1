"""Hopper SSD chunked scan (forward): wrapper around csrc/ssd_scan.cu.

The CUDA counterpart of the TPU kernel ``ssd_scan_chunked`` of
``repro.kernels.ssd_scan`` together with its wrapper ``ops.ssd_scan``: the
Mamba2 SSD scan, chunk by chunk with the state carried in order. It takes
x [b,s,h,p], dt [b,s,h] f32, A [h] f32 and B, C [b,s,g,n] in the public
layout (strides, no padded or repeated copies), x, B and C all float32 or all
bfloat16, any s; and returns (y [b,s,h,p] in x's dtype, the final state
[b,h,n,p] f32). This launcher is the forward alone and raises if an input
requires grad: ``ops.ssd_scan`` is the autograd Function around it.

bfloat16 runs on the tensor cores (wgmma): xdt and C B^T * L are rounded to
bf16 before the intra-chunk product, as the JAX model path rounds them
(``ops.ssd_scan_plain(round_to=torch.bfloat16)`` is the same arithmetic),
while the state keeps f32 precision through a hi/lo bf16 split. Its 16-byte
copies need x, B and C to start on 16 bytes with batch, sequence and
head/group strides in multiples of 8 elements, which ``check_inputs``
demands. float32 runs the scalar kernel, all arithmetic in f32, as the TPU
kernel computes it.

``ssd_scan_fwd.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_CHUNK = 128
MAX_STATE = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
             + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_int64] * 15)


def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def check_inputs(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int) -> None:
    """Raises on anything the kernel does not take (device aside)."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"expected x [b,s,h,p], dt [b,s,h], A [h], B, C [b,s,g,n]; got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or tuple(B.shape[:2]) != (b, s):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B/C {tuple(B.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"h={h} is not a multiple of g={g}")
    if p % 16:
        raise ValueError(f"head dim p={p} is not a multiple of 16")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size n={n} not in [1, {MAX_STATE}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} not in [1, {MAX_CHUNK}]")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"dtypes of x, B, C: {x.dtype}, {B.dtype}, {C.dtype}: expected all "
                        f"float32 or all bfloat16")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32; got {dt.dtype}, {A.dtype}")
    if any(t.stride(-1) != 1 for t in (x, B, C, A)):
        raise ValueError("the last dim of x, B, C and A must be contiguous")
    if x.dtype == torch.bfloat16:
        for name, t in (("x", x), ("B", B), ("C", C)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(
                    f"bf16 {name} must start on 16 bytes with batch, sequence and "
                    f"head/group strides in multiples of 8 elements; got address "
                    f"{t.data_ptr():#x}, strides {t.stride()}")
    if any(t.requires_grad for t in (x, dt, A, B, C)):
        raise RuntimeError("ssd_scan_fwd is the forward launcher alone; "
                           "differentiate through ops.ssd_scan")


def ssd_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches the CUDA kernel on x's device and PyTorch's current stream."""
    check_inputs(x, dt, A, B, C, chunk)
    if x.device.type != "cuda" or any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError(f"ssd_scan_fwd needs x, dt, A, B, C on one CUDA device; got "
                         f"{[str(t.device) for t in (x, dt, A, B, C)]}")
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    chunk = min(chunk, max(s, 1))   # as ssd_chunked: a prompt shorter than a chunk is one chunk
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    if b * h == 0:
        return y, state
    if s == 0:
        return y, state.zero_()
    lib = _library()
    with torch.cuda.device(x.device):   # the kernel launches on the current device
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan_fwd(
            x.device.index, stream, _DTYPES[x.dtype],
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), state.data_ptr(), b, s, h, p, g, n, chunk,
            *x.stride()[:3], *dt.stride(), *B.stride()[:3], *C.stride()[:3],
            *y.stride()[:3])
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"{build.error_string(lib, err)} (cuda error {err})")
    ssd_scan_fwd.launches += 1
    return y, state


ssd_scan_fwd.launches = 0
