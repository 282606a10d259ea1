"""Hopper RG-LRU scan (forward): wrapper around csrc/rglru_scan.cu.

The CUDA counterpart of the TPU kernel ``rglru_scan_pallas`` of
``repro.kernels.rglru_scan`` together with its wrapper
``ops.rglru_recurrence``: the diagonal linear recurrence
h_t = a_t * h_{t-1} + b_t from a zero state, in f32. It takes a and b
[B, S, W] in the public layout (strides, no copies), both float32 or both
bfloat16, any S and W; and returns h [B, S, W] float32. This launcher
raises if an input requires grad: ``ops.rglru_recurrence`` is the autograd
Function around it, whose backward runs this launcher again on the reversed
sequence.

The sequence is split into chunks of ``CHUNK`` steps: one kernel computes
each chunk's aggregate, a second folds the carry into each chunk and walks
it again (``ref.rglru_chunked_ref(a, b, CHUNK)`` is the same arithmetic).

``rglru_scan_fwd.launches`` counts the wrapper's calls that launched (two
kernels each; one where S fits in one chunk).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

CHUNK = 256    # steps a thread walks: 16 times the first port's threads at S=4096
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_int] * 4 + [ctypes.c_int64] * 6)


def _library() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    fn = lib.repro_rglru_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def check_inputs(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raises on anything the kernel does not take (device aside)."""
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"expected a, b [B,S,W] of one shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}, {b.dtype}: expected both float32 or "
                        f"both bfloat16")
    if a.requires_grad or b.requires_grad:
        raise RuntimeError("rglru_scan_fwd is the launcher alone; "
                           "differentiate through ops.rglru_recurrence")


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launches the CUDA kernel on a's device and PyTorch's current stream."""
    check_inputs(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"rglru_scan_fwd needs a, b on one CUDA device; "
                         f"got {a.device}, {b.device}")
    bb, s, w = a.shape
    h = torch.empty((bb, s, w), dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h
    # each chunk's product of a and h at its end, from h = 0
    agg = torch.empty((bb, -(-s // CHUNK), 2, w), dtype=torch.float32, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):   # the kernels launch on the current device
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_rglru_scan_fwd(stream, _DTYPES[a.dtype], a.data_ptr(),
                                       b.data_ptr(), h.data_ptr(), agg.data_ptr(),
                                       bb, s, w, CHUNK, *a.stride(), *b.stride())
    if err:
        raise RuntimeError(f"rglru_scan kernel launch failed: "
                           f"{build.error_string(lib, err)} (cuda error {err})")
    rglru_scan_fwd.launches += 1
    return h


rglru_scan_fwd.launches = 0
