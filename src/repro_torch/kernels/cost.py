"""The kernels' operation and byte counts, and the card's peak rates.

One copy of the arithmetic that both ``chip_smoke.py`` (each kernel's
``bound_ms`` in its record) and the dry run (``launch.dryrun``: the kernel
ops' share of a step's FLOPs and HBM bytes on the ``meta`` device) read.
Each ``*_cost`` returns ``(flops, bytes)`` for one call on inputs of those
shapes: the operations the function needs and its bytes, each input read once
and each output written once.

``recording(sink)`` makes ``sink(name, flops, nbytes)`` see every kernel op
that runs on ``meta`` tensors inside the block (``kernels.ops`` calls
``record``); no op records outside one.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W limit
PEAK_FLOPS_BF16 = 989e12   # bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12     # f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # HBM3

Cost = Tuple[float, float]


def attention_cost(b: int, s: int, hq: int, hk: int, d: int, itemsize: int,
                   window: int = 0) -> Cost:
    """Causal attention: QK^T and P.V over the (query, key) pairs in the
    causal band (S(S+1)/2, or with a window W < S, W(W+1)/2 + (S-W)W); q, k,
    v read once, o written once."""
    w = window if 0 < window < s else s
    pairs = w * (w + 1) / 2 + (s - w) * w
    return 4.0 * b * hq * d * pairs, 2.0 * b * s * (hq + hk) * d * itemsize


def ssd_cost(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
             itemsize: int) -> Cost:
    """The SSD scan: per head and chunk, C B^T and its product with xdt,
    2L^2(n+p), and C.state and the state update, 4Lnp; x, B, C read once in
    their dtype, dt and A in f32; y written once in x's dtype, the final
    state in f32."""
    nc = -(-s // chunk)
    flops = b * h * nc * (2.0 * chunk ** 2 * (n + p) + 4.0 * chunk * n * p)
    nbytes = (2 * b * s * h * p * itemsize + 2 * b * s * g * n * itemsize
              + 4 * (b * s * h + h) + 4 * b * h * n * p)
    return flops, nbytes


def rglru_cost(b: int, s: int, w: int, itemsize: int) -> Cost:
    """The RG-LRU recurrence: a multiply and an add an element in f32; a and
    b read once in their dtype, h written once in f32."""
    n = b * s * w
    return 2.0 * n, n * (2 * itemsize + 4)


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS_BF16):
    """(least time in ms, what bounds it): operations at the peak of their
    type (bf16 unless said) or bytes at the memory rate, whichever takes longer."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound_ms(b: int, s: int, hq: int, hk: int, d: int, itemsize: int,
                       window: int = 0):
    return bound(*attention_cost(b, s, hq, hk, d, itemsize, window))


def ssd_bound_ms(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
                 itemsize: int):
    return bound(*ssd_cost(b, s, h, p, g, n, chunk, itemsize))


def rglru_bound_ms(b: int, s: int, w: int, itemsize: int):
    return bound(*rglru_cost(b, s, w, itemsize), PEAK_FLOPS_F32)


# ---------------------------------------------------------------------------
# Recording the kernel ops of a meta run
# ---------------------------------------------------------------------------

Sink = Callable[[str, float, float], None]
_SINKS: List[Sink] = []


@contextlib.contextmanager
def recording(sink: Sink) -> Iterator[None]:
    """Inside the block, ``sink(name, flops, nbytes)`` sees each kernel op
    run on meta tensors."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)


def record(name: str, cost: Cost) -> None:
    for sink in _SINKS:
        sink(name, *cost)
