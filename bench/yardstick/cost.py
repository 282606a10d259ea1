"""Operations and bytes of the kernel ops, forward and backward, and the
card's peak rates: the benchmark's frozen copy.

The forward counts are a copy of ``repro_torch.kernels.cost`` as it stood
when the benchmark was written (``tests/test_bench_yardstick.py`` holds the
copy to it at the shapes of the port's kernel table); the backward counts
are the benchmark's own. Each count is the work the function needs at those
shapes, each input read once and each output written once, whatever an
implementation recomputes or reads again.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W limit
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12

Cost = Tuple[float, float]


def attention_cost(b: int, s: int, hq: int, hk: int, d: int, itemsize: int,
                   window: int = 0) -> Cost:
    """Causal attention's forward: QK^T and P.V over the (query, key) pairs
    of the causal band; q, k, v read once, o written once."""
    w = window if 0 < window < s else s
    pairs = w * (w + 1) / 2 + (s - w) * w
    return 4.0 * b * hq * d * pairs, 2.0 * b * s * (hq + hk) * d * itemsize


def attention_bwd_cost(b: int, s: int, hq: int, hk: int, d: int, itemsize: int,
                       window: int = 0) -> Cost:
    """Its backward: dV = P^T dO, dP = dO V^T, dQ = dS K and dK = dS^T Q over
    the same pairs, twice the forward's products (P is the forward's, not
    computed again: a recompute is the implementation's, not the work); q,
    k, v, o and dO read once, dq, dk and dv written once."""
    flops, _ = attention_cost(b, s, hq, hk, d, itemsize, window)
    return 2.0 * flops, (4.0 * hq + 4.0 * hk) * b * s * d * itemsize


def ssd_cost(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
             itemsize: int) -> Cost:
    """The SSD scan's forward: per head and chunk, C B^T and its product with
    xdt, 2L^2(n+p), and C.state and the state update, 4Lnp; x, B, C read once
    in their dtype, dt and A in f32; y written once in x's dtype, the final
    state in f32."""
    nc = -(-s // chunk)
    flops = b * h * nc * (2.0 * chunk ** 2 * (n + p) + 4.0 * chunk * n * p)
    nbytes = (2 * b * s * h * p * itemsize + 2 * b * s * g * n * itemsize
              + 4 * (b * s * h + h) + 4 * b * h * n * p)
    return flops, nbytes


def ssd_bwd_cost(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
                 itemsize: int) -> Cost:
    """Its backward, the final state's gradient unused (as in training): each
    forward product differentiated against both its operands, twice the
    forward's operations; x, B, C and dy read once in their dtype, dt and A
    in f32; dx, dB, dC written once in their dtype, ddt and dA in f32."""
    flops, _ = ssd_cost(b, s, h, p, g, n, chunk, itemsize)
    nbytes = (4 * b * s * h * p * itemsize + 4 * b * s * g * n * itemsize
              + 8 * (b * s * h + h))
    return 2.0 * flops, nbytes


def least_s(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS_BF16) -> float:
    """The least seconds of that work: operations at their peak or bytes at
    the memory rate, whichever takes longer."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
