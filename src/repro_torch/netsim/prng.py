"""Counter-based randomness for the channel models: a threefry2x32 that
matches ``jax.random`` bit for bit.

The JAX package draws every impairment from ``jax.random`` keys folded from
a static seed, a per-scenario salt and the step index. The port reproduces
those draws exactly: ``prng_key`` is ``jax.random.PRNGKey``, ``fold_in`` is
``jax.random.fold_in``, ``random_bits`` and ``uniform`` are
``jax.random.bits`` and ``jax.random.uniform`` (f32) under
``jax_threefry_partitionable=True`` (JAX's default since 0.5): the counters
of an n-element draw are the 64-bit iota 0..n-1 split into a high and a low
word, and 32-bit output is the XOR of the two hash words. The float
conversion keeps the 23 high bits as the mantissa of a number in [1, 2)
(``(bits >> 9) | 0x3F800000``) and subtracts 1.

torch has no full uint32 arithmetic, so a uint32 is held in an int64 tensor
and every add and rotation is masked back to 32 bits. A key is an int64
tensor ``[..., 2]``: one call serves a whole ``[B]`` or ``[B, L]`` batch of
keys, each drawing independently, and nothing reads a value back to the
host, so a draw can sit inside a captured CUDA graph.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x0, x1)``
    under ``key``: ``key[..., 0]``, ``key[..., 1]`` broadcast against the
    counters. Returns the two output words as int64 tensors in
    [0, 2**32)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor: the seed as
    a 32-bit integer (JAX's default width), high word 0."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise OverflowError(f"prng_key: seed {seed} does not fit 32 bits")
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def as_u32(data, device=None) -> torch.Tensor:
    """An integer or integer tensor as the uint32 it converts to, held in
    int64. An integer becomes a tensor filled on the device (no copy from
    the host, so it may sit in a captured CUDA graph)."""
    if not torch.is_tensor(data):
        return torch.full((), int(data) & M32, dtype=torch.int64, device=device)
    return data.to(torch.int64) & M32


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """The bits of an f32 tensor as a uint32 (``lax.bitcast_convert_type``)."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & M32


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key ``[..., 2]`` from ``key [..., 2]``
    and a uint32 ``data`` that broadcasts against ``key[..., 0]`` (the key's
    leading shape and the data's broadcast together)."""
    data = as_u32(data, key.device)
    y0, y1 = threefry2x32(key, 0, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) for each key of ``key
    [..., 2]``: an int64 tensor ``[..., *shape]`` of values in
    [0, 2**32)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    lead = key.shape[:-1]
    key = key.reshape(*lead, *([1] * len(shape)), 2)
    if shape:
        count = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
        hi, lo = count >> 32, count & M32
    else:
        hi = lo = 0
    y0, y1 = threefry2x32(key, hi, lo)
    return torch.broadcast_to(y0 ^ y1, lead + shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32 on [0, 1) for each key of
    ``key [..., 2]``: ``[..., *shape]``."""
    bits = (random_bits(key, shape) >> 9) | _ONE_F32_BITS
    return bits.to(torch.int32).view(torch.float32) - 1.0
