"""The port's RG-LRU scan against the JAX package's kernel and oracle.

On the CPU, ``repro_torch.kernels.ops.rglru_recurrence`` takes the plain
version of the kernel's association (``ref.rglru_chunked_ref``, which for
S <= 512 is ``ref.rglru_ref``, step by step in f32); it and the plain version
are held against the Pallas kernel in interpret mode (as tests/test_kernels.py
runs it, through ``repro.kernels.ops.rglru_recurrence``) over the shape grid
of ``test_rglru_scan_sweep``, and against the JAX oracle. The CUDA kernel
itself is held against ``rglru_ref`` on the card by
tests/test_torch_kernels_cuda.py, which imports no JAX. Inputs come from a
numpy seed and go to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rglru_recurrence as jax_rglru_recurrence
from repro.kernels.ref import rglru_ref as jax_rglru_ref
from repro_torch.kernels import ops
from repro_torch.kernels.ref import rglru_chunked_ref, rglru_ref
from repro_torch.kernels.rglru_scan import check_inputs, rglru_scan_fwd

TOL = 1e-5   # max abs error, f32 h (tests/test_kernels.py holds the Pallas kernel to it)

# (b, s, w, block_s, block_w): test_rglru_scan_sweep's grid
SHAPES = [
    (2, 128, 256, 32, 128),
    (1, 300, 64, 256, 512),          # non-divisible fallback blocks
    (3, 64, 512, 64, 256),
]


def _inputs(b, s, w, dtype="float32", seed=0):
    """a = sigmoid(N(0,1)) * 0.2 + 0.79 and b ~ N(0,1), as tests/test_kernels.py,
    in ``dtype``: (jax a, b), (torch a, b)."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w)))) * 0.2 + 0.79).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    jx = tuple(jnp.asarray(t).astype(getattr(jnp, dtype)) for t in (a, x))
    tx = tuple(torch.from_numpy(t).to(getattr(torch, dtype)) for t in (a, x))
    return jx, tx


def _err(t, j):
    return float(np.abs(t.numpy() - np.asarray(j, dtype=np.float32)).max())


@pytest.mark.parametrize("b,s,w,bs,bw", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel_and_oracle(b, s, w, bs, bw, dtype):
    """bf16 inputs: both sides widen the same values to f32, so f32's bound holds."""
    (ja, jb), (a, x) = _inputs(b, s, w, dtype)
    h = ops.rglru_recurrence(a, x)
    assert h.dtype == torch.float32 and h.shape == (b, s, w)
    assert _err(h, jax_rglru_recurrence(ja, jb, block_s=bs, block_w=bw)) <= TOL
    assert _err(h, jax_rglru_ref(ja, jb)) <= TOL
    assert torch.equal(rglru_ref(a, x), h)


@pytest.mark.parametrize("chunk,s", [(1, 300), (7, 300), (7, 5), (64, 300), (64, 50),
                                     (256, 300), (256, 200)])
def test_chunked_plain_matches_pallas_kernel_and_oracle(chunk, s):
    """The CUDA kernel's association (chunk aggregates, a folded carry, the
    chunk walked again) against the step-by-step oracle and the Pallas kernel,
    with S not a multiple of the chunk and S shorter than it."""
    (ja, jb), (a, x) = _inputs(2, s, 64, seed=5 + chunk)
    h = rglru_chunked_ref(a, x, chunk)
    assert h.dtype == torch.float32 and h.shape == (2, s, 64)
    assert float((h - rglru_ref(a, x)).abs().max()) <= TOL
    assert _err(h, jax_rglru_recurrence(ja, jb)) <= TOL
    if s <= chunk:                  # one chunk: the step-by-step order itself
        assert torch.equal(h, rglru_ref(a, x))


def test_zero_length_and_first_step():
    (_, _), (a, x) = _inputs(2, 6, 8, seed=1)
    assert rglru_ref(a[:, :0], x[:, :0]).shape == (2, 0, 8)
    assert rglru_chunked_ref(a[:, :0], x[:, :0], 4).shape == (2, 0, 8)
    h = ops.rglru_recurrence(a, x)
    torch.testing.assert_close(h[:, 0], x[:, 0], atol=0, rtol=0)      # from h = 0
    torch.testing.assert_close(h[:, 1], a[:, 1] * x[:, 0] + x[:, 1], atol=0, rtol=0)


def test_cpu_never_launches_the_kernel():
    (_, _), (a, x) = _inputs(1, 16, 8, seed=2)
    before = rglru_scan_fwd.launches
    ops.rglru_recurrence(a, x)
    assert rglru_scan_fwd.launches == before == 0


def test_wrapper_refuses_cpu_tensors():
    """The kernel wrapper has no path to the plain version."""
    (_, _), (a, x) = _inputs(1, 16, 8, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_fwd(a, x)


@pytest.mark.parametrize("case", ["rank", "shape", "dtype", "mixed_dtype", "grad"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    (_, _), (a, x) = _inputs(1, 16, 8, seed=4)
    err = ValueError
    if case == "rank":
        a, x = a[0], x[0]
    elif case == "shape":
        x = x[:, :8]
    elif case == "dtype":
        a, x, err = a.half(), x.half(), TypeError
    elif case == "mixed_dtype":
        x, err = x.bfloat16(), TypeError
    else:
        a, err = a.requires_grad_(True), RuntimeError
    with pytest.raises(err):
        check_inputs(a, x)
