"""The port's SSD scan against the JAX package's kernel, oracle and model path.

On the CPU, ``repro_torch.kernels.ops.ssd_scan`` takes the plain version
(``ssd_chunked`` in f32, with the bf16 kernel's roundings of xdt and
C B^T * L for bf16 inputs); it is held against the Pallas kernel in interpret
mode (as tests/test_kernels.py runs it) over the shape grid of
``test_ssd_scan_sweep`` plus a ragged S, against the step-by-step oracle,
and, with its final state, against the model path's ``ssd_chunked``. The
CUDA kernel itself is held against ``ssd_ref`` on the card by
tests/test_torch_kernels_cuda.py, which imports no JAX. Inputs come from a
numpy seed and go to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_scan as jax_ssd_scan
from repro.kernels.ref import ssd_ref as jax_ssd_ref
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_ref
from repro_torch.kernels.ssd_scan import check_inputs, ssd_scan_fwd
from repro_torch.models.ssm import ssd_chunked

REL_TOL = 1e-4      # max abs error / max |reference|, f32 (as tests/test_kernels.py)
BF16_REL_TOL = 8e-3  # bf16 output: one rounding (2^-9 of |y| <= max |y|) plus f32 sums
# Two plain versions with the same bf16 roundings of xdt and C B^T * L, y in
# f32: another f32 summation order rounds a few products C B^T * L to the
# neighbouring bf16 value (read up to 7.7e-5); the roundings themselves move
# y by 2.6e-3 to 7.1e-3 on these shapes, so this bound sees one dropped.
ROUNDED_REL_TOL = 1e-3
# The rounded plain version against the JAX model path in bf16, which also
# rounds y_diag and y to bf16 (two roundings of 2^-9 of |y|; read up to
# 3.8e-3) and takes the bf16 xdt into its per-chunk states (2^-9 a term; the
# state read up to 3.3e-3), where the plain version keeps them in f32.
MODEL_PATH_Y_TOL = 6e-3
MODEL_PATH_STATE_TOL = 5e-3

# (b, s, h, p, g, n, chunk): test_ssd_scan_sweep's grid, plus ragged S
SHAPES = [
    (2, 96, 4, 32, 1, 16, 32),
    (1, 256, 8, 64, 1, 128, 128),
    (2, 100, 4, 32, 2, 16, 32),      # padding path + groups
    (1, 64, 2, 16, 1, 8, 64),
    (2, 77, 4, 32, 1, 16, 32),       # ragged S, three chunks and a tail
]


def _inputs(b, s, h, p, g, n, seed=0, dtype="float32"):
    """The same inputs for both frameworks: (jax x, dt, A, B, C), (torch ...).

    x, B and C in ``dtype``; dt and A in f32, as the model path gives them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    low = (True, False, False, True, True)
    jx = tuple(jnp.asarray(a).astype(getattr(jnp, dtype)) if lo else jnp.asarray(a)
               for a, lo in zip((x, dt, A, B, C), low))
    tx = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) if lo else torch.from_numpy(a)
               for a, lo in zip((x, dt, A, B, C), low))
    return jx, tx


def _rel(t, j):
    ref = j.float().numpy() if isinstance(j, torch.Tensor) else np.asarray(j.astype(jnp.float32))
    return float(np.abs(t.float().numpy() - ref).max()) / (float(np.abs(ref).max()) + 1e-6)


@pytest.mark.parametrize("b,s,h,p,g,n,ck", SHAPES)
def test_matches_pallas_kernel_and_oracle(b, s, h, p, g, n, ck):
    jargs, targs = _inputs(b, s, h, p, g, n)
    y, state = ops.ssd_scan(*targs, chunk=ck)
    assert y.dtype == torch.float32 and y.shape == (b, s, h, p)
    assert state.dtype == torch.float32 and state.shape == (b, h, n, p)
    assert _rel(y, jax_ssd_scan(*jargs, chunk=ck)) < REL_TOL
    assert _rel(y, jax_ssd_ref(*jargs)) < REL_TOL


@pytest.mark.parametrize("b,s,h,p,g,n,ck", SHAPES)
def test_final_state_matches_model_path(b, s, h, p, g, n, ck):
    """The port's ssd_chunked (y and final state) against the JAX model path's."""
    jargs, targs = _inputs(b, s, h, p, g, n, seed=1)
    jy, jstate = jax_ssd_chunked(*jargs, chunk=ck)
    y, state = ssd_chunked(*targs, chunk=ck)
    assert _rel(y, jy) < REL_TOL
    assert _rel(state, jstate) < REL_TOL
    _, ops_state = ops.ssd_scan(*targs, chunk=ck)
    assert _rel(ops_state, jstate) < REL_TOL


@pytest.mark.parametrize("b,s,h,p,g,n,ck", SHAPES[::2])
def test_oracle_matches_jax_oracle(b, s, h, p, g, n, ck):
    jargs, targs = _inputs(b, s, h, p, g, n, seed=2)
    y, state = ssd_ref(*targs)
    assert _rel(y, jax_ssd_ref(*jargs)) < REL_TOL
    _, jstate = jax_ssd_chunked(*jargs, chunk=ck)
    assert _rel(state, jstate) < REL_TOL


def test_init_state_carries_into_the_scan():
    """Two halves, the second from the first's final state, equal the whole."""
    jargs, targs = _inputs(2, 96, 4, 32, 1, 16, seed=3)
    init = np.random.default_rng(4).standard_normal((2, 4, 16, 32)).astype(np.float32)
    jy, jstate = jax_ssd_chunked(*jargs, chunk=32, init_state=jnp.asarray(init))
    y, state = ssd_chunked(*targs, chunk=32, init_state=torch.from_numpy(init))
    assert _rel(y, jy) < REL_TOL and _rel(state, jstate) < REL_TOL
    x, dt, A, B, C = targs
    y1, s1 = ssd_ref(x[:, :40], dt[:, :40], A, B[:, :40], C[:, :40])
    y2, s2 = ssd_ref(x[:, 40:], dt[:, 40:], A, B[:, 40:], C[:, 40:], init_state=s1)
    y_all, s_all = ssd_ref(x, dt, A, B, C)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_all, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s2, s_all, atol=1e-5, rtol=1e-5)


def test_bf16_inputs_match_pallas_kernel():
    """bf16 x, B, C: the Pallas wrapper computes in f32, the port's plain
    version also rounds xdt and C B^T * L to bf16 as its bf16 kernel does;
    both round y once to bf16."""
    jargs, targs = _inputs(2, 100, 4, 32, 2, 16, seed=5, dtype="bfloat16")
    y, state = ops.ssd_scan(*targs, chunk=32)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    assert _rel(y, jax_ssd_scan(*jargs, chunk=32)) < BF16_REL_TOL
    _, jstate = jax_ssd_chunked(*(a.astype(jnp.float32) for a in jargs), chunk=32)
    assert _rel(state, jstate) < REL_TOL


@pytest.mark.parametrize("b,s,h,p,g,n,ck", SHAPES)
def test_rounded_plain_matches_model_path_in_bf16(b, s, h, p, g, n, ck):
    """ssd_scan_plain(round_to=bf16), the bf16 kernel's arithmetic, against the
    JAX model path's ssd_chunked run in bf16, which rounds xdt and C B^T * L
    the same way. dt is given as bf16 values, so the model path's
    x * bf16(dt) is the kernel's x * dt."""
    (jx, _, jA, jB, jC), (x, dt, A, B, C) = _inputs(b, s, h, p, g, n, seed=9, dtype="bfloat16")
    dt = dt.bfloat16().float()
    y, state = ops.ssd_scan_plain(x.float(), dt, A, B, C, chunk=ck, round_to=torch.bfloat16)
    assert y.dtype == torch.float32 and state.dtype == torch.float32
    jy, jstate = jax_ssd_chunked(jx, jnp.asarray(dt.numpy()), jA, jB, jC, chunk=ck)
    assert _rel(y, jy) < MODEL_PATH_Y_TOL
    assert _rel(state, jstate) < MODEL_PATH_STATE_TOL


@pytest.mark.parametrize("b,s,h,p,g,n,ck", SHAPES)
def test_rounded_plain_matches_rounded_oracle(b, s, h, p, g, n, ck):
    """The chunked plain version with the bf16 kernel's roundings against the
    step-by-step oracle with the same roundings, and the roundings are there."""
    _, (x, dt, A, B, C) = _inputs(b, s, h, p, g, n, seed=10, dtype="bfloat16")
    y, state = ops.ssd_scan_plain(x.float(), dt, A, B, C, chunk=ck, round_to=torch.bfloat16)
    y_ref, state_ref = ssd_ref(x.float(), dt, A, B.float(), C.float(),
                               round_to=torch.bfloat16, chunk=ck)
    assert _rel(y, y_ref) < ROUNDED_REL_TOL
    assert _rel(state, state_ref) < REL_TOL
    y_f32, state_f32 = ops.ssd_scan_plain(x.float(), dt, A, B, C, chunk=ck)
    assert _rel(y, y_f32) > ROUNDED_REL_TOL
    assert torch.equal(state, state_f32)     # the state path is not rounded


def test_rounded_oracle_needs_a_chunk():
    _, (x, dt, A, B, C) = _inputs(1, 16, 2, 16, 1, 8, seed=11)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ref(x, dt, A, B, C, round_to=torch.bfloat16)


def test_cpu_never_launches_the_kernel():
    _, targs = _inputs(1, 64, 2, 16, 1, 8, seed=6)
    before = ssd_scan_fwd.launches
    ops.ssd_scan(*targs, chunk=32)
    assert ssd_scan_fwd.launches == before == 0


def test_wrapper_refuses_cpu_tensors():
    """The kernel wrapper has no path to the plain version."""
    _, targs = _inputs(1, 64, 2, 16, 1, 8, seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_fwd(*targs, chunk=32)


@pytest.mark.parametrize("case", ["head_dim", "state", "chunk", "dtype", "mixed_dtype",
                                  "dt_dtype", "stride", "groups", "grad", "shape",
                                  "misaligned"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    _, (x, dt, A, B, C) = _inputs(1, 16, 4, 32, 2, 16, seed=8)
    chunk, err = 8, ValueError
    if case == "head_dim":
        x = x[..., :24]
    elif case == "state":
        B = C = torch.zeros((1, 16, 2, 130))
    elif case == "chunk":
        chunk = 256
    elif case == "dtype":
        x, B, C, err = x.half(), B.half(), C.half(), TypeError
    elif case == "mixed_dtype":
        B, err = B.bfloat16(), TypeError
    elif case == "dt_dtype":
        dt, err = dt.bfloat16(), TypeError
    elif case == "stride":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "groups":
        B = C = torch.zeros((1, 16, 3, 16))
    elif case == "grad":
        x, err = x.requires_grad_(True), RuntimeError
    elif case == "misaligned":    # bf16 B whose rows start 8 bytes off 16
        bc = torch.zeros((1, 16, 2, 24), dtype=torch.bfloat16)
        x, B, C = x.bfloat16(), bc[..., 4:20], C.bfloat16()
    else:
        dt = dt[:, :8]
    with pytest.raises(err):
        check_inputs(x, dt, A, B, C, chunk)
