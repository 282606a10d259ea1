"""The port's flash attention against the JAX package's kernel and oracles.

On the CPU, ``repro_torch.kernels.ops.flash_attention`` takes the plain
version; it is held against the Pallas kernel in interpret mode over the
shape grid of tests/test_kernels.py, against ``attention_ref`` on shapes the
Pallas kernel refuses, and against the model path's chunked attention. The
CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py, which imports no JAX.
Inputs come from a numpy seed and go to both frameworks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_fwd as jax_flash_fwd
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import attention as jax_attn
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import check_inputs, flash_attention_fwd
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import attention as port_attn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # max abs error, f32 / bf16 output


def _qkv(b, s, hq, hk, d, dtype, seed=0):
    """The same inputs for both frameworks: (jax q, k, v), (torch q, k, v)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hk, hk)]
    jx = tuple(jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    tx = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    return jx, tx


def _err(t, j):
    return float(np.abs(t.float().numpy() - np.asarray(j.astype(jnp.float32))).max())


@pytest.mark.parametrize("b,s,hq,hk,d,bq,bk", [
    (2, 256, 8, 2, 64, 64, 64),
    (1, 512, 4, 4, 128, 128, 256),
    (2, 128, 6, 2, 32, 128, 32),
    (1, 128, 2, 1, 256, 64, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_pallas_kernel(b, s, hq, hk, d, bq, bk, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(b, s, hq, hk, d, dtype)
    ref = jax_flash_fwd(jq, jk, jv, block_q=bq, block_kv=bk, interpret=True)
    out = ops.flash_attention(q, k, v)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softcap_matches_pallas_kernel(dtype):
    (jq, jk, jv), (q, k, v) = _qkv(1, 128, 4, 2, 64, dtype, seed=1)
    ref = jax_flash_fwd(jq, jk, jv, block_q=64, block_kv=64, softcap=20.0,
                        interpret=True)
    assert _err(ops.flash_attention(q, k, v, softcap=20.0), ref) <= TOL[dtype]


@pytest.mark.parametrize("b,s,hq,hk,d", [
    (2, 100, 4, 2, 64),    # ragged S: the Pallas kernel asserts S % block == 0
    (1, 37, 2, 1, 128),
    (1, 100, 2, 2, 256),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_and_wide_match_attention_ref(b, s, hq, hk, d, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(b, s, hq, hk, d, dtype, seed=2)
    assert _err(ops.flash_attention(q, k, v), jax_attention_ref(jq, jk, jv)) <= TOL[dtype]


def test_matches_model_chunked_attention():
    """f32: the kernel's algorithm and the model path's agree."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 192, 8, 2, 64, "float32", seed=3)
    ref = jax_attn.chunked_causal_attention(jq, jk, jv, block_q=32, block_kv=64)
    assert _err(ops.flash_attention(q, k, v), ref) <= TOL["float32"]


def test_port_chunked_attention_covers_the_diagonal_when_block_q_exceeds_block_kv():
    """The JAX chunked path walks kv blocks only up to its query block's first
    row, so with block_q > block_kv it drops keys (ROADMAP queue 3); the port
    walks up to the last row and matches the oracle."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 192, 8, 2, 64, "float32", seed=3)
    out = port_attn.chunked_causal_attention(q, k, v, block_q=64, block_kv=32)
    assert _err(out, jax_attention_ref(jq, jk, jv)) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_port_chunked_attention_matches_jax(dtype, softcap):
    (jq, jk, jv), (q, k, v) = _qkv(2, 96, 4, 2, 32, dtype, seed=4)
    ref = jax_attn.chunked_causal_attention(jq, jk, jv, block_q=16, block_kv=32,
                                            softcap=softcap)
    out = port_attn.chunked_causal_attention(q, k, v, block_q=16, block_kv=32,
                                             softcap=softcap)
    assert out.dtype == q.dtype
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("window", [0, 24])
def test_port_naive_attention_matches_jax(window):
    (jq, jk, jv), (q, k, v) = _qkv(1, 64, 4, 1, 32, "float32", seed=5)
    ref = jax_attn.naive_causal_attention(jq, jk, jv, window=window)
    out = port_attn.naive_causal_attention(q, k, v, window=window)
    assert _err(out, ref) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_decode_attention_matches_jax(dtype):
    b, smax, hq, hk, d, pos = 2, 40, 8, 2, 32, 29
    rng = np.random.default_rng(6)
    qn = rng.standard_normal((b, hq, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, smax, hk, d)).astype(np.float32) for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_attn.decode_attention(jnp.asarray(qn).astype(jd), jnp.asarray(kn).astype(jd),
                                    jnp.asarray(vn).astype(jd), jnp.int32(pos))
    out = port_attn.decode_attention(torch.from_numpy(qn).to(td), torch.from_numpy(kn).to(td),
                                     torch.from_numpy(vn).to(td), pos)
    assert _err(out, ref) <= TOL[dtype]


def test_plain_version_matches_jax_attention_ref_with_softcap():
    (jq, jk, jv), (q, k, v) = _qkv(1, 64, 4, 2, 32, "float32", seed=7)
    ref = jax_attention_ref(jq, jk, jv, softcap=5.0, window=16)
    assert _err(attention_ref(q, k, v, softcap=5.0, window=16), ref) <= TOL["float32"]


def test_cpu_never_launches_the_kernel():
    (_, _, _), (q, k, v) = _qkv(1, 64, 2, 2, 64, "bfloat16", seed=8)
    before = flash_attention_fwd.launches
    ops.flash_attention(q, k, v)
    assert flash_attention_fwd.launches == before == 0


def test_wrapper_refuses_cpu_tensors():
    """The kernel wrapper has no path to the plain version."""
    (_, _, _), (q, k, v) = _qkv(1, 64, 2, 2, 64, "float32", seed=9)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "mixed_dtype", "stride",
                                  "gqa", "grad", "shape", "misaligned"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    (_, _, _), (q, k, v) = _qkv(1, 16, 4, 2, 64, "float32", seed=10)
    err = ValueError
    if case == "head_dim":
        q, k, v = q[..., :48], k[..., :48], v[..., :48]
    elif case == "dtype":
        q, k, v, err = q.half(), k.half(), v.half(), TypeError
    elif case == "mixed_dtype":
        k, err = k.bfloat16(), TypeError
    elif case == "stride":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "gqa":
        q = q[:, :, :3]
    elif case == "grad":
        q, err = q.requires_grad_(True), RuntimeError
    elif case == "misaligned":   # bf16 views 3 elements into their buffers
        aligned = [t.bfloat16() for t in (q, k, v)]
        check_inputs(*aligned)   # the same values on 16 bytes pass
        q, k, v = (torch.zeros(t.numel() + 3, dtype=t.dtype)[3:].view(t.shape).copy_(t)
                   for t in aligned)
    else:
        k = k[:, :8]
        v = v[:, :8]
    with pytest.raises(err):
        check_inputs(q, k, v)
