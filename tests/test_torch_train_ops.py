"""The port's autograd Functions against the gradients of their JAX counterparts (CPU, f32).

On the CPU each Function's forward takes the plain version, and its backward
is the code the card runs: a recompute through the model path's attention
or ``ssd_chunked``, or the reverse RG-LRU recurrence. Each is held against
``jax.vjp`` of what the JAX package differentiates, on the same numpy
inputs and cotangents: the flash op's ``custom_vjp`` (Pallas in interpret
mode; its backward recomputes ``chunked_causal_attention``), the banded
``local_attention``, ``ssd_chunked``, the RG-LRU scan's ``associative_scan``
and the kernel oracle's recurrence. Also the D=8 padding of the flash
wrapper, against ``attention_ref``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_model_config as jax_get_model_config
from repro.kernels import ops as jax_ops
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.kernels.ref import rglru_ref as jax_rglru_ref
from repro.models import attention as jax_attn
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro_torch.config import get_model_config
from repro_torch.convert import to_tensor
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import pad_head_dim
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import rglru

# f32 gradients, max abs error / max |JAX gradient|: both sides compute the
# same function in f32 with sums in other orders (attention: materialised
# scores forward, blockwise backward; RG-LRU: a step-by-step recurrence
# against an associative scan), so they agree to a few ulps of the largest
# value, amplified at most by the length of the sums.
GRAD_REL_TOL = 1e-5
# The SSD scan's grads (dA and dt sum exp-weighted products over whole
# chunks and every state entry) are held as tests/test_kernels.py holds the
# SSD kernel's outputs.
SSD_GRAD_REL_TOL = 1e-4
OUT_TOL = 1e-5    # max abs error of the forward outputs (O(1) values)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's many small ops: the suite runs
    several workers on shared cores, where eight threads each would stall."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _torch_grads(fn, arrays, cotangents):
    """(outputs, grads) of fn on torch copies of ``arrays``."""
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, ts, [torch.from_numpy(c) for c in cotangents])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _jax_grads(fn, arrays, cotangents):
    outs, vjp = jax.vjp(jax.jit(fn), *[jnp.asarray(a) for a in arrays])
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = vjp(tuple(jnp.asarray(c) for c in cotangents) if len(cotangents) > 1
                else jnp.asarray(cotangents[0]))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _check(t_out, t_grads, j_out, j_grads, tol=GRAD_REL_TOL):
    for a, b in zip(t_out, j_out):
        assert np.abs(a - b).max() <= OUT_TOL
    for g, ref in zip(t_grads, j_grads):
        assert g.shape == ref.shape
        err = np.abs(g - ref).max() / (np.abs(ref).max() or 1.0)   # all-zero (S=1's da)
        assert err <= tol, err


@pytest.mark.parametrize("b,s,hq,hk,d,block", [(2, 128, 4, 2, 32, 64), (1, 64, 2, 2, 16, 64)])
def test_flash_attention_grads_match_jax_custom_vjp(b, s, hq, hk, d, block):
    """S a multiple of the Pallas kernel's block (interpret mode)."""
    arrays = _rng_arrays(0, (b, s, hq, d), (b, s, hk, d), (b, s, hk, d))
    (cot,) = _rng_arrays(1, (b, s, hq, d))
    t = _torch_grads(lambda q, k, v: ops.flash_attention(q, k, v), arrays, [cot])
    j = _jax_grads(lambda q, k, v: jax_ops.flash_attention(q, k, v, block, block),
                   arrays, [cot])
    _check(*t, *j)


@pytest.mark.parametrize("s,window,softcap", [(40, 16, 0.0), (48, 16, 0.0), (50, 16, 30.0),
                                              (12, 16, 0.0)])
def test_windowed_flash_attention_grads_match_jax_local_attention(s, window, softcap):
    """S > W with S a multiple of W or not (the banded path and its tail
    padding), and S <= W (causal)."""
    b, hq, hk, d = 2, 4, 2, 32
    arrays = _rng_arrays(2, (b, s, hq, d), (b, s, hk, d), (b, s, hk, d))
    (cot,) = _rng_arrays(3, (b, s, hq, d))
    t = _torch_grads(lambda q, k, v: ops.flash_attention(q, k, v, window=window,
                                                          softcap=softcap), arrays, [cot])
    j = _jax_grads(lambda q, k, v: jax_attn.local_attention(q, k, v, window=window,
                                                             softcap=softcap), arrays, [cot])
    _check(*t, *j)


def _ssd_arrays(b, s, h, p, g, n, seed):
    x, dt_raw, a_raw, B, C = _rng_arrays(seed, (b, s, h, p), (b, s, h), (h,), (b, s, g, n),
                                         (b, s, g, n))
    dt = np.log1p(np.exp(dt_raw)).astype(np.float32)          # softplus: dt > 0
    A = (-np.exp(a_raw * 0.5)).astype(np.float32)             # A < 0
    return [x, dt, A, (B * 0.3).astype(np.float32), (C * 0.3).astype(np.float32)]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(2, 50, 4, 32, 1, 16, 32),
                                               (1, 64, 4, 16, 2, 8, 16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_grads_match_jax_ssd_chunked(b, s, h, p, g, n, chunk, with_state):
    """Grads of x, dt, A, B, C through y alone (the train path: the final
    state's grad is None) and through y and the final state."""
    arrays = _ssd_arrays(b, s, h, p, g, n, seed=4)
    cots = _rng_arrays(5, (b, s, h, p), (b, h, n, p))
    if with_state:
        t = _torch_grads(lambda *a: ops.ssd_scan(*a, chunk=chunk), arrays, cots)
        j = _jax_grads(lambda *a: jax_ssm.ssd_chunked(*a, chunk=chunk), arrays, cots)
    else:
        t = _torch_grads(lambda *a: ops.ssd_scan(*a, chunk=chunk)[0], arrays, cots[:1])
        j = _jax_grads(lambda *a: jax_ssm.ssd_chunked(*a, chunk=chunk)[0], arrays, cots[:1])
    _check(*t, *j, tol=SSD_GRAD_REL_TOL)


@pytest.mark.parametrize("s", [1, 2, 257])
def test_rglru_reverse_recurrence_matches_jax(s):
    """The backward's reverse recurrence (the forward op on the flipped
    sequence, a shifted by one step) against jax.vjp of the recurrence."""
    (a_raw, b_in, cot) = _rng_arrays(6, (2, s, 24), (2, s, 24), (2, s, 24))
    a = (1.0 / (1.0 + np.exp(-a_raw)) * 0.2 + 0.79).astype(np.float32)
    t = _torch_grads(ops.rglru_recurrence, [a, b_in], [cot])
    j = _jax_grads(jax_rglru_ref, [a, b_in], [cot])
    _check(*t, *j)


def test_rglru_scan_grads_match_jax_associative_scan():
    """The RG-LRU sequence path (gates, then the recurrence) of the smoke
    config: grads of its input and of every gate parameter against the JAX
    package's ``rglru_scan`` (``associative_scan``)."""
    cfg = dataclasses.replace(get_model_config("recurrentgemma-2b", smoke=True),
                              act_dtype="float32", param_dtype="float32")
    jcfg = dataclasses.replace(jax_get_model_config("recurrentgemma-2b", smoke=True),
                               act_dtype="float32", param_dtype="float32")
    jp = jax_rglru.init_rglru_block(jax.random.PRNGKey(1), jcfg)
    block = rglru.RGLRU(cfg)
    block.load_state_dict({k: to_tensor(np.asarray(v)) for k, v in jp.items()})
    names = ["w_a", "b_a", "w_i", "b_i", "lam"]
    x, cot = _rng_arrays(7, (2, 37, cfg.rglru_width), (2, 37, cfg.rglru_width))

    xt = torch.from_numpy(x).requires_grad_(True)
    h, _ = rglru.rglru_scan(block, xt)
    leaves = [xt] + [getattr(block, n) for n in names]
    t_grads = torch.autograd.grad(h, leaves, torch.from_numpy(cot))

    def jfn(x_, *ps):
        return jax_rglru.rglru_scan({**jp, **dict(zip(names, ps))}, x_)[0]
    j = _jax_grads(jfn, [x] + [np.asarray(jp[n]) for n in names], [cot])
    _check([h.detach().numpy()], [g.numpy() for g in t_grads], *j)


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (20.0, 0), (0.0, 5)])
def test_head_dim_8_padding_is_attention_at_d8(softcap, window):
    """D=8 runs the D=16 instantiation on zero-padded copies with the scale
    8^-0.5: the padding arithmetic, with the plain version in the kernel's
    place, equals attention at D=8 (the port's and the JAX package's oracle)."""
    q, k, v = (torch.from_numpy(a) for a in _rng_arrays(8, (2, 33, 4, 8), (2, 33, 2, 8),
                                                         (2, 33, 2, 8)))
    padded = pad_head_dim(attention_ref, q, k, v, softcap=softcap, window=window)
    assert padded.shape == q.shape
    ref = attention_ref(q, k, v, softcap=softcap, window=window)
    assert float((padded - ref).abs().max()) <= OUT_TOL
    jref = jax_attention_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)), softcap=softcap)
    if not window:
        assert np.abs(padded.numpy() - np.asarray(jref)).max() <= OUT_TOL
    # the same call with 16^-0.5, the padded width's scale, is another function
    wrong = attention_ref(*(torch.nn.functional.pad(t, (0, 8)) for t in (q, k, v)),
                          softcap=softcap, window=window)[..., :8]
    assert float((wrong - ref).abs().max()) > 1e-3
