"""The port's RG-LRU block against the JAX package's (CPU).

Weights come from the JAX init (``init_rglru_block``) and go across through
numpy; activations are made with numpy. The block is compared in prefill
(output and cache) and in decode (output and cache, step by step), in f32
and in bf16. The JAX sequence path runs ``associative_scan`` where the port
runs the step-by-step recurrence, so f32 results agree to rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_model_config as jax_get_model_config
from repro.models import rglru as jax_rglru
from repro_torch.config import get_model_config
from repro_torch.convert import to_tensor
from repro_torch.kernels.rglru_scan import rglru_scan_fwd
from repro_torch.models import rglru

ARCH = "recurrentgemma-2b"
TOL = 1e-5        # max abs error, f32 (block outputs and states are O(1))
# bf16 block: both sides round the same bf16 matmuls, GeLU and conv, but in
# other orders; outputs of up to about 4 differ by a few bf16 ulps (2^-8
# relative each), read relative to the largest reference value.
BF16_REL_TOL = 2e-2


def _cfg(mod, dtype):
    return dataclasses.replace(mod(ARCH, smoke=True), act_dtype=dtype, param_dtype=dtype)


def _pair(dtype):
    """(JAX cfg, JAX params, port block) with the same weights in ``dtype``."""
    jcfg = _cfg(jax_get_model_config, dtype)
    jp = jax_rglru.init_rglru_block(jax.random.PRNGKey(0), jcfg)
    block = rglru.RGLRU(_cfg(get_model_config, dtype))
    block.load_state_dict({k: to_tensor(np.asarray(v)) for k, v in jp.items()})
    return jcfg, jp, block.requires_grad_(False)


@pytest.fixture(scope="module")
def pair():
    return _pair("float32")


@pytest.fixture(scope="module")
def pair_bf16():
    return _pair("bfloat16")


def _x(b, s, d, seed=0, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _err(t, j):
    return float(np.abs(t.float().numpy() - np.asarray(j.astype(jnp.float32))).max())


def _rel(t, j):
    return _err(t, j) / float(np.abs(np.asarray(j.astype(jnp.float32))).max())


def _cache_err(tc, jc):
    return max(_err(tc[k], jc[k]) for k in ("conv", "h"))


@pytest.mark.parametrize("s", [40, 3, 16])
def test_prefill_matches_jax(pair, s):
    jcfg, jp, block = pair
    jx, x = _x(2, s, jcfg.d_model)
    jy, jc = jax_rglru.apply_rglru_block(jp, jx, jcfg, mode="prefill")
    before = rglru_scan_fwd.launches
    y, c = block(x, mode="prefill")
    assert rglru_scan_fwd.launches == before    # CPU: the plain version
    assert y.shape == (2, s, jcfg.d_model) and y.dtype == torch.float32
    assert c["h"].dtype == torch.float32 and c["conv"].shape == (2, 3, block.w_x.shape[1])
    assert _err(y, jy) <= TOL
    assert _cache_err(c, jc) <= TOL


def test_decode_steps_match_jax(pair):
    jcfg, jp, block = pair
    s0, t = 20, 4
    jx, x = _x(2, s0 + t, jcfg.d_model, seed=1)
    _, jc = jax_rglru.apply_rglru_block(jp, jx[:, :s0], jcfg, mode="prefill")
    _, c = block(x[:, :s0], mode="prefill")
    for i in range(t):
        jy, jc = jax_rglru.apply_rglru_block(jp, jx[:, s0 + i:s0 + i + 1], jcfg,
                                             mode="decode", cache=jc)
        y, c = block(x[:, s0 + i:s0 + i + 1], mode="decode", cache=c)
        assert _err(y, jy) <= TOL, i
        assert _cache_err(c, jc) <= TOL, i


def test_bf16_prefill_and_decode_match_jax(pair_bf16):
    jcfg, jp, block = pair_bf16
    s0, t = 40, 3
    jx, x = _x(2, s0 + t, jcfg.d_model, seed=2, dtype="bfloat16")
    jy, jc = jax_rglru.apply_rglru_block(jp, jx[:, :s0], jcfg, mode="prefill")
    y, c = block(x[:, :s0], mode="prefill")
    assert y.dtype == torch.bfloat16 and c["conv"].dtype == torch.bfloat16
    assert c["h"].dtype == torch.float32 and block.lam.dtype == torch.float32
    assert _rel(y, jy) <= BF16_REL_TOL
    assert _rel(c["h"], jc["h"]) <= BF16_REL_TOL
    for i in range(t):
        xi = slice(s0 + i, s0 + i + 1)
        jy, jc = jax_rglru.apply_rglru_block(jp, jx[:, xi], jcfg, mode="decode", cache=jc)
        y, c = block(x[:, xi], mode="decode", cache=c)
        assert _rel(y, jy) <= BF16_REL_TOL, i
        assert _rel(c["h"], jc["h"]) <= BF16_REL_TOL, i


def test_scan_with_initial_state_matches_jax(pair):
    """``rglru_scan`` folds h0 into the first step; two halves, the second from
    the first's last state, equal the whole."""
    jcfg, jp, block = pair
    w = block.w_x.shape[1]
    jx, x = _x(2, 30, w, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, w)).astype(np.float32)
    jh, jlast = jax_rglru.rglru_scan(jp, jx, jnp.asarray(h0))
    h, last = rglru.rglru_scan(block, x, torch.from_numpy(h0))
    assert _err(h, jh) <= TOL and _err(last, jlast) <= TOL
    h1, last1 = rglru.rglru_scan(block, x[:, :12])
    h2, last2 = rglru.rglru_scan(block, x[:, 12:], last1)
    h_all, last_all = rglru.rglru_scan(block, x)
    torch.testing.assert_close(torch.cat([h1, h2], dim=1), h_all, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(last2, last_all, atol=1e-6, rtol=1e-6)


def test_decode_matches_longer_prefill(pair):
    """Teacher-forced: prefill of s0, then decode steps, against prefill of all."""
    jcfg, _, block = pair
    s0, t = 17, 5
    _, x = _x(2, s0 + t, jcfg.d_model, seed=5)
    _, c = block(x[:, :s0], mode="prefill")
    ys = []
    for i in range(t):
        y, c = block(x[:, s0 + i:s0 + i + 1], mode="decode", cache=c)
        ys.append(y)
    y_full, c_full = block(x, mode="prefill")
    torch.testing.assert_close(torch.cat(ys, dim=1), y_full[:, s0:], atol=1e-5, rtol=1e-5)
    for k in ("conv", "h"):
        torch.testing.assert_close(c[k], c_full[k], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s0", [1, 2])
def test_short_prompt_decodes(pair, s0):
    """A prompt shorter than the conv's K-1 = 3 steps: the JAX prefill cache
    keeps a window of s0 < 3 rows and its first decode step raises (ROADMAP
    queue 3); the port left-pads the window with zeros, and its prefill then
    decode agrees with its prefill of the longer prompt."""
    jcfg, jp, block = pair
    jx, x = _x(2, s0 + 2, jcfg.d_model, seed=6)
    _, jc = jax_rglru.apply_rglru_block(jp, jx[:, :s0], jcfg, mode="prefill")
    with pytest.raises((ValueError, TypeError)):
        jax_rglru.apply_rglru_block(jp, jx[:, s0:s0 + 1], jcfg, mode="decode", cache=jc)
    _, c = block(x[:, :s0], mode="prefill")
    assert c["conv"].shape == (2, jcfg.rglru_conv - 1, block.w_x.shape[1])
    assert float(c["conv"][:, :3 - s0].abs().max()) == 0.0
    for i in range(2):
        y, c = block(x[:, s0 + i:s0 + i + 1], mode="decode", cache=c)
    y_full, c_full = block(x, mode="prefill")
    torch.testing.assert_close(y[:, 0], y_full[:, -1], atol=1e-5, rtol=1e-5)
    for k in ("conv", "h"):
        torch.testing.assert_close(c[k], c_full[k], atol=1e-5, rtol=1e-5)


def test_decode_updates_the_cache_in_place(pair):
    jcfg, _, block = pair
    _, x = _x(1, 9, jcfg.d_model, seed=7)
    _, c = block(x[:, :8], mode="prefill")
    ptrs = {k: t.data_ptr() for k, t in c.items()}
    _, c2 = block(x[:, 8:], mode="decode", cache=c)
    assert c2 is c and {k: t.data_ptr() for k, t in c2.items()} == ptrs


def test_causal_conv_gates_and_step_match_jax(pair):
    jcfg, jp, block = pair
    rng = np.random.default_rng(8)
    w = block.w_x.shape[1]
    xr = rng.standard_normal((2, 13, w)).astype(np.float32)
    cw = rng.standard_normal((4, w)).astype(np.float32) * 0.1
    cb = rng.standard_normal(w).astype(np.float32)
    out = rglru._causal_conv(*map(torch.from_numpy, (xr, cw, cb)))
    assert _err(out, jax_rglru._causal_conv(*map(jnp.asarray, (xr, cw, cb)))) <= 1e-6
    x_t = rng.standard_normal((3, w)).astype(np.float32)
    h = rng.standard_normal((3, w)).astype(np.float32)
    log_a, b = rglru._gates(block, torch.from_numpy(x_t))
    jlog_a, jb = jax_rglru._gates(jp, jnp.asarray(x_t))
    assert _err(log_a, jlog_a) <= 1e-6 and _err(b, jb) <= 1e-6
    st = rglru.rglru_step(block, torch.from_numpy(x_t), torch.from_numpy(h))
    assert _err(st, jax_rglru.rglru_step(jp, jnp.asarray(x_t), jnp.asarray(h))) <= 1e-6


def test_parameters_match_the_jax_init():
    """Names, shapes and dtypes are JAX's; ``lam`` and the zero biases are its
    values; the random leaves are drawn from its distributions."""
    for smoke in (True, False):
        jcfg = jax_get_model_config(ARCH, smoke=smoke)
        jp = jax.eval_shape(lambda: jax_rglru.init_rglru_block(jax.random.PRNGKey(0), jcfg))
        block = rglru.RGLRU(get_model_config(ARCH, smoke=smoke), device="meta")
        mine = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in block.state_dict().items()}
        assert mine == {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}
    cfg = get_model_config(ARCH)                 # width 2560, bf16 params
    jp = jax_rglru.init_rglru_block(jax.random.PRNGKey(1), jax_get_model_config(ARCH))
    block = rglru.RGLRU(cfg)
    block.reset_parameters(torch.Generator().manual_seed(0))
    lam, jlam = block.lam.detach().numpy(), np.asarray(jp["lam"])
    # The port rounds once from f64; JAX evaluates in f32, where log(a) near
    # a = 0.999 loses digits: an ulp of a moves lam by about 2^-24 / |log a|.
    a = np.linspace(0.9, 0.999, lam.size)
    bound = 4 * 2.0 ** -24 / np.abs(np.log(a)) + 4 * np.spacing(np.abs(jlam))
    assert (np.abs(lam - jlam) <= bound).all()
    for name in ("conv_b", "b_a", "b_i"):
        assert float(getattr(block, name).detach().float().abs().max()) == 0.0
    assert abs(float(block.w_a.detach().float().std()) - 2560 ** -0.5) < 1e-3
    assert abs(float(block.conv_w.detach().float().std()) - 0.1) < 5e-3


def test_init_rglru_cache_matches_jax():
    for smoke in (True, False):
        cfg = get_model_config(ARCH, smoke=smoke)
        mine = rglru.init_rglru_cache(cfg, 3, torch.bfloat16, device="meta")
        ref = jax.eval_shape(lambda: jax_rglru.init_rglru_cache(
            jax_get_model_config(ARCH, smoke=smoke), 3))
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in mine.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}
