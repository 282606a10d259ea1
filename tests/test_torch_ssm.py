"""The port's Mamba2 SSD block against the JAX package's (CPU, f32).

Weights come from the JAX init (``init_ssd_block``) and go across through
numpy; activations are made with numpy. The block is compared in prefill
(output and cache) and in decode (output and cache, step by step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_model_config as jax_get_model_config
from repro.models import ssm as jax_ssm
from repro_torch.config import get_model_config
from repro_torch.convert import to_tensor
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.models import ssm

ARCH = "mamba2-370m"
TOL = 1e-4   # max abs error, f32


def _f32(cfg):
    return dataclasses.replace(cfg, act_dtype="float32", param_dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX params, port block) with the same f32 weights."""
    jcfg = _f32(jax_get_model_config(ARCH, smoke=True))
    jp = jax_ssm.init_ssd_block(jax.random.PRNGKey(0), jcfg)
    block = ssm.SSD(_f32(get_model_config(ARCH, smoke=True)))
    block.load_state_dict({k: to_tensor(np.asarray(v)) for k, v in jp.items()})
    return jcfg, jp, block.requires_grad_(False)


def _x(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _err(t, j):
    return float(np.abs(t.float().numpy() - np.asarray(j, dtype=np.float32)).max())


def _cache_err(tc, jc):
    return max(_err(tc[k], jc[k]) for k in ("conv_x", "conv_bc", "ssm"))


@pytest.mark.parametrize("s", [70, 3, 32])
def test_prefill_matches_jax(pair, s):
    """Two chunks of 32 and a ragged tail; one short chunk; one whole chunk."""
    jcfg, jp, block = pair
    x = _x(2, s, jcfg.d_model)
    jy, jc = jax_ssm.apply_ssd_block(jp, jnp.asarray(x), jcfg, mode="prefill")
    before = ssd_scan_fwd.launches
    y, c = block(torch.from_numpy(x), mode="prefill")
    assert ssd_scan_fwd.launches == before    # CPU: the plain version
    assert y.shape == (2, s, jcfg.d_model)
    assert _err(y, jy) <= TOL
    assert _cache_err(c, jc) <= TOL


def test_decode_steps_match_jax(pair):
    jcfg, jp, block = pair
    s0, t = 40, 4
    x = _x(2, s0 + t, jcfg.d_model, seed=1)
    _, jc = jax_ssm.apply_ssd_block(jp, jnp.asarray(x[:, :s0]), jcfg, mode="prefill")
    _, c = block(torch.from_numpy(x[:, :s0]), mode="prefill")
    for i in range(t):
        xi = x[:, s0 + i:s0 + i + 1]
        jy, jc = jax_ssm.apply_ssd_block(jp, jnp.asarray(xi), jcfg, mode="decode", cache=jc)
        y, c = block(torch.from_numpy(xi), mode="decode", cache=c)
        assert _err(y, jy) <= TOL, i
        assert _cache_err(c, jc) <= TOL, i


@pytest.mark.parametrize("s0", [1, 2])
def test_short_prompt_decodes(pair, s0):
    """A prompt shorter than the conv's K-1 = 3 steps: the JAX prefill cache
    keeps a window of s0 < 3 rows and its first decode step raises (ROADMAP
    queue 3); the port left-pads the window with zeros, and its prefill then
    decode agrees with its prefill of the longer prompt."""
    jcfg, jp, block = pair
    x = _x(2, s0 + 2, jcfg.d_model, seed=2)
    _, jc = jax_ssm.apply_ssd_block(jp, jnp.asarray(x[:, :s0]), jcfg, mode="prefill")
    with pytest.raises((ValueError, TypeError)):
        jax_ssm.apply_ssd_block(jp, jnp.asarray(x[:, s0:s0 + 1]), jcfg, mode="decode",
                                cache=jc)
    _, c = block(torch.from_numpy(x[:, :s0]), mode="prefill")
    assert c["conv_x"].shape == (2, jcfg.ssm_conv - 1, block.w_x.shape[1])
    assert float(c["conv_x"][:, :3 - s0].abs().max()) == 0.0
    for i in range(2):
        y, c = block(torch.from_numpy(x[:, s0 + i:s0 + i + 1]), mode="decode", cache=c)
    y_full, c_full = block(torch.from_numpy(x), mode="prefill")
    torch.testing.assert_close(y[:, 0], y_full[:, -1], atol=1e-5, rtol=1e-5)
    for k in ("conv_x", "conv_bc", "ssm"):
        torch.testing.assert_close(c[k], c_full[k], atol=1e-5, rtol=1e-5)


def test_decode_updates_the_cache_in_place(pair):
    jcfg, _, block = pair
    x = _x(1, 9, jcfg.d_model, seed=3)
    _, c = block(torch.from_numpy(x[:, :8]), mode="prefill")
    ptrs = {k: t.data_ptr() for k, t in c.items()}
    _, c2 = block(torch.from_numpy(x[:, 8:]), mode="decode", cache=c)
    assert c2 is c and {k: t.data_ptr() for k, t in c2.items()} == ptrs


def test_causal_conv_and_decode_step_match_jax():
    rng = np.random.default_rng(4)
    xbc = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32) * 0.1
    bias = rng.standard_normal(24).astype(np.float32)
    out = ssm._causal_conv(*map(torch.from_numpy, (xbc, w, bias)))
    assert _err(out, jax_ssm._causal_conv(*map(jnp.asarray, (xbc, w, bias)))) <= 1e-6
    b, h, n, p, g = 2, 4, 8, 16, 2
    args = [rng.standard_normal((b, h, n, p)), rng.standard_normal((b, h, p)),
            np.log1p(np.exp(rng.standard_normal((b, h)))), -np.exp(rng.standard_normal(h)),
            rng.standard_normal((b, g, n)), rng.standard_normal((b, g, n))]
    args = [a.astype(np.float32) for a in args]
    st, y = ssm.ssd_decode_step(*map(torch.from_numpy, args))
    jst, jy = jax_ssm.ssd_decode_step(*map(jnp.asarray, args))
    assert _err(st, jst) <= 1e-5 and _err(y, jy) <= 1e-5


def test_parameters_match_the_jax_init():
    """Names, shapes and dtypes are JAX's; A_log and D are its values; the
    random leaves are drawn from its distributions (not its numbers)."""
    for smoke in (True, False):
        jcfg = jax_get_model_config(ARCH, smoke=smoke)
        jp = jax.eval_shape(lambda: jax_ssm.init_ssd_block(jax.random.PRNGKey(0), jcfg))
        block = ssm.SSD(get_model_config(ARCH, smoke=smoke), device="meta")
        mine = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in block.state_dict().items()}
        assert mine == {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}
    jcfg = jax_get_model_config(ARCH)          # 32 heads, bf16 params
    jp = jax_ssm.init_ssd_block(jax.random.PRNGKey(1), jcfg)
    cfg = get_model_config(ARCH)
    block = ssm.SSD(dataclasses.replace(cfg, num_layers=1))
    block.reset_parameters(torch.Generator().manual_seed(0))
    a_log = block.A_log.detach().numpy()
    ulp = np.spacing(np.abs(np.asarray(jp["A_log"])))
    assert (np.abs(a_log - np.asarray(jp["A_log"])) <= ulp).all()
    np.testing.assert_array_equal(block.D.detach().numpy(), np.asarray(jp["D"]))
    dt0 = torch.nn.functional.softplus(block.dt_bias.detach())
    assert float(dt0.min()) >= 1e-3 * (1 - 1e-5) and float(dt0.max()) <= 1e-1 * (1 + 1e-5)
    assert abs(float(block.w_x.detach().float().std()) - cfg.d_model ** -0.5) < 2e-3
    assert abs(float(block.conv_x_w.detach().float().std()) - 0.1) < 5e-3
    assert float(block.conv_x_b.detach().abs().max()) == 0.0
    assert float((block.norm_scale.detach() - 1).abs().max()) == 0.0
    small = ssm.SSD(get_model_config(ARCH, smoke=True))
    small.reset_parameters(torch.Generator().manual_seed(0))
    jsmall = jax_ssm.init_ssd_block(jax.random.PRNGKey(0), jax_get_model_config(ARCH, smoke=True))
    np.testing.assert_array_equal(small.A_log.detach().numpy(), np.asarray(jsmall["A_log"]))


def test_init_ssd_cache_matches_jax():
    for smoke in (True, False):
        cfg = get_model_config(ARCH, smoke=smoke)
        mine = ssm.init_ssd_cache(cfg, 3, torch.bfloat16, device="meta")
        ref = jax.eval_shape(lambda: jax_ssm.init_ssd_cache(
            jax_get_model_config(ARCH, smoke=smoke), 3))
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in mine.items()} \
            == {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()}
