"""The port's local (sliding-window) attention against the JAX package's (CPU).

``models.attention.local_attention`` sends every S through
``ops.flash_attention(window=)`` (the plain ``attention_ref(window=)`` on the
CPU, the CUDA kernel on the card); it is held against the JAX banded
``local_attention`` below, at and above the window, ragged or not, at the
smoke widths and at head_dim 256 with GQA 10:1. The local layer's ring cache
(prefill) and ring decode are held against the JAX ``apply_attn`` and
``decode_local_attention``, across the ring's wrap. Inputs come from a numpy
seed and go to both frameworks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_model_config as jax_get_model_config
from repro.config.base import LOCAL_ATTN
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import attention as jax_attn
from repro.models import transformer as jax_transformer
from repro_torch.config import get_model_config
from repro_torch.convert import to_tensor
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.models import attention as port_attn
from repro_torch.models import transformer

TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # max abs error, f32 / bf16 output
ARCH = "recurrentgemma-2b"


def _qkv(b, s, hq, hk, d, dtype, seed=0):
    """The same inputs for both frameworks: (jax q, k, v), (torch q, k, v)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hk, hk)]
    jx = tuple(jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    tx = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    return jx, tx


def _err(t, j):
    return float(np.abs(t.float().numpy() - np.asarray(j.astype(jnp.float32))).max())


# (b, s, hq, hk, d, window): the smoke widths (window 16, D 32, 2:1) and
# recurrentgemma's heads (10:1 at D 256) with a small window
@pytest.mark.parametrize("b,s,hq,hk,d,w", [
    (2, 10, 2, 1, 32, 16),       # S < W: JAX takes its causal fallback
    (2, 16, 2, 1, 32, 16),       # S = W
    (2, 48, 2, 1, 32, 16),       # S > W, three whole windows
    (2, 40, 2, 1, 32, 16),       # S > W, ragged: JAX pads to 48
    (1, 20, 10, 1, 256, 32),
    (1, 75, 10, 1, 256, 32),     # ragged, D=256, GQA 10:1
    (1, 64, 10, 1, 256, 24),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_attention_matches_jax(b, s, hq, hk, d, w, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(b, s, hq, hk, d, dtype)
    ref = jax_attn.local_attention(jq, jk, jv, window=w)
    before = flash_attention_fwd.launches
    out = port_attn.local_attention(q, k, v, window=w)
    assert flash_attention_fwd.launches == before     # CPU: the plain version
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _err(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("window", [1, 7, 64, 100])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_windowed_flash_op_matches_jax_attention_ref(window, softcap):
    """ops.flash_attention(window=) on the CPU: W=1 (itself only), W not a
    multiple of the kernel's 64-row tile, W = a tile, W >= S (causal)."""
    (jq, jk, jv), (q, k, v) = _qkv(2, 90, 4, 2, 64, "float32", seed=1)
    out = ops.flash_attention(q, k, v, softcap=softcap, window=window)
    ref = jax_attention_ref(jq, jk, jv, softcap=softcap, window=window)
    assert _err(out, ref) <= TOL["float32"]
    if window >= 90:
        torch.testing.assert_close(out, ops.flash_attention(q, k, v, softcap=softcap),
                                   atol=0, rtol=0)


@pytest.fixture(scope="module")
def local_layer():
    """(JAX cfg, JAX attention params, port local Attention), f32 smoke widths."""
    jcfg = dataclasses.replace(jax_get_model_config(ARCH, smoke=True),
                               act_dtype="float32", param_dtype="float32")
    jp = jax_transformer.init_attn(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(get_model_config(ARCH, smoke=True),
                              act_dtype="float32", param_dtype="float32")
    layer = transformer.Attention(cfg, LOCAL_ATTN)
    layer.load_state_dict({k: to_tensor(np.asarray(v)) for k, v in jp.items()})
    return jcfg, jp, layer.requires_grad_(False)


def _x(b, s, d, seed):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("s", [5, 16, 40, 48])
def test_prefill_ring_cache_matches_jax(local_layer, s):
    """The ring after prefill: the last W keys, position p in slot p % W
    (rolled by s % W), zero-padded when s < W; and the layer's output."""
    jcfg, jp, layer = local_layer
    jx, x = _x(2, s, jcfg.d_model, seed=2)
    jo, jc = jax_transformer.apply_attn(jp, jx, jcfg, LOCAL_ATTN, mode="prefill",
                                        cache=None, pos=None, max_len=s + 4)
    o, c = layer(x, mode="prefill", cache=None, pos=None, max_len=s + 4)
    assert c["k"].shape == (2, jcfg.local_window, jcfg.num_kv_heads, jcfg.resolved_head_dim)
    assert _err(o, jo) <= 1e-5
    for key in ("k", "v"):
        assert _err(c[key], jc[key]) <= 1e-6


@pytest.mark.parametrize("s0", [9, 40])
def test_decode_through_the_ring_matches_jax(local_layer, s0):
    """Decode steps that fill (s0 = 9) and wrap (s0 = 40) the ring of 16."""
    jcfg, jp, layer = local_layer
    t = 12
    jx, x = _x(2, s0 + t, jcfg.d_model, seed=3)
    _, jc = jax_transformer.apply_attn(jp, jx[:, :s0], jcfg, LOCAL_ATTN, mode="prefill",
                                       cache=None, pos=None, max_len=s0 + t)
    _, c = layer(x[:, :s0], mode="prefill", cache=None, pos=None, max_len=s0 + t)
    for i in range(t):
        pos = s0 + i
        jo, jc = jax_transformer.apply_attn(jp, jx[:, pos:pos + 1], jcfg, LOCAL_ATTN,
                                            mode="decode", cache=jc, pos=jnp.int32(pos))
        o, c = layer(x[:, pos:pos + 1], mode="decode", cache=c, pos=pos)
        assert _err(o, jo) <= 1e-5, pos
        assert _err(c["k"], jc["k"]) <= 1e-6, pos
    # and against the port's own prefill of the whole sequence, last position
    o_full, _ = layer(x, mode="prefill", cache=None, pos=None, max_len=s0 + t)
    torch.testing.assert_close(o[:, 0], o_full[:, -1], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_local_attention_matches_jax(dtype):
    b, w, hq, hk, d = 2, 16, 10, 1, 256
    rng = np.random.default_rng(4)
    qn = rng.standard_normal((b, hq, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((b, w, hk, d)).astype(np.float32) for _ in range(2))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    for pos in (3, 15, 16, 37):
        ref = jax_attn.decode_local_attention(jnp.asarray(qn).astype(jd),
                                              jnp.asarray(kn).astype(jd),
                                              jnp.asarray(vn).astype(jd), jnp.int32(pos))
        out = port_attn.decode_local_attention(torch.from_numpy(qn).to(td),
                                               torch.from_numpy(kn).to(td),
                                               torch.from_numpy(vn).to(td), pos)
        assert _err(out, ref) <= TOL[dtype], pos


def test_local_cache_is_the_window_whatever_max_len():
    cfg = get_model_config(ARCH, smoke=True)
    c = transformer.init_attn_cache(cfg, 2, 100, torch.float32, "meta", LOCAL_ATTN)
    assert c["k"].shape == (2, cfg.local_window, cfg.num_kv_heads, cfg.resolved_head_dim)
    jc = jax.eval_shape(lambda: jax_transformer.init_attn_cache(
        jax_get_model_config(ARCH, smoke=True), LOCAL_ATTN, 2, 100))
    assert tuple(c["v"].shape) == tuple(jc["v"].shape)
