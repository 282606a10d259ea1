"""The port's layers against ``repro.models.layers`` in f32 (CPU).

Parameters and inputs are made with numpy and given to both frameworks.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_model_config as jax_get_model_config
from repro.models import layers as jl
from repro_torch.config import get_model_config
from repro_torch.models import layers as tl

TOL = 1e-5   # f32 max abs error


def _cfgs(**kw):
    kw = dict(act_dtype="float32", param_dtype="float32", **kw)
    return (dataclasses.replace(jax_get_model_config("qwen1.5-0.5b", smoke=True), **kw),
            dataclasses.replace(get_model_config("qwen1.5-0.5b", smoke=True), **kw))


def _load(module, params):
    """Copies numpy params into a port module's parameters of the same names."""
    with torch.no_grad():
        for name, arr in params.items():
            getattr(module, name).copy_(torch.from_numpy(arr))
    return module


def _close(t, j, tol=TOL):
    err = float(np.abs(t.detach().numpy() - np.asarray(j)).max())
    assert err <= tol, err


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm(norm):
    jcfg, cfg = _cfgs(norm=norm)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    out = _load(tl.Norm(cfg), p)(torch.from_numpy(x))
    _close(out, jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), norm, cfg.norm_eps))


def _rope_tol(x, pos):
    """The two frequency tables may differ by an ulp (the port rounds an f64
    table once, JAX rounds an f32 pow), and position p turns that into p ulps
    of angle: |x| * p * 2^-23 on top of the f32 rounding of the rotation."""
    return TOL + float(np.abs(x).max()) * int(pos.max()) * 2.0 ** -23


@pytest.mark.parametrize("head_dim", [16, 64, 128, 256])
@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_freqs_within_two_ulps_of_jax(head_dim, theta):
    mine = tl.rope_freqs(head_dim, theta).numpy()
    ref = np.asarray(jl.rope_freqs(head_dim, theta))
    assert mine.dtype == np.float32
    assert np.abs(mine.view(np.int32) - ref.view(np.int32)).max() <= 2


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32) + 7, (2, 40)).copy()
    out = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(out, jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           tol=_rope_tol(x, pos))


def test_rope_decode_position():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, 4, 32)).astype(np.float32)
    pos = np.full((3, 1), 517, np.int32)
    out = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    _close(out, jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
           tol=_rope_tol(x, pos))


@pytest.mark.parametrize("kind", ["swiglu", "relu2", "gelu"])
def test_mlp(kind):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(3)
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5,
         "w_down": rng.standard_normal((f, d)).astype(np.float32) * f ** -0.5}
    if kind == "swiglu":
        p["w_gate"] = rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    out = _load(tl.MLP(cfg, kind), p)(torch.from_numpy(x))
    _close(out, jl.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), kind))


@pytest.mark.parametrize("tied,softcap", [(True, 0.0), (False, 0.0), (True, 30.0)])
def test_embed_and_unembed(tied, softcap):
    jcfg, cfg = _cfgs(tie_embeddings=tied, logit_softcap=softcap)
    rng = np.random.default_rng(4)
    p = {"tok": rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(np.float32)}
    if not tied:
        p["unembed"] = rng.standard_normal((cfg.d_model, cfg.vocab_size)).astype(np.float32)
    emb = _load(tl.Embed(cfg), p)
    assert (emb.unembed is None) == tied
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    toks = rng.integers(0, cfg.vocab_size, (2, 11))
    _close(emb(torch.from_numpy(toks)), jl.embed_tokens(jp, jnp.asarray(toks), jcfg))
    x = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    logits = emb.logits(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    _close(logits, jl.unembed(jp, jnp.asarray(x), jcfg), tol=1e-4)


def test_init_distributions():
    """reset_parameters draws the JAX init's scales (not its numbers)."""
    _, cfg = _cfgs()
    mlp = tl.MLP(dataclasses.replace(cfg, d_model=256, d_ff=1024), "swiglu")
    mlp.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(mlp.w_up.detach().std()) - 256 ** -0.5) < 2e-3
    assert abs(float(mlp.w_down.detach().std()) - 1024 ** -0.5) < 1e-3
    emb = tl.Embed(cfg)
    emb.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(emb.tok.detach().std()) - 0.02) < 2e-3
