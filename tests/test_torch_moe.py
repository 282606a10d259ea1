"""The port's MoE (``repro_torch.models.moe``) against ``repro.models.moe``
in f32 (CPU), at the smoke widths of the two MoE archs.

Parameters come from the JAX ``init_moe`` and go across through numpy, as
``convert.params_from_jax`` carries a block's ``moe`` leaves; inputs are made
with numpy from a seed. Checked: the output and the three aux values, the
``moe_group_by_batch`` branch (per-row routing, JAX's vmap without a mesh),
a capacity that drops tokens, a decode step's capacity (T = B), and the
gradients of a loss with the aux terms against ``jax.grad``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_model_config as jax_get_model_config
from repro.models import moe as jmoe
from repro_torch.config import get_model_config
from repro_torch.models import moe as tmoe

ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]
TOL = 1e-5        # f32 outputs and aux values, max abs error
GRAD_TOL = 1e-4   # f32 gradients, max abs error / max |JAX gradient|
AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


def _cfgs(arch, **kw):
    kw = dict(act_dtype="float32", param_dtype="float32", **kw)
    return (dataclasses.replace(jax_get_model_config(arch, smoke=True), **kw),
            dataclasses.replace(get_model_config(arch, smoke=True), **kw))


def _pair(arch, seed=0, **kw):
    """(JAX cfg, JAX params, port MoE with the same weights)."""
    jcfg, cfg = _cfgs(arch, **kw)
    params = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    module = tmoe.MoE(cfg, device="cpu")
    with torch.no_grad():
        for name, arr in params.items():
            getattr(module, name).copy_(torch.from_numpy(np.array(arr)))
    return jcfg, params, module


def _x(shape, d, seed=1):
    return np.random.default_rng(seed).standard_normal((*shape, d)).astype(np.float32)


def _compare(jcfg, params, module, x):
    jy, jaux = jmoe.apply_moe(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        ty, taux = module(torch.from_numpy(x))
    assert ty.shape == x.shape
    err = float(np.abs(ty.detach().numpy() - np.asarray(jy)).max())
    assert err <= TOL, err
    for key in AUX:
        assert abs(float(taux[key]) - float(jaux[key])) <= TOL, (key, float(taux[key]),
                                                                  float(jaux[key]))
    return {k: float(v) for k, v in taux.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_jax(arch):
    jcfg, params, module = _pair(arch)
    _compare(jcfg, params, module, _x((2, 24), jcfg.d_model))


@pytest.mark.parametrize("arch", ARCHS)
def test_group_by_batch_matches_jax(arch):
    """Each row routed alone, capacity per row, aux averaged over the rows."""
    jcfg, params, module = _pair(arch, moe_group_by_batch=True)
    x = _x((3, 20), jcfg.d_model, seed=2)
    aux = _compare(jcfg, params, module, x)
    with torch.no_grad():
        rows = [tmoe.moe_tokens(torch.from_numpy(r), module.router, module.w_gate,
                                module.w_up, module.w_down, module.cfg)[1] for r in x]
    assert aux["moe_drop_frac"] == pytest.approx(
        float(np.mean([float(a["moe_drop_frac"]) for a in rows])), abs=1e-7)


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_tokens_match_jax(arch):
    """A capacity factor of 0.5 drops about half the slots: the same ones."""
    jcfg, params, module = _pair(arch, seed=3, moe_capacity_factor=0.5)
    aux = _compare(jcfg, params, module, _x((2, 32), jcfg.d_model, seed=4))
    assert aux["moe_drop_frac"] > 0.2


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_capacity_matches_jax(arch):
    """A decode step routes T = B tokens: capacity max(int(1.25 B k / E), k)."""
    jcfg, params, module = _pair(arch, seed=5)
    b, k = 3, jcfg.num_experts_per_tok
    assert tmoe.capacity(module.cfg, b) == max(int(1.25 * b * k / jcfg.num_experts), k)
    _compare(jcfg, params, module, _x((b, 1), jcfg.d_model, seed=6))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_grads_with_aux_match_jax(arch, factor):
    """d/d(params, x) of sum(y * c) + 0.01 lb + 1e-3 z, as the model's loss
    weighs the aux terms; at 0.5 with dropped slots."""
    jcfg, params, module = _pair(arch, seed=7, moe_capacity_factor=factor)
    x = _x((2, 16), jcfg.d_model, seed=8)
    cot = _x((2, 16), jcfg.d_model, seed=9)

    def jloss(p, xx):
        y, aux = jmoe.apply_moe(p, xx, jcfg)
        return (jnp.sum(y * cot) + jcfg.router_aux_loss * aux["moe_lb_loss"]
                + 1e-3 * aux["moe_z_loss"])

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = module(xt)
    loss = (torch.sum(y * torch.from_numpy(cot)) + module.cfg.router_aux_loss
            * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"])
    names = ("router", "w_gate", "w_up", "w_down")
    grads = torch.autograd.grad(loss, [getattr(module, n) for n in names] + [xt])
    for name, g in zip(names + ("x",), grads):
        ref = np.asarray(jgx if name == "x" else jg[name])
        err = float(np.abs(g.numpy() - ref).max()) / float(np.abs(ref).max())
        assert err <= GRAD_TOL, (name, err)
