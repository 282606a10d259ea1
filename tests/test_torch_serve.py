"""The port's serving path against the JAX model (CPU, f32), for each ported
arch: qwen1.5-0.5b (attention), mamba2-370m (SSD) and recurrentgemma-2b
(RG-LRU and local attention; its smoke window of 16 is wrapped by every
prompt below, and the 40-token prompt is ragged against it).

Weights come from the JAX init and go across through numpy
(``repro_torch.convert.params_from_jax``); prompts are made with numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_model_config as jax_get_model_config
from repro.models import build_model as jax_build_model
from repro.serve.decode import greedy_generate as jax_greedy_generate
from repro.serve.kvcache import cache_bytes as jax_cache_bytes
from repro_torch.config import get_model_config
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rglru_scan import rglru_scan_fwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.models import build_model
from repro_torch.serve import cache_bytes, greedy_generate

ARCHS = ["qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b"]
PREFILL_TOL = 1e-4   # f32 logits, port vs JAX
DECODE_TOL = 1e-4    # f32 logits of each decode step, port vs JAX
CONSIST_TOL = 5e-4   # port decode vs port prefill (tests/test_decode_consistency.py)


def _f32_cfg(mod, arch):
    return dataclasses.replace(mod(arch, smoke=True), act_dtype="float32",
                               param_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(JAX model, JAX params, port model) with the same f32 weights."""
    jcfg = _f32_cfg(jax_get_model_config, request.param)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = _f32_cfg(get_model_config, request.param)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, model


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copied_verbatim(arch):
    for smoke in (False, True):
        mine = dataclasses.asdict(get_model_config(arch, smoke=smoke))
        ref = dataclasses.asdict(jax_get_model_config(arch, smoke=smoke))
        assert mine == ref


def test_prefill_logits_match_jax(pair):
    jmodel, jparams, model = pair
    toks = _tokens(2, 48, model.cfg.vocab_size)
    _, jl = jmodel.prefill(jparams, jnp.asarray(toks), max_len=52)
    counts = (flash_attention_fwd, ssd_scan_fwd, rglru_scan_fwd)
    launches = [k.launches for k in counts]
    _, tl = model.prefill(torch.from_numpy(toks).long(), max_len=52)
    assert [k.launches for k in counts] == launches     # CPU: the plain versions
    assert tl.dtype == torch.float32 and tl.shape == (2, model.cfg.vocab_size)
    err = np.abs(tl.numpy() - np.asarray(jl)).max()
    assert err <= PREFILL_TOL, err


def test_decode_steps_match_jax(pair):
    jmodel, jparams, model = pair
    s0, t = 40, 4
    toks = _tokens(2, s0 + t, model.cfg.vocab_size, seed=1)
    jc, _ = jmodel.prefill(jparams, jnp.asarray(toks[:, :s0]), max_len=s0 + t)
    tc, _ = model.prefill(torch.from_numpy(toks[:, :s0]).long(), max_len=s0 + t)
    for i in range(t):
        jc, jl = jmodel.decode_step(jparams, jc, jnp.asarray(toks[:, s0 + i]),
                                    jnp.int32(s0 + i))
        tc, tl = model.decode_step(tc, torch.from_numpy(toks[:, s0 + i]).long(), s0 + i)
        err = np.abs(tl.numpy() - np.asarray(jl)).max()
        assert err <= DECODE_TOL, (i, err)


def test_greedy_tokens_match_jax(pair):
    jmodel, jparams, model = pair
    toks = _tokens(2, 32, model.cfg.vocab_size, seed=2)
    jt = np.asarray(jax_greedy_generate(jmodel, jparams, jnp.asarray(toks), max_new=8))
    tt = greedy_generate(model, torch.from_numpy(toks).long(), max_new=8)
    assert tt.shape == (2, 8)
    np.testing.assert_array_equal(tt.numpy(), jt)


def test_port_decode_matches_port_prefill(pair):
    _, _, model = pair
    s0, t = 48, 4
    toks = torch.from_numpy(_tokens(2, s0 + t, model.cfg.vocab_size, seed=3)).long()
    caches, lg = model.prefill(toks[:, :s0], max_len=s0 + t)
    for i in range(t):
        caches, lg = model.decode_step(caches, toks[:, s0 + i], s0 + i)
    _, lg_full = model.prefill(toks, max_len=s0 + t)
    err = float((lg - lg_full).abs().max())
    assert err < CONSIST_TOL, err


@pytest.mark.parametrize("arch,leaf", [("qwen1.5-0.5b", ("attn", "wq")),
                                       ("mamba2-370m", ("ssd", "w_x"))])
def test_bf16_tree_converts_bit_exactly(arch, leaf):
    jcfg = jax_get_model_config(arch, smoke=True)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_model_config(arch, smoke=True)
    sd = params_from_jax(tree, cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    assert set(sd) == set(model.state_dict())
    w = tree["backbone"]["groups"][0][leaf[0]][leaf[1]]        # [n_groups, d, e]
    assert w.dtype.name == "bfloat16"
    for g in range(cfg.num_layers):
        got = getattr(getattr(model.backbone.layers[g], leaf[0]), leaf[1]).detach()
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      w[g].view(np.uint16))
    tok = model.embed.tok.detach().view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(tok, tree["embed"]["tok"].view(np.uint16))
    if leaf[0] == "ssd":                                     # f32 leaves stay f32
        a_log = tree["backbone"]["groups"][0]["ssd"]["A_log"]
        assert a_log.dtype == np.float32
        np.testing.assert_array_equal(model.backbone.layers[1].ssd.A_log.detach().numpy(),
                                      a_log[1])


def test_bf16_recurrentgemma_tree_converts_bit_exactly():
    """Five layers: one group of (RG-LRU, RG-LRU, local attention), then two
    RG-LRU remainder layers, as the full config's 24 and 25 follow its eight
    groups. Every leaf lands on its layer bit for bit, f32 leaves stay f32."""
    jcfg = dataclasses.replace(jax_get_model_config("recurrentgemma-2b", smoke=True),
                               num_layers=5)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(6))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = dataclasses.replace(get_model_config("recurrentgemma-2b", smoke=True), num_layers=5)
    sd = params_from_jax(tree, cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    assert set(sd) == set(model.state_dict())
    layers = model.backbone.layers
    groups, rem = tree["backbone"]["groups"], tree["backbone"]["rem"]
    pairs = [(layers[0].rglru, groups[0]["rglru"], 0), (layers[1].rglru, groups[1]["rglru"], 0),
             (layers[2].attn, groups[2]["attn"], 0), (layers[3].rglru, rem[0]["rglru"], None),
             (layers[4].rglru, rem[1]["rglru"], None)]
    for mod, leaves, g in pairs:
        for name, arr in leaves.items():
            ref = to_tensor(arr if g is None else arr[g])      # the JAX bits, as a tensor
            got = getattr(mod, name).detach()
            assert got.dtype == ref.dtype and torch.equal(got, ref), name
    assert layers[3].rglru.lam.dtype == torch.float32
    assert layers[3].rglru.w_a.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_count_on_meta(arch):
    """The port's parameters against the JAX init's leaves (shapes only). For
    qwen that is also the analytic ``cfg.param_count()``; for mamba2 the
    analytic count misses the conv biases and counts a second norm that a
    block without an MLP does not have; for recurrentgemma-2b it counts
    Griffin's block-diagonal gates where both inits draw dense ones."""
    cfg = get_model_config(arch)
    model = build_model(cfg, device="meta")
    jshapes = jax.eval_shape(jax_build_model(jax_get_model_config(arch)).init,
                             jax.random.PRNGKey(0))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    if arch == "qwen1.5-0.5b":
        assert n_jax == cfg.param_count()
    if arch == "recurrentgemma-2b":
        assert n_jax == 2_894_574_080
        w = cfg.rglru_width
        assert n_jax - cfg.param_count() == 18 * (2 * w * w - 2 * w * (w // 8) + w)
    assert model.embed.unembed is None                      # tied embeddings


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_cache_bytes_match_jax(arch, smoke):
    cfg = get_model_config(arch, smoke=smoke)
    jcfg = jax_get_model_config(arch, smoke=smoke)
    assert cache_bytes(cfg, 4, 544) == jax_cache_bytes(jcfg, 4, 544)
