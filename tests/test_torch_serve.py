"""The port's serving path against the JAX model (CPU, f32), for each arch:
qwen1.5-0.5b (attention), mamba2-370m (SSD), recurrentgemma-2b (RG-LRU and
local attention; its smoke window of 16 is wrapped by every prompt below,
and the 40-token prompt is ragged against it), and the dense, MoE and
embedding-input archs: internlm2-1.8b, deepseek-67b, nemotron-4-340b
(squared-ReLU, LayerNorm), granite-moe-1b-a400m and phi3.5-moe-42b-a6.6b
(top-k experts with capacity dispatch), musicgen-large and internvl2-2b
(precomputed embeddings in, fed the prompt's last embedding at every decode
step as ``repro.launch.serve`` does). Also the time-minor K cache
(``decode_k_time_minor``) on qwen's and internlm2's smoke configs.

Weights come from the JAX init and go across through numpy
(``repro_torch.convert.params_from_jax``); prompts (token ids, or f32
embeddings) are made with numpy.
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

ARCHS = ["qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b", "internlm2-1.8b",
         "internvl2-2b", "musicgen-large", "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
         "deepseek-67b", "nemotron-4-340b"]
PREFILL_TOL = 1e-4   # f32 logits, port vs JAX
DECODE_TOL = 1e-4    # f32 logits of each decode step, port vs JAX
CONSIST_TOL = 5e-4   # port decode vs port prefill (tests/test_decode_consistency.py)


def _f32_cfg(mod, arch, **kw):
    return dataclasses.replace(mod(arch, smoke=True), act_dtype="float32",
                               param_dtype="float32", **kw)


def _pair(arch, **kw):
    """(JAX model, JAX params, port model) with the same f32 weights."""
    jcfg = _f32_cfg(jax_get_model_config, arch, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = _f32_cfg(get_model_config, arch, **kw)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, model


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _prompt(cfg, b, s, seed=0):
    """numpy token ids [b, s], or f32 embeddings [b, s, d] for a model of
    embedding inputs."""
    if cfg.embed_inputs:
        return _tokens(b, s, cfg.vocab_size, seed)
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _torch(a):
    return torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)


def _step_input(prompt, i):
    """The decode input at position i: token ids [B], or embeddings [B, 1, d]."""
    return prompt[:, i] if prompt.ndim == 2 else prompt[:, i:i + 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copied_verbatim(arch):
    for smoke in (False, True):
        mine = dataclasses.asdict(get_model_config(arch, smoke=smoke))
        ref = dataclasses.asdict(jax_get_model_config(arch, smoke=smoke))
        assert mine == ref


def test_prefill_logits_match_jax(pair):
    jmodel, jparams, model = pair
    toks = _prompt(model.cfg, 2, 48)
    _, jl = jmodel.prefill(jparams, jnp.asarray(toks), max_len=52)
    counts = (flash_attention_fwd, ssd_scan_fwd, rglru_scan_fwd)
    launches = [k.launches for k in counts]
    _, tl = model.prefill(_torch(toks), max_len=52)
    assert [k.launches for k in counts] == launches     # CPU: the plain versions
    assert tl.dtype == torch.float32 and tl.shape == (2, model.cfg.vocab_size)
    err = np.abs(tl.numpy() - np.asarray(jl)).max()
    assert err <= PREFILL_TOL, err


def _decode_steps_match(jmodel, jparams, model):
    s0, t = 40, 4
    toks = _prompt(model.cfg, 2, s0 + t, seed=1)
    jc, _ = jmodel.prefill(jparams, jnp.asarray(toks[:, :s0]), max_len=s0 + t)
    tc, _ = model.prefill(_torch(toks[:, :s0]), max_len=s0 + t)
    for i in range(t):
        step = _step_input(toks, s0 + i)
        jc, jl = jmodel.decode_step(jparams, jc, jnp.asarray(step), jnp.int32(s0 + i))
        tc, tl = model.decode_step(tc, _torch(step), s0 + i)
        err = np.abs(tl.numpy() - np.asarray(jl)).max()
        assert err <= DECODE_TOL, (i, err)
    return tc


def test_decode_steps_match_jax(pair):
    _decode_steps_match(*pair)


def _jax_greedy_from_embeds(jmodel, jparams, prompt, max_new):
    """The JAX package's serving entry point for embedding inputs
    (``repro.launch.serve.main``): prefill, then the prompt's last embedding
    fed at every decode step; the argmax tokens."""
    s = prompt.shape[1]
    caches, logits = jmodel.prefill(jparams, prompt, max_len=s + max_new)
    toks = [jnp.argmax(logits, -1)]
    for t in range(max_new - 1):
        caches, logits = jmodel.decode_step(jparams, caches, prompt[:, -1:], jnp.int32(s + t))
        toks.append(jnp.argmax(logits, -1))
    return jnp.stack(toks, 1)


def test_greedy_tokens_match_jax(pair):
    jmodel, jparams, model = pair
    toks = _prompt(model.cfg, 2, 32, seed=2)
    if model.cfg.embed_inputs:
        jt = jax_greedy_generate(jmodel, jparams, jnp.asarray(toks), max_new=8)
    else:
        jt = _jax_greedy_from_embeds(jmodel, jparams, jnp.asarray(toks), 8)
    tt = greedy_generate(model, _torch(toks), max_new=8)
    assert tt.shape == (2, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internlm2-1.8b"])
def test_time_minor_decode_matches_jax(arch):
    """``decode_k_time_minor``: K cached [B, Hk, hd, Smax], written transposed
    by prefill and a column a decode step; the decode logits as JAX's."""
    jmodel, jparams, model = _pair(arch, decode_k_time_minor=True)
    cfg = model.cfg
    caches = _decode_steps_match(jmodel, jparams, model)
    hd = cfg.resolved_head_dim
    assert caches[0]["k"].shape == (2, cfg.num_kv_heads, hd, 44)
    assert caches[0]["v"].shape == (2, 44, cfg.num_kv_heads, hd)


def test_port_decode_matches_port_prefill(pair):
    _, _, model = pair
    if model.cfg.num_experts:
        # capacity drops depend on the tokens of a call (B*S against B): as
        # tests/test_decode_consistency.py, at a capacity that drops nothing
        roomy = build_model(dataclasses.replace(model.cfg, moe_capacity_factor=8.0),
                            device="cpu")
        roomy.load_state_dict(model.state_dict())
        model = roomy
    s0, t = 48, 4
    toks = _torch(_prompt(model.cfg, 2, s0 + t, seed=3))
    caches, lg = model.prefill(toks[:, :s0], max_len=s0 + t)
    for i in range(t):
        caches, lg = model.decode_step(caches, _step_input(toks, s0 + i), s0 + i)
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
    """The port's parameters against the JAX init's leaves (shapes only), for
    every arch at full size. For
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
    # the token table only when the model embeds its own tokens; the
    # unembedding unless tied to that table
    assert (model.embed.tok is None) == (not cfg.embed_inputs)
    assert (model.embed.unembed is None) == (cfg.tie_embeddings and cfg.embed_inputs)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_on_meta(arch):
    """The parameters a token's forward reads, for the model-FLOPs share: the
    experts its router passes over (E - k of E in each MoE layer) are the
    same count as the JAX config's ``active_param_count`` leaves out."""
    model = build_model(get_model_config(arch), device="meta")
    jcfg = jax_get_model_config(arch)
    inactive = sum(p.numel() for p in model.parameters()) - model.active_param_count()
    assert inactive == jcfg.param_count() - jcfg.active_param_count()
    assert (inactive > 0) == bool(jcfg.num_experts)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [True, False])
def test_cache_bytes_match_jax(arch, smoke):
    cfg = get_model_config(arch, smoke=smoke)
    jcfg = jax_get_model_config(arch, smoke=smoke)
    assert cache_bytes(cfg, 4, 544) == jax_cache_bytes(jcfg, 4, 544)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b"])
def test_time_minor_cache_shapes_match_jax(arch):
    """Global layers' K time-minor, local layers' ring time-major, as JAX's."""
    from repro.models.transformer import init_caches as jax_init_caches
    from repro_torch.models.transformer import init_caches
    cfg = dataclasses.replace(get_model_config(arch, smoke=True), decode_k_time_minor=True)
    jcfg = dataclasses.replace(jax_get_model_config(arch, smoke=True), decode_k_time_minor=True)
    jtree = jax.eval_shape(lambda: jax_init_caches(jcfg, 2, 40))
    jshapes = sorted(tuple(x.shape[1:]) for x in jax.tree.leaves(jtree["groups"]))
    mine = init_caches(cfg, 2, 40, torch.float32, device="meta")
    n_pat = len(cfg.block_pattern or (None,))
    assert sorted(tuple(t.shape) for c in mine[:n_pat] for t in c.values()) == jshapes
    assert cache_bytes(cfg, 4, 544) == jax_cache_bytes(jcfg, 4, 544)
