"""``make_serve_step`` against the JAX package's (CPU, f32): for every
arch's smoke config, 8 greedy steps of the port's step (``decode_step`` plus
argmax; on the CPU it runs eagerly, on the card it is one captured CUDA
graph: tests/test_torch_parallel_cuda.py) against JAX's jitted
``make_serve_step`` step on the same converted weights, from the same
prefill, each side fed its own tokens (a model of embedding inputs the
prompt's last embedding). Tokens equal at every step; logits within
``DECODE_TOL`` (1e-4, tests/test_torch_serve.py's serve parity). ``pos`` is
given as an int and as a 0-d tensor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_model_config as jax_get_model_config
from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.launch.mesh import make_mesh_for as jax_make_mesh_for
from repro.models import build_model as jax_build_model
from repro.serve.decode import make_serve_step as jax_make_serve_step
from repro_torch.config import ParallelConfig, get_model_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.parallel import ShardingRules
from repro_torch.serve.decode import ServeStep, greedy_decode, make_serve_step

ARCHS = ["qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b", "internlm2-1.8b",
         "internvl2-2b", "musicgen-large", "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
         "deepseek-67b", "nemotron-4-340b"]
DECODE_TOL = 1e-4
B, S0, STEPS = 2, 40, 8


def _f32_cfg(mod, arch):
    return dataclasses.replace(mod(arch, smoke=True), act_dtype="float32",
                               param_dtype="float32")


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """(arch, JAX tokens [STEPS, B] and logits [STEPS, B, V] of its step,
    the port's model and prompt)."""
    arch = request.param
    jcfg = _f32_cfg(jax_get_model_config, arch)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = _f32_cfg(get_model_config, arch)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    rng = np.random.default_rng(7)
    prompt = (rng.integers(0, cfg.vocab_size, size=(B, S0)).astype(np.int32)
              if cfg.embed_inputs else rng.standard_normal((B, S0, cfg.d_model)).astype(np.float32))
    jpar = JaxParallelConfig(data=1, model=1)
    jstep, _, _ = jax_make_serve_step(jmodel, jpar, jax_make_mesh_for(jpar), B, S0 + STEPS + 1)
    jstep = jax.jit(jstep, donate_argnums=(1,))
    caches, logits = jmodel.prefill(jparams, jnp.asarray(prompt), max_len=S0 + STEPS + 1)
    token = jnp.argmax(logits, -1).astype(jnp.int32)
    last = None if cfg.embed_inputs else jnp.asarray(prompt[:, -1:])
    toks, logs = [], []
    for t in range(STEPS):
        caches, token = jstep(jparams, caches, token if last is None else last,
                              jnp.int32(S0 + t))
        # the step returns the token only: its logits are decode_step's
        toks.append(np.asarray(token))
    caches, logits = jmodel.prefill(jparams, jnp.asarray(prompt), max_len=S0 + STEPS + 1)
    token = jnp.argmax(logits, -1).astype(jnp.int32)
    for t in range(STEPS):
        caches, lg = jax.jit(jmodel.decode_step)(jparams, caches,
                                                 token if last is None else last,
                                                 jnp.int32(S0 + t))
        token = jnp.argmax(lg, -1).astype(jnp.int32)
        logs.append(np.asarray(lg))
    return arch, np.stack(toks), np.stack(logs), model, prompt


@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
def test_serve_step_matches_jax(runs, pos_kind):
    arch, jtoks, jlogits, model, prompt = runs
    cfg = model.cfg
    step, cache_sh, rules = make_serve_step(model, ParallelConfig(data=1, model=1), None, B,
                                            S0 + STEPS + 1)
    assert isinstance(step, ServeStep) and cache_sh is None
    assert isinstance(rules, ShardingRules) and rules.model == cfg
    tp = torch.from_numpy(prompt).long() if cfg.embed_inputs else torch.from_numpy(prompt)
    caches, logits = model.prefill(tp, max_len=S0 + STEPS + 1)
    token = torch.argmax(logits, -1)
    last = None if cfg.embed_inputs else tp[:, -1:]
    for t in range(STEPS):
        pos = S0 + t if pos_kind == "int" else torch.tensor(S0 + t)
        caches, token = step(caches, token if last is None else last, pos)
        np.testing.assert_array_equal(token.numpy(), jtoks[t], err_msg=f"{arch} step {t}")
        err = np.abs(step.logits.numpy() - jlogits[t]).max()
        assert err <= DECODE_TOL, (arch, t, err)
    assert step.captures == 0      # the CPU runs the step eagerly


def test_greedy_decode_eager_and_step_agree():
    """``greedy_decode`` through a ServeStep and through its eager step give
    the same tokens and last logits from copies of one prefill."""
    cfg = _f32_cfg(get_model_config, "recurrentgemma-2b")
    model = build_model(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 30)))
    caches, logits = model.prefill(toks, max_len=60)
    copy = [{k: t.clone() for k, t in c.items()} for c in caches]
    token = logits.argmax(-1)
    a, la = greedy_decode(model, caches, token, 30, 20)
    b, lb = greedy_decode(model, copy, token, 30, 20, graph=False)
    assert torch.equal(a, b) and torch.equal(la, lb)


@pytest.mark.parametrize("tied", [True, False])
def test_logits_in_table_blocks(monkeypatch, tied):
    """The unembedding cast to f32 a block at a time (vocab blocks of the
    tied table, d_model blocks of a separate one; the last block ragged)
    gives the whole table's logits within f32 summation order (1e-5); the
    exact f32 copies of the blocks that the serve step installs give the
    cast blocks' bit for bit."""
    from repro_torch.models import layers
    cfg = dataclasses.replace(_f32_cfg(get_model_config, "qwen1.5-0.5b"),
                              param_dtype="bfloat16", tie_embeddings=tied, logit_softcap=30.0)
    model = build_model(cfg, device="cpu")
    x = torch.randn((3, cfg.d_model), generator=torch.Generator().manual_seed(2))
    whole = model.embed.logits(x)
    dim, blocks = model.embed.weight_blocks()
    assert dim == (1 if tied else 0) and len(blocks) == 1
    w = model.embed.weight()
    monkeypatch.setattr(layers, "LOGITS_BLOCK_BYTES", 4 * w.shape[1 - dim] * 7)
    _, blocks = model.embed.weight_blocks()
    assert len(blocks) == -(-w.shape[dim] // 7)
    assert blocks[-1].shape[dim] == (w.shape[dim] % 7 or 7)
    blocked = model.embed.logits(x)
    torch.testing.assert_close(blocked, whole, rtol=1e-5, atol=1e-5)
    model.embed.f32_copies = {"weight": [b.float() for b in blocks]}
    try:
        assert torch.equal(model.embed.logits(x), blocked)
    finally:
        model.embed.f32_copies = None
