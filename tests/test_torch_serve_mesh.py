"""Serving on a mesh in the port (``make_serve_step`` on a split model)
against the same mixers whole, the JAX package's jitted sharded prefill and
decode under the same ``ShardingRules``, and the port's one-rank serve (CPU,
f32).

* Each mixer's prefill and decode on 2 gloo ranks of a (1, 2) ("data",
  "model") mesh against itself whole on the same weights and inputs: its
  outputs, and each rank's cache against its shard of the whole cache under
  ``cache_spec`` (kv heads split; the sequence split over "model", with the
  time-minor K and a local layer's ring of slots; kv heads whole with the
  cache whole; q heads that do not divide; the SSD and RG-LRU states kept
  whole). The decode crosses rank 1's first row. Each planted fault must
  part from whole.
* The smoke configs of qwen (kv heads split), internlm2 with one kv head
  (the sequence split), the same with the time-minor K, mamba2 (SSD
  states), recurrentgemma (the ring split, RG-LRU), granite (experts split)
  and deepseek under ``fsdp`` (ZeRO-3 over "data") served on 8 gloo ranks of
  a (2, 2, 2) ("pod", "data", "model") mesh, each rank its row of a batch of
  4: the prefill's logits and 6 greedy steps whose positions cross the
  sequence slices' boundary, against JAX's jitted prefill and decode on 8
  host devices (parameters in the rules' shardings, caches in
  ``cache_spec``'s) and the port's serve on one process; every rank's
  caches of ``cache_spec``'s local shapes; the step refuses to capture a
  CUDA graph over gloo.

Tolerances are ``torch_parity.TP_SERVE_*``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_mesh_harness as harness
from torch_parity import TP_SERVE_LAYER_TOL, TP_SERVE_LOGITS_TOL
from repro_torch.models import build_model

B = 4
# name -> (arch, config changes, ParallelConfig changes, the attention
# layouts its caches must take)
CASES = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", {}, {}, ["heads"]),
    "internlm2-1.8b kv=1": ("internlm2-1.8b", {"num_kv_heads": 1}, {}, ["seq"]),
    "internlm2-1.8b kv=1 time-minor K": ("internlm2-1.8b",
                                         {"num_kv_heads": 1, "decode_k_time_minor": True}, {},
                                         ["seq"]),
    "mamba2-370m": ("mamba2-370m", {}, {}, []),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}, {}, ["seq"]),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, {}, ["heads"]),
    "deepseek-67b fsdp": ("deepseek-67b", {}, {"fsdp": True}, ["heads"]),
}

_JAX_SERVE = """
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.config import get_model_config
    from repro.config.base import ParallelConfig
    from repro.models import build_model
    from repro.parallel.compat import make_mesh, set_mesh
    from repro.parallel.sharding import ShardingRules, named
    from repro_torch.config import get_model_config as port_config
    from repro_torch.convert import params_from_jax
    from torch_mesh_harness import SERVE_MAXLEN, SERVE_S0, SERVE_STEPS
    from test_torch_serve_mesh import B, CASES, prompt_np
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for name, (arch, over, par_over, _) in CASES.items():
        kw = dict(act_dtype="float32", param_dtype="float32", **over)
        cfg = dataclasses.replace(get_model_config(arch, smoke=True), **kw)
        pcfg = dataclasses.replace(port_config(arch, smoke=True), **kw)
        par = ParallelConfig(multi_pod=True, pods=2, data=2, model=2, **par_over)
        rules = ShardingRules(cfg, par)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        sd = params_from_jax(jax.tree.map(np.asarray, params), pcfg)
        out.update({f"{name}|init|{k}": v.numpy() for k, v in sd.items()})
        params_sh = named(mesh, rules.params_tree_specs(params))
        params = jax.device_put(params, params_sh)
        prompt = jnp.asarray(prompt_np(cfg.vocab_size))
        with set_mesh(mesh):
            prefill = jax.jit(lambda p, x: model.prefill(p, x, max_len=SERVE_MAXLEN),
                              in_shardings=(params_sh, named(mesh, rules.data_spec(2))))
            caches, logits = prefill(params, prompt)
            cache_sh = named(mesh, rules.cache_tree_specs(caches))
            caches = jax.device_put(caches, cache_sh)

            def serve_step(p, c, tok, pos):
                c, lg = model.decode_step(p, c, tok, pos)
                return c, jnp.argmax(lg, -1).astype(jnp.int32), lg
            tok_sh = named(mesh, rules.data_spec(1))
            step = jax.jit(serve_step, in_shardings=(params_sh, cache_sh, tok_sh, None),
                           out_shardings=(cache_sh, tok_sh, None), donate_argnums=(1,))
            token = jax.device_put(jnp.argmax(logits, -1).astype(jnp.int32), tok_sh)
            toks, logs = [np.asarray(token)], []
            for t in range(SERVE_STEPS):
                caches, token, lg = step(params, caches, token, jnp.int32(SERVE_S0 + t))
                toks.append(np.asarray(token))
                logs.append(np.asarray(lg))
        out[f"{name}|prefill"] = np.asarray(logits)
        out[f"{name}|tokens"] = np.stack(toks)
        out[f"{name}|logits"] = np.stack(logs)
    np.savez(OUT, **out)
"""


def prompt_np(vocab: int) -> np.ndarray:
    """The prompt: tokens [B, SERVE_S0] from seed 5."""
    return np.random.default_rng(5).integers(0, vocab, size=(B, harness.SERVE_S0)).astype(
        np.int32)


def _cfg(name):
    from repro_torch.config import get_model_config
    arch, over, _, _ = CASES[name]
    return dataclasses.replace(get_model_config(arch, smoke=True), act_dtype="float32",
                               param_dtype="float32", **over)


# ------------------------------ the mixers ------------------------------

LAYER_CASES = list(harness.tp_serve_layer_cases())


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    return harness.run_ranks("tp_serve_layers", {},
                             tmp_path_factory.mktemp("tp_serve_layers") / "out.pt",
                             shape=(1, 2), axes=("data", "model"))


@pytest.mark.parametrize("case", LAYER_CASES)
def test_split_mixer_serves_as_whole(layers, case):
    """Prefill and 6 decode steps: outputs and each rank's caches (its
    shard of the whole cache under ``cache_spec``, of its local shape)."""
    r = layers[case]
    assert r["out"] <= TP_SERVE_LAYER_TOL and r["cache"] <= TP_SERVE_LAYER_TOL, r
    assert r["shapes_ok"], r
    want = ("seq" if "sequence split" in case else
            "whole" if "do not divide" in case else "split")
    assert r["layout"] == want, r


@pytest.mark.parametrize("fault", list(harness.SERVE_PLANTED))
def test_planted_serve_fault_parts_from_whole(layers, fault):
    r = layers["planted"][fault]
    assert max(r["out"], r["cache"]) > 100 * TP_SERVE_LAYER_TOL, r


# ------------------------------ the models ------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: {"jax", "one", "ranks"}}, each {"prefill" [B, V], "tokens"
    [steps + 1, B], "logits" [steps, B, V]} (the ranks' also their cache
    shapes and layouts)."""
    d = tmp_path_factory.mktemp("tp_serve")
    ref = harness.run_jax(_JAX_SERVE, d / "jax.npz")
    cases, out = {}, {}
    for name in CASES:
        cfg = _cfg(name)
        pre = f"{name}|init|"
        state = {k[len(pre):]: torch.from_numpy(v) for k, v in ref.items() if k.startswith(pre)}
        prompt = torch.from_numpy(prompt_np(cfg.vocab_size)).long()
        cases[name] = (cfg, CASES[name][2], state, prompt)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        caches, logits = model.prefill(prompt, max_len=harness.SERVE_MAXLEN)
        token = torch.argmax(logits, -1)
        toks, logs = [token], []
        for t in range(harness.SERVE_STEPS):
            caches, lg = model.decode_step(caches, token, harness.SERVE_S0 + t)
            token = torch.argmax(lg, -1)
            toks.append(token)
            logs.append(lg)
        out[name] = {
            "jax": {k: ref[f"{name}|{k}"] for k in ("prefill", "tokens", "logits")},
            "one": {"prefill": logits.numpy(), "tokens": torch.stack(toks).numpy(),
                    "logits": torch.stack(logs).numpy()}}
    ranks = harness.run_ranks("tp_serve", {"cases": cases}, d / "port.pt")
    for name in CASES:
        r = ranks[name]
        out[name]["ranks"] = dict(r, **{k: r[k].numpy() for k in ("prefill", "tokens",
                                                                    "logits")})
    return out


@pytest.mark.parametrize("against", ["jax", "one"])
@pytest.mark.parametrize("name", list(CASES))
def test_split_serve_matches(runs, name, against):
    """Tokens equal at every step; the prefill's and every step's logits
    within ``TP_SERVE_LOGITS_TOL``."""
    got, ref = runs[name]["ranks"], runs[name][against]
    np.testing.assert_array_equal(got["tokens"], ref["tokens"].astype(np.int64), err_msg=name)
    for k in ("prefill", "logits"):
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= TP_SERVE_LOGITS_TOL, (name, k, err)


@pytest.mark.parametrize("name", list(CASES))
def test_split_serve_caches_take_the_rules_layout(runs, name):
    """Every rank's caches have ``cache_spec``'s local shapes after prefill
    and after decode (and ``model.init_cache`` gives them), the ranks of a
    "model" group agree, the attention caches take the expected layout, and
    the step did not capture."""
    r = runs[name]["ranks"]
    assert r["bad_shapes"] == [], r["bad_shapes"]
    assert not r["ranks_differ"]
    assert r["layouts"] == CASES[name][3], r["layouts"]
    assert r["captures"] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_split_step_refuses_to_capture_over_gloo(runs, name):
    """``ServeStep`` refuses to capture a CUDA graph of a model split over
    gloo groups (their collectives cannot sit in a graph): the split path
    steps through ``ServeStep.eager``."""
    assert "cannot be captured in a CUDA graph" in runs[name]["ranks"]["refused"]
