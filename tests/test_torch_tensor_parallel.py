"""Tensor-parallel compute in the port (``parallel.tensor``) against the
same layers whole, the JAX package's step under the same ``ShardingRules``,
and the port's own one-rank step (CPU, f32).

* Each split layer on 2 gloo ranks of a (1, 2) ("data", "model") mesh
  against itself whole on the same weights, input and output gradient: the
  MLP (column- then row-parallel), the vocab-parallel embedding and
  cross-entropy (tied with softcap; untied), attention with its q and kv
  heads split, with whole kv heads (one a rank; one per q head), with q
  heads that do not divide (whole), local attention, the SSD with its gated
  norm's sum over "model", the RG-LRU with its gates' gathered input, and
  MoE experts split. Each planted fault must part from the whole layer.
* Two steps of the split ``make_train_step`` step on 8 gloo ranks of a
  (2, 2, 2) ("pod", "data", "model") mesh for the smoke configs of qwen
  (tied vocab split), internlm2 with one kv head (q split, kv whole),
  mamba2, recurrentgemma, granite (experts split) and deepseek under
  ``fsdp`` (ZeRO-3 over "data"), against JAX's jitted step on 8 host devices
  and the port's one-rank ``train_step``, and every rank's parameters and
  moments of exactly the rules' shard shapes.
* The collectives of deepseek's ZeRO-3 step on a fake (2, 2, 2) group equal
  8 real gloo ranks'.

Tolerances are ``torch_parity.TP_*``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_mesh_harness as harness
from torch_parity import TP_LAYER_TOL, TP_LOSS_TOL, TP_NORM_REL_TOL, TP_PARAM_TOL
from repro_torch.config import ParallelConfig, TrainConfig
from repro_torch.models import build_model
from repro_torch.train import init_adam, train_step

TRAIN = dict(global_batch=4, seq_len=64, lr=3e-3, warmup_steps=1, total_steps=3, eps=1e-3)
# name -> (arch, config changes, ParallelConfig changes)
CASES = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", {}, {}),
    "internlm2-1.8b kv=1": ("internlm2-1.8b", {"num_kv_heads": 1}, {}),
    "mamba2-370m": ("mamba2-370m", {}, {}),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}, {}),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, {}),
    "deepseek-67b fsdp": ("deepseek-67b", {}, {"fsdp": True}),
}
# what each case exercises: parameters that the (2, 2, 2) rules split over
# "model", and parameters they keep whole over "model"
SPLIT = {
    "qwen1.5-0.5b": (("embed.tok", "backbone.layers.0.attn.wk",
                      "backbone.layers.0.mlp.w_down"), ()),
    "internlm2-1.8b kv=1": (("backbone.layers.0.attn.wq", "embed.unembed"),
                            ("backbone.layers.0.attn.wk",)),
    "mamba2-370m": (("backbone.layers.0.ssd.w_x", "backbone.layers.0.ssd.A_log"),
                    ("backbone.layers.0.ssd.w_bc",)),
    "recurrentgemma-2b": (("backbone.layers.0.rglru.w_a", "backbone.layers.2.attn.wq"),
                          ("backbone.layers.2.attn.wk",)),
    "granite-moe-1b-a400m": (("backbone.layers.0.moe.w_gate",),
                             ("backbone.layers.0.moe.router",)),
    "deepseek-67b fsdp": (("backbone.layers.0.attn.wq", "backbone.layers.0.mlp.w_up"), ()),
}

_JAX_STEPS = """
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.config import get_model_config
    from repro.config.base import ParallelConfig, TrainConfig
    from repro.models import build_model
    from repro.parallel.compat import make_mesh, set_mesh
    from repro.train.train_step import make_train_step
    from repro_torch.config import get_model_config as port_config
    from repro_torch.convert import params_from_jax
    from test_torch_tensor_parallel import CASES, TRAIN, batches_np
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = {}
    for name, (arch, over, par_over) in CASES.items():
        kw = dict(act_dtype="float32", param_dtype="float32", **over)
        cfg = dataclasses.replace(get_model_config(arch, smoke=True), **kw)
        pcfg = dataclasses.replace(port_config(arch, smoke=True), **kw)
        par = ParallelConfig(multi_pod=True, pods=2, data=2, model=2, **par_over)
        model = build_model(cfg, remat="block")
        _, init_fn, jit_step, _ = make_train_step(model, par, TrainConfig(**TRAIN), mesh)
        params, opt = init_fn(jax.random.PRNGKey(0))
        sd = params_from_jax(jax.tree.map(np.asarray, params), pcfg)   # before the donation
        out.update({f"{name}|init|{k}": v.numpy() for k, v in sd.items()})
        step = jit_step(params)
        with set_mesh(mesh):
            for i, (toks, labels) in enumerate(batches_np(cfg.vocab_size)):
                params, opt, met = step(params, opt, {"tokens": jnp.asarray(toks),
                                                      "labels": jnp.asarray(labels)})
                out.update({f"{name}|metric{i}|{k}": np.asarray(v) for k, v in met.items()})
        sd = params_from_jax(jax.tree.map(np.asarray, params), pcfg)
        out.update({f"{name}|new|{k}": v.numpy() for k, v in sd.items()})
    np.savez(OUT, **out)
"""


def batches_np(vocab: int):
    """Two batches of tokens and labels [4, 64]; rows masked unevenly, so
    that the loss's token count differs between the batch ranks."""
    out = []
    for seed in (0, 1):
        toks = np.random.default_rng(seed).integers(0, vocab, size=(4, 65)).astype(np.int32)
        labels = toks[:, 1:].copy()
        labels[0, 3] = -1
        labels[2, 10:30] = -1
        out.append((toks[:, :-1], labels))
    return out


def _cfg(name):
    from repro_torch.config import get_model_config
    arch, over, _ = CASES[name]
    return dataclasses.replace(get_model_config(arch, smoke=True), act_dtype="float32",
                               param_dtype="float32", **over)


# ------------------------------ the layers ------------------------------

LAYER_CASES = list(harness.tp_layer_cases())


@pytest.fixture(scope="module")
def layers(tmp_path_factory):
    return harness.run_ranks("tp_layers", {}, tmp_path_factory.mktemp("tp_layers") / "out.pt",
                             shape=(1, 2), axes=("data", "model"))


@pytest.mark.parametrize("case", LAYER_CASES)
def test_split_layer_matches_whole(layers, case):
    r = layers[case]
    assert max(r["out"], r["x_grad"], r["param_grad"]) <= TP_LAYER_TOL, r
    if case == "attention, q heads do not divide":
        assert r["split"] == []                  # the attention runs whole
    else:
        assert r["split"], r
    if "kv heads whole" in case:
        assert not any(n.endswith(("wk", "wv")) for n in r["split"]), r["split"]


@pytest.mark.parametrize("fault", list(harness.TP_PLANTED))
def test_planted_fault_parts_from_whole(layers, fault):
    assert layers["planted"][fault] > 100 * TP_LAYER_TOL, layers["planted"]


# ------------------------------ the step ------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: {"jax", "one", "ranks"}} (each {"metrics": [2 steps], "params"})."""
    d = tmp_path_factory.mktemp("tp_train")
    ref = harness.run_jax(_JAX_STEPS, d / "jax.npz")

    def part(name, tag):
        pre = f"{name}|{tag}|"
        return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}

    cases, out = {}, {}
    for name in CASES:
        cfg = _cfg(name)
        state = {k: torch.from_numpy(v) for k, v in part(name, "init").items()}
        batches = [{"tokens": torch.from_numpy(t).long(), "labels": torch.from_numpy(l).long()}
                   for t, l in batches_np(cfg.vocab_size)]
        cases[name] = (cfg, CASES[name][2], state, batches)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        opt = init_adam(dict(model.named_parameters()))
        metrics = []
        for b in batches:
            opt, m = train_step(model, opt, b, ParallelConfig(), TrainConfig(**TRAIN))
            metrics.append({k: float(v) for k, v in m.items()})
        out[name] = {
            "jax": {"metrics": [{k: float(v) for k, v in part(name, f"metric{i}").items()}
                                for i in range(2)],
                    "params": part(name, "new")},
            "one": {"metrics": metrics,
                    "params": {k: p.detach().numpy().copy()
                               for k, p in model.named_parameters()}}}
    ranks = harness.run_ranks("tp_train", {"cases": cases, "train": TRAIN}, d / "port.pt")
    for name in CASES:
        r = ranks[name]
        out[name]["ranks"] = dict(r, params={k: v.numpy() for k, v in r["params"].items()})
    return out


@pytest.mark.parametrize("against", ["jax", "one"])
@pytest.mark.parametrize("name", list(CASES))
def test_split_step_matches(runs, name, against):
    got, ref = runs[name]["ranks"], runs[name][against]
    for gm, rm in zip(got["metrics"], ref["metrics"]):
        assert abs(gm["loss"] - rm["loss"]) <= TP_LOSS_TOL, (gm, rm)
        assert abs(gm["ce"] - rm["ce"]) <= TP_LOSS_TOL, (gm, rm)
        assert abs(gm["grad_norm"] - rm["grad_norm"]) <= TP_NORM_REL_TOL * rm["grad_norm"], \
            (gm, rm)
        assert gm["lr"] == pytest.approx(rm["lr"], rel=1e-7)
    assert set(got["params"]) == set(ref["params"])
    worst = max((float(np.abs(got["params"][k] - ref["params"][k]).max()), k)
                for k in ref["params"])
    assert worst[0] <= TP_PARAM_TOL * TRAIN["lr"], worst


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_the_rules_shards(runs, name):
    """Every rank's parameters and moments have exactly the rules' shard
    shapes, and no rank holds a split parameter whole."""
    r = runs[name]["ranks"]
    assert r["bad_shapes"] == [] and r["whole_held"] == [], (r["bad_shapes"], r["whole_held"])
    from repro_torch.config import ParallelConfig as PC
    from repro_torch.parallel.sharding import ShardingRules
    rules = ShardingRules(_cfg(name), PC(multi_pod=True, pods=2, data=2, model=2,
                                         **CASES[name][2]))
    params = r["params"]
    split, whole = SPLIT[name]
    for k in split + whole:
        assert ("model" in rules.param_spec(k, params[k].ndim)) == (k in split), k
    if "fsdp" in name:
        assert all("data" in rules.param_spec(k, params[k].ndim) for k in split)


# ------------------------------ the collectives ------------------------------

def test_zero3_collectives_fake_group_equal_gloo_ranks(tmp_path):
    """deepseek's ZeRO-3 and tensor-parallel step on a fake (2, 2, 2) group
    on meta and on 8 gloo ranks on the CPU: the same collectives, among them
    the all-reduces over "model", the all-gathers of parameters over "data"
    and the reduce-scatters of their gradients."""
    from repro_torch.config import get_model_config
    args = {"cfg": get_model_config("deepseek-67b", smoke=True), "batch": (8, 64),
            "par": {"fsdp": True}}
    fake = harness.run_fake("record_step", dict(args, device="meta"), tmp_path / "fake.pt")
    real = harness.run_ranks("record_step", dict(args, device="cpu"), tmp_path / "real.pt")
    assert fake["collectives"] == real["collectives"]
    by = {(c[0], c[1]) for c in fake["collectives"]}
    assert {("all-reduce", ("model",)), ("all-gather", ("data",)),
            ("reduce-scatter", ("data",))} <= by, by
    for key in ("collective_bytes_per_device", "intra_pod_bytes_per_device", "by_kind"):
        assert fake["summary"][key] == real["summary"][key], key
