"""The port's sharded train step, resharding plans and the netsim's
``devices=`` against the JAX package's (CPU).

One ``make_train_step`` step on 8 gloo ranks of a (2, 2, 2) ("pod", "data",
"model") mesh, f32 smoke configs of qwen, mamba2, recurrentgemma and granite
(MoE, routed over the whole batch as GSPMD routes JAX's), against JAX's
``make_train_step`` on 8 forced host devices and against the port's
one-process ``train_step``, on the same weights and a batch with unevenly
masked rows: the loss within ``LOSS_TOL`` (1e-5), the grad norm within 1e-5
relative, every parameter after the AdamW step within 1% of the learning
rate (tests/test_torch_train.py's tolerances). AdamW's eps is 1e-3 here, not
1e-8: at the first step the update is lr * g / (|g| + eps), which with eps
1e-8 is lr * sign(g) wherever |g| > 1e-7 and jumps by up to lr where f32
summation noise flips a near-zero gradient between two summation orders (8
ranks against one); with eps 1e-3 the update is lr/eps-Lipschitz in g, so a
1e-7 gradient difference moves a parameter by 3e-7.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_mesh_harness as harness
from repro.config.base import ParallelConfig as JaxParallelConfig
from repro.train.elastic import resharding_plan as jax_resharding_plan
from repro_torch.config import ParallelConfig, TrainConfig, get_model_config
from repro_torch.models import build_model
from repro_torch.netsim import fluid as pfluid
from repro_torch.netsim import runner as prunner
from repro_torch.netsim import workload as pwork
from repro_torch.config.net import NetConfig, stack_net_params
from repro_torch.train import init_adam, resharding_plan, train_step

ARCHS = ["qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b", "granite-moe-1b-a400m"]
TRAIN = dict(global_batch=4, seq_len=64, lr=3e-3, warmup_steps=1, total_steps=3, eps=1e-3)
LOSS_TOL = 1e-5
NORM_REL_TOL = 1e-5
PARAM_TOL = 0.01 * TRAIN["lr"]

_JAX_STEP = """
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
    from test_torch_train_mesh import ARCHS, TRAIN, batch_np
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    par = ParallelConfig(multi_pod=True, pods=2, data=2, model=2)
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_model_config(arch, smoke=True), act_dtype="float32",
                                  param_dtype="float32")
        pcfg = dataclasses.replace(port_config(arch, smoke=True), act_dtype="float32",
                                   param_dtype="float32")
        model = build_model(cfg, remat="block")
        _, init_fn, jit_step, _ = make_train_step(model, par, TrainConfig(**TRAIN), mesh)
        params, opt = init_fn(jax.random.PRNGKey(0))
        toks, labels = batch_np(cfg.vocab_size)
        sd = params_from_jax(jax.tree.map(np.asarray, params), pcfg)   # before the donation
        out.update({f"{arch}|init|{k}": v.numpy() for k, v in sd.items()})
        with set_mesh(mesh):
            new, _, met = jit_step(params)(params, opt, {"tokens": jnp.asarray(toks),
                                                         "labels": jnp.asarray(labels)})
        sd = params_from_jax(jax.tree.map(np.asarray, new), pcfg)
        out.update({f"{arch}|new|{k}": v.numpy() for k, v in sd.items()})
        out.update({f"{arch}|metric|{k}": np.asarray(v) for k, v in met.items()})
    np.savez(OUT, **out)
"""


def batch_np(vocab: int):
    """Tokens and labels [4, 64]; rows masked unevenly, so that the loss's
    token count differs between the batch ranks."""
    toks = np.random.default_rng(0).integers(0, vocab, size=(4, 65)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, 3] = -1
    labels[2, 10:30] = -1
    return toks[:, :-1], labels


def _cfg(arch):
    return dataclasses.replace(get_model_config(arch, smoke=True), act_dtype="float32",
                               param_dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{arch: {"jax", "ranks", "one": {"metrics", "params"}}}."""
    d = tmp_path_factory.mktemp("train_mesh")
    ref = harness.run_jax(_JAX_STEP, d / "jax.npz")

    def part(arch, tag):
        pre = f"{arch}|{tag}|"
        return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}

    cases, out = {}, {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        state = {k: torch.from_numpy(v) for k, v in part(arch, "init").items()}
        toks, labels = batch_np(cfg.vocab_size)
        batch = {"tokens": torch.from_numpy(toks).long(),
                 "labels": torch.from_numpy(labels).long()}
        cases[arch] = (cfg, state, batch)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        opt = init_adam(dict(model.named_parameters()))
        _, metrics = train_step(model, opt, batch, ParallelConfig(), TrainConfig(**TRAIN))
        out[arch] = {"jax": {"metrics": {k: float(v) for k, v in part(arch, "metric").items()},
                             "params": part(arch, "new")},
                     "one": {"metrics": {k: float(v) for k, v in metrics.items()},
                             "params": {k: p.detach().numpy().copy()
                                        for k, p in model.named_parameters()}}}
    ranks = harness.run_ranks("train", {"cases": cases, "train": TRAIN}, d / "port.pt")
    for arch in ARCHS:
        out[arch]["ranks"] = {"metrics": ranks[arch]["metrics"],
                              "params": {k: v.numpy() for k, v in
                                         ranks[arch]["params"].items()}}
    return out


@pytest.mark.parametrize("against", ["jax", "one"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches(runs, arch, against):
    got, ref = runs[arch]["ranks"], runs[arch][against]
    gm, rm = got["metrics"], ref["metrics"]
    assert abs(gm["loss"] - rm["loss"]) <= LOSS_TOL, (gm, rm)
    assert abs(gm["ce"] - rm["ce"]) <= LOSS_TOL, (gm, rm)
    assert abs(gm["grad_norm"] - rm["grad_norm"]) <= NORM_REL_TOL * rm["grad_norm"], (gm, rm)
    assert gm["lr"] == pytest.approx(rm["lr"], rel=1e-7)
    assert set(got["params"]) == set(ref["params"])
    worst = max((float(np.abs(got["params"][k] - ref["params"][k]).max()), k)
                for k in ref["params"])
    assert worst[0] <= PARAM_TOL, worst


# ------------------------- the step on one rank -------------------------

def _one_rank_runs(arch, steps=2):
    """(metrics, params, moments) of ``steps`` steps of the plain
    ``train_step`` and of ``make_train_step`` on a 1 x 1 CPU mesh, from one
    seed: {"plain": ..., "mesh": ...}, and the mesh run's step object."""
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.train.train_step import make_train_step
    cfg = _cfg(arch)
    par, tc = ParallelConfig(data=1, model=1), TrainConfig(**TRAIN)
    toks, labels = batch_np(cfg.vocab_size)
    batch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}
    out = {}
    for how in ("plain", "mesh"):
        model = build_model(cfg, device="cpu")
        model.reset_parameters(torch.Generator().manual_seed(0))
        params = dict(model.named_parameters())
        opt = init_adam(params)
        hist = []
        if how == "mesh":
            _, _, jit_step, _ = make_train_step(model, par, tc, make_mesh_for(par, "cpu"))
            sstep = jit_step(params)
            params, opt = sstep.place(params, opt)
        for _ in range(steps):
            if how == "mesh":
                params, opt, m = sstep(params, opt, batch)
            else:
                opt, m = train_step(model, opt, batch, par, tc)
            hist.append({k: v.clone() for k, v in m.items()})
        moments = {k: (t.to_local() if how == "mesh" else t) for k, t in opt.m.items()}
        out[how] = (hist, {k: p.detach().clone() for k, p in model.named_parameters()},
                    moments)
        if how == "mesh":
            out["step"], out["model"], out["opt"] = sstep, model, opt
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_step_is_the_plain_step(arch):
    """On a mesh of one rank the step is ``train_step``'s arithmetic: the
    metrics, the parameters and the moments bit-equal after two steps."""
    runs = _one_rank_runs(arch)
    (hm, pm, mm), (hp, pp, mp) = runs["mesh"], runs["plain"]
    for a, b in zip(hm, hp):
        assert set(a) == set(b)
        for k in b:
            assert torch.equal(a[k], b[k]), k
    for k in pp:
        assert torch.equal(pm[k], pp[k]), k
        assert torch.equal(mm[k], mp[k]), k


def test_one_rank_mesh_step_copies_no_parameter():
    """On one rank the step updates the model's own parameters in place,
    and each moment's local shard is the whole moment: nothing is gathered."""
    from torch.distributed.tensor import DTensor
    runs = _one_rank_runs("qwen1.5-0.5b", steps=1)
    model, opt, sstep = runs["model"], runs["opt"], runs["step"]
    params = dict(model.named_parameters())
    ptrs = {k: p.data_ptr() for k, p in params.items()}
    toks, labels = batch_np(model.cfg.vocab_size)
    new, opt, _ = sstep(params, opt, {"tokens": torch.from_numpy(toks).long(),
                                      "labels": torch.from_numpy(labels).long()})
    assert all(new[k] is params[k] and new[k].data_ptr() == ptrs[k] for k in params)
    assert not any(sstep.split.values())
    for k, t in opt.m.items():
        assert isinstance(t, DTensor) and t.to_local().shape == params[k].shape


class _FakeMesh:
    """The ``DeviceMesh`` calls ``_shard_of`` makes, at one coordinate."""

    def __init__(self, shape, coord):
        self.shape, self.coord, self.ndim = shape, coord, len(shape)

    def size(self, m):
        return self.shape[m]

    def get_local_rank(self, m):
        return self.coord[m]


@pytest.mark.parametrize("spec,dims", [
    ((("pod", "data"), None), (0, 0, None)),       # the batch: rows over pod x data
    ((None, "model"), (None, None, 1)),            # a weight's columns over model
    (("data", "model"), (None, 0, 1)),             # fsdp rows and model columns
])
def test_shard_of_tiles_as_jax_places(spec, dims):
    """Over the 8 coordinates of a (2, 2, 2) mesh the shards tile the tensor
    as JAX places a spec: a tuple of axes splits one dim major to minor."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.train.train_step import _shard_of
    t = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    pls = [Replicate() if d is None else Shard(d) for d in dims]
    names = ("pod", "data", "model")
    for coord in np.ndindex(2, 2, 2):
        got = _shard_of(t, _FakeMesh((2, 2, 2), coord), pls)
        want = t
        for d, axes in enumerate(spec):
            axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
            k, n = 0, 1
            for a in axes:
                k, n = k * 2 + coord[names.index(a)], n * 2
            want = want.chunk(n, dim=d)[k]
        assert torch.equal(got, want), (coord, spec)


# ------------------------- resharding plans -------------------------

@pytest.mark.parametrize("kw", [
    dict(multi_pod=True, lost=dict(lost_pods=1)),
    dict(multi_pod=False, lost=dict(lost_data_rows=4)),
    dict(multi_pod=True, lost=dict(lost_data_rows=2, keep_global_batch=False)),
    dict(multi_pod=False, lost=dict(lost_data_rows=16)),
])
def test_resharding_plan_matches_jax(kw):
    """tests/test_train_substrate.py's cases (a pod lost; every data row
    lost, which raises) and two more."""
    def run(fn, par):
        try:
            return fn(par, **kw["lost"])
        except ValueError as e:
            return f"ValueError: {e}"
    got = run(resharding_plan, ParallelConfig(multi_pod=kw["multi_pod"]))
    want = run(jax_resharding_plan, JaxParallelConfig(multi_pod=kw["multi_pod"]))
    if isinstance(want, str):
        assert got == want
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ------------------------- the netsim over several devices -------------------------

@pytest.mark.parametrize("mode,n_cells,devices", [
    ("full", 3, 2), ("metrics", 4, 2), ("full", 2, 3),
])
def test_netsim_rows_over_devices_equal_one_device(mode, n_cells, devices):
    """A grid over several devices (padded to a device multiple) gives the
    one-device rows, in cell order, and the manifest counts the devices."""
    cfgs = [NetConfig(distance_km=d) for d in (10.0, 300.0, 700.0, 1000.0)[:n_cells]]
    wl = pwork.throughput_workload(1 << 20, 2, 2)
    one = prunner.run_experiment_batch(cfgs, wl, "dcqcn", 300.0, trace_mode=mode,
                                       device="cpu")
    many = prunner.run_experiment_batch(cfgs, wl, "dcqcn", 300.0, trace_mode=mode,
                                        devices=["cpu"] * devices)
    np.testing.assert_equal(many, one)     # bit for bit (nan where both are)


def test_netsim_manifest_counts_devices(tmp_path):
    from repro_torch.netsim.obs.profile import read_manifest
    path = str(tmp_path / "m.jsonl")
    prunner.sweep_grid([NetConfig(distance_km=10.0)] * 3, pwork.throughput_workload(1 << 20, 1, 2),
                       ("dcqcn",), 200.0, trace_mode="metrics", devices=["cpu", "cpu"],
                       manifest_path=path)
    header, launches = read_manifest(path)
    assert header["n_devices"] == 2 and launches[0]["pad_to"] == 4


@pytest.mark.parametrize("n_devices", [1, 2, 3])
def test_shard_scenario_axis(n_devices):
    cfgs = [NetConfig(distance_km=float(d)) for d in range(1, 5)]
    params = stack_net_params(cfgs, device="cpu")
    wlp = pwork.as_workload_batch(pwork.throughput_workload(1 << 20, 1, 2), 4)
    if n_devices == 1:
        assert pfluid.shard_scenario_axis(params, wlp, ["cpu"]) == (params, wlp)
    elif n_devices == 3:
        with pytest.raises(ValueError, match="3 devices do not evenly split a batch of 4"):
            pfluid.shard_scenario_axis(params, wlp, ["cpu"] * 3)
    else:
        parts = pfluid.shard_scenario_axis(params, wlp, ["cpu", "cpu"])
        assert len(parts) == 2
        for i, (p, w) in enumerate(parts):
            assert torch.equal(p.one_way_delay_us, params.one_way_delay_us[2 * i:2 * i + 2])
            np.testing.assert_array_equal(w.window, wlp.window[2 * i:2 * i + 2])
