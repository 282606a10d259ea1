"""The port's dry run against the JAX package's (CPU): the shape grid,
``RunConfig`` fingerprints, the input, parameter and optimizer specs of
every arch x applicable shape x mesh at full width (shapes, dtypes,
partition specs and each leaf's per-rank shard), and ``run_cell`` end to end
on a fake group of the production mesh (in a subprocess).

Token ids and labels are int64 in the port (``models.model``), int32 in
JAX: that is the one dtype the comparison maps. Everything else is equal.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as JP

from repro import config as jconfig
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build_model
from repro_torch import config
from repro_torch.config import TrainConfig, get_model_config, get_parallel_config, list_archs
from repro_torch.launch import specs
from repro_torch.models import build_model
from test_torch_parallel import _jax_paths

ROOT = Path(__file__).resolve().parents[1]
MESHES = (False, True)
CELLS = [(a, s, mp) for a in list_archs() for s in config.SHAPES for mp in MESHES
         if config.shape_applicable(get_model_config(a), config.SHAPES[s])]


def _norm(spec) -> tuple:
    """A spec as a tuple, one-name tuple entries as the name (the port's P)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _by_port_name(cfg, tree, top: str) -> dict:
    """Port leaf name -> (JAX leaf, whether it has the layer-stack lead dim),
    as ``convert.params_from_jax`` unstacks the groups."""
    pat = cfg.block_pattern or ((None, None),)
    n_groups = cfg.num_layers // len(pat)
    out = {}
    for path, leaf in _jax_paths(tree):
        parts = path.strip("/").split("/")
        if "groups" in parts:
            k = parts.index("groups")
            i, rest = int(parts[k + 1]), ".".join(parts[k + 2:])
            for g in range(n_groups):
                out[f"{top}layers.{g * len(pat) + i}.{rest}" if top
                    else f"{g * len(pat) + i}.{rest}"] = (leaf, True)
        elif "rem" in parts:
            k = parts.index("rem")
            j, rest = int(parts[k + 1]), ".".join(parts[k + 2:])
            n = n_groups * len(pat) + j
            out[f"{top}layers.{n}.{rest}" if top else f"{n}.{rest}"] = (leaf, False)
        else:
            out[".".join(parts)] = (leaf, False)
    return out


def _dtype(jax_dtype) -> torch.dtype:
    name = jnp.dtype(jax_dtype).name
    return torch.int64 if name == "int32" else getattr(torch, name)


def _check_leaf(name, t, spec, jleaf, jspec, lead, par):
    """Shape, dtype, spec and per-rank shard of one leaf against JAX's."""
    jshape = tuple(jleaf.shape)
    assert tuple(t.shape) == (jshape[1:] if lead else jshape), name
    assert t.dtype == _dtype(jleaf.dtype), (name, t.dtype, jleaf.dtype)
    want = _norm(jspec)[1:] if lead else _norm(jspec)
    assert _norm(spec) == want, (name, spec, want)
    mesh = AbstractMesh(par.mesh_shape(), par.axis_names())
    shard = NamedSharding(mesh, JP(*jspec)).shard_shape(jshape)
    got = specs.shard_shape(tuple(t.shape), spec, specs.mesh_sizes(par))
    assert got == (shard[1:] if lead else shard), (name, got, shard)


def _check_tree(cfg, par, tree, spec_tree, jtree, jspec_tree, top):
    got = {f"{i}.{k}": (t, spec_tree[i][k]) for i, c in enumerate(tree)
           for k, t in c.items()} if isinstance(tree, list) else \
        {k: (t, spec_tree[k]) for k, t in tree.items()}
    leaves, jspec_leaves = _by_port_name(cfg, jtree, top), _by_port_name(cfg, jspec_tree, top)
    assert set(got) == set(leaves)
    for name, (t, spec) in got.items():
        jleaf, lead = leaves[name]
        _check_leaf(name, t, spec, jleaf, jspec_leaves[name][0], lead, par)


def _configs(arch, multi_pod):
    return (get_model_config(arch), get_parallel_config(arch, multi_pod=multi_pod),
            jconfig.get_model_config(arch), jconfig.get_parallel_config(arch, multi_pod=multi_pod))


# ---------------------------------------------------------------------------
# The grid and the configs
# ---------------------------------------------------------------------------

def test_shapes_and_applicability_match_jax():
    assert {k: vars(v) for k, v in config.SHAPES.items()} == \
        {k: vars(v) for k, v in jconfig.SHAPES.items()}
    for arch in list_archs():
        for name in config.SHAPES:
            assert config.shape_applicable(get_model_config(arch), config.SHAPES[name]) == \
                jconfig.shape_applicable(jconfig.get_model_config(arch), jconfig.SHAPES[name])
    assert sum(1 for a, s, mp in CELLS if not mp) == 32    # 10 x 3 + the two sub-quadratic


@pytest.mark.parametrize("arch", list_archs())
def test_run_config_fingerprint_matches_jax(arch):
    from repro.config.base import TrainConfig as JTrainConfig
    ours = config.RunConfig(get_model_config(arch), get_parallel_config(arch, multi_pod=True),
                            TrainConfig(ckpt_dir="ckpt"))
    theirs = jconfig.RunConfig(jconfig.get_model_config(arch),
                               jconfig.get_parallel_config(arch, multi_pod=True),
                               JTrainConfig(ckpt_dir="ckpt"))
    assert ours.fingerprint() == theirs.fingerprint()
    assert config.RunConfig(get_model_config(arch)).fingerprint() != ours.fingerprint()


# ---------------------------------------------------------------------------
# Specs, at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape_name,multi_pod", CELLS)
def test_input_specs_match_jax(arch, shape_name, multi_pod):
    cfg, par, jcfg, jpar = _configs(arch, multi_pod)
    shape, jshape = config.SHAPES[shape_name], jconfig.SHAPES[shape_name]
    if shape.kind == "train":
        got, got_p = specs.train_input_specs(cfg, par, shape)
        want, want_p = jspecs.train_input_specs(jcfg, jpar, jshape)
        assert set(got) == set(want) == set(got_p) == set(want_p)
        for k in got:
            _check_leaf(k, got[k], got_p[k], want[k], want_p[k], False, par)
    elif shape.kind == "prefill":
        t, p = specs.prefill_input_specs(cfg, par, shape)
        jt, jp = jspecs.prefill_input_specs(jcfg, jpar, jshape)
        _check_leaf("inputs", t, p, jt, jp, False, par)
    else:
        cache, cache_p, inp, inp_p, pos = specs.decode_input_specs(cfg, par, shape)
        jcache, jcache_p, jinp, jinp_p, jpos = jspecs.decode_input_specs(jcfg, jpar, jshape)
        assert all(t.device.type == "meta" for c in cache for t in c.values())
        _check_tree(cfg, par, cache, cache_p, jcache, jcache_p, "")
        _check_leaf("inputs", inp, inp_p, jinp, jinp_p, False, par)
        assert tuple(pos.shape) == tuple(jpos.shape) == () and pos.dtype == _dtype(jpos.dtype)


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("multi_pod", MESHES)
def test_params_and_opt_specs_match_jax(arch, multi_pod):
    cfg, par, jcfg, jpar = _configs(arch, multi_pod)
    params, params_p, opt, opt_p = specs.params_and_opt_specs(build_model(cfg, device="meta"), par)
    jparams, jparams_p, jopt, jopt_p = jspecs.params_and_opt_specs(jax_build_model(jcfg), jpar)
    assert all(t.device.type == "meta" for t in params.values())
    _check_tree(cfg, par, params, params_p, jparams, jparams_p, "backbone.")
    assert tuple(opt_p.step) == tuple(jopt_p.step) == ()
    for which in ("m", "v"):
        _check_tree(cfg, par, getattr(opt, which), getattr(opt_p, which),
                    getattr(jopt, which), getattr(jopt_p, which), "backbone.")
        assert getattr(opt_p, which) is params_p


def test_tree_bytes_of_shards():
    cfg, par = get_model_config("qwen1.5-0.5b"), get_parallel_config("qwen1.5-0.5b")
    params, params_p, _, _ = specs.params_and_opt_specs(build_model(cfg, device="meta"), par,
                                                        with_opt=False)
    whole = specs.tree_bytes(params)
    assert whole == 2 * cfg.param_count()
    shards = specs.tree_bytes(params, params_p, specs.mesh_sizes(par))
    # every "model"-split leaf holds a sixteenth a rank; the norms stay whole
    assert whole / 16 < shards < whole / 8


# ---------------------------------------------------------------------------
# run_cell on the production mesh (fake groups, each run in a subprocess)
# ---------------------------------------------------------------------------

JAX_KEYS = {"arch", "shape", "mesh", "chips", "kind", "params", "active_params", "status"}
OK_KEYS = JAX_KEYS | {
    "model_flops", "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
    "generated_code_size_in_bytes", "alias_size_in_bytes", "cost_analysis",
    "collective_bytes_per_device", "inter_pod_bytes_per_device", "intra_pod_bytes_per_device",
    "by_kind", "num_collectives", "hlo_dot_flops_per_device", "hlo_hbm_bytes_per_device",
    "roofline", "lower_s", "compile_s",
    # the port's own
    "argument_size_in_bytes_under_rules", "params_init", "peak_bytes", "kernel_ops",
    "op_breakdown", "tensor_parallel"}

_RUN_CELLS = """
import json, sys
from repro_torch.launch.dryrun import run_cell
cells = [("qwen1.5-0.5b", "train_4k", True), ("mamba2-370m", "long_500k", False),
         ("qwen1.5-0.5b", "long_500k", False), ("qwen1.5-0.5b", "decode_32k", False),
         ("deepseek-67b", "decode_32k", True)]
print(json.dumps([run_cell(a, s, mp, "cpu") for a, s, mp in cells]))
"""


@pytest.fixture(scope="module")
def cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _RUN_CELLS], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _finite_positive(*xs):
    return all(np.isfinite(x) and x > 0 for x in xs)


def test_run_cell_train_multi_pod(cells):
    """qwen train_4k on 2 x 16 x 16: every key, positive and finite counts,
    and the collectives the port's split step makes: each rank's bf16
    gradient shards all-reduced over "pod" (2 ranks: r bytes a rank) and
    "data" (16), the norm's f32 sums over all 512 ranks, the activations'
    all-reduces over "model" (16), counted exactly, and no parameter
    gathered. Each rank
    holds the rules' shards, so its arguments are the rules'."""
    c = cells[0]
    assert c["status"] == "OK" and set(c) == OK_KEYS, set(c) ^ OK_KEYS
    cfg, par = get_model_config("qwen1.5-0.5b"), get_parallel_config("qwen1.5-0.5b",
                                                                      multi_pod=True)
    assert (c["chips"], c["mesh"], c["tensor_parallel"]) == (512, "2x16x16", True)
    assert _finite_positive(c["hlo_dot_flops_per_device"], c["hlo_hbm_bytes_per_device"],
                            c["peak_bytes"], c["temp_size_in_bytes"], c["model_flops"],
                            c["inter_pod_bytes_per_device"], c["intra_pod_bytes_per_device"])
    params, params_p, _, _ = specs.params_and_opt_specs(build_model(cfg, device="meta"), par,
                                                        with_opt=False)
    grads = specs.tree_bytes(params, params_p, specs.mesh_sizes(par))   # this rank's shards
    assert c["params_init"] == c["params"] == cfg.param_count()
    assert 0 <= c["inter_pod_bytes_per_device"] - grads < 1e3        # + the norm's sums
    assert set(c["by_kind"]) == {"all-reduce"}
    # over "model", bf16 activations of this rank's 8 rows: per layer the
    # attention's and the MLP's row-parallel outputs in the forward, the
    # attention's again in the block's recompute (which stops at the last
    # tensor the backward needs, before the MLP's), the gradients of the two
    # column-parallel inputs in the backward; the embedding's lookup; the
    # loss's hidden states' gradient; and the CE's three f32 per-token
    # reductions in the forward and the chunk's recompute
    b, s = 256 // 32, 4096
    act = b * s * cfg.d_model * 2
    over_model = 2 * 15 / 16 * (act * (5 * cfg.num_layers + 1) + act + 6 * b * s * 4)
    over_data = 2 * 15 / 16 * (grads + 8)            # + the loss's token sum and count
    assert c["intra_pod_bytes_per_device"] == pytest.approx(over_data + over_model, rel=1e-12)
    # 8 rows a rank (256 / 32), block remat: each attention layer's kernel
    # runs in the forward and again in the recompute
    assert c["kernel_ops"]["flash_attention"]["calls"] == 2 * cfg.num_layers
    assert c["argument_size_in_bytes"] == c["argument_size_in_bytes_under_rules"]
    assert c["roofline"]["dominant"] in ("compute", "memory", "collective")


def test_run_cell_long_decode(cells):
    """mamba2 long_500k on 16 x 16 (one row, replicated over "data"): the
    decode step on the split model, its collectives over "model" counted
    exactly: per layer the gated norm's sum of squares and the row-parallel
    output all-reduced, and the conv window's channels and the SSD state's
    heads all-gathered into the whole state (the rules' layout). The vocab
    (50,280) does not divide over 16, so the table is whole."""
    c = cells[1]
    assert c["status"] == "OK" and set(c) == OK_KEYS, set(c) ^ OK_KEYS
    assert c["tensor_parallel"] is True
    assert c["argument_size_in_bytes"] == c["argument_size_in_bytes_under_rules"]
    assert _finite_positive(c["hlo_dot_flops_per_device"], c["hlo_hbm_bytes_per_device"],
                            c["peak_bytes"])
    # mamba2's config counts a parameter set of its own (the init's differs)
    assert c["params"] == get_model_config("mamba2-370m").param_count() != c["params_init"]
    assert c["model_flops"] == 2.0 * c["active_params"]
    assert "ssd_scan" not in c["kernel_ops"]      # decode is the recurrent step
    cfg, m = get_model_config("mamba2-370m"), 16
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_headdim
    reduce = 4 + cfg.d_model * 2                 # f32 [1, 1, 1], bf16 [1, 1, d]
    gather = (cfg.ssm_conv - 1) * d_in * 2 + heads * cfg.ssm_state * cfg.ssm_headdim * 4
    assert c["by_kind"] == pytest.approx({
        "all-reduce": cfg.num_layers * 2 * reduce * (m - 1) / m,
        "all-gather": cfg.num_layers * gather * (m - 1) / m}, rel=1e-12)
    assert c["inter_pod_bytes_per_device"] == 0.0


@pytest.mark.parametrize("i", [3, 4], ids=["qwen decode_32k 16x16",
                                            "deepseek decode_32k 2x16x16"])
def test_run_cell_serve_runs_on_the_split_model(cells, i):
    """A serve cell runs on the model split by the rules: each rank's
    arguments are exactly the rules' shards of the parameters, the caches
    (qwen's kv heads split over "model"; deepseek's 8 kv heads do not divide
    16, so its K/V are split along the sequence) and the inputs; deepseek's
    parameters are gathered over "data" (``fsdp``); each rank needs under
    80 GB."""
    c = cells[i]
    assert c["status"] == "OK" and set(c) == OK_KEYS, set(c) ^ OK_KEYS
    assert c["tensor_parallel"] is True
    assert c["argument_size_in_bytes"] == c["argument_size_in_bytes_under_rules"]
    assert _finite_positive(c["peak_bytes"], c["intra_pod_bytes_per_device"])
    assert c["peak_bytes"] < 80e9
    assert "all-gather" in c["by_kind"] and "all-reduce" in c["by_kind"]


def test_run_cell_skips_full_attention_at_500k(cells):
    c = cells[2]
    assert c["status"] == "SKIP(full-attention)" and set(c) == JAX_KEYS | {"tensor_parallel"}


def test_importing_the_dry_run_creates_no_process_group():
    code = ("import torch.distributed as dist, repro_torch.launch.dryrun, "
            "repro_torch.launch.op_analysis; print(dist.is_initialized())")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr[-2000:]


def test_production_mesh_refuses_a_launched_group_of_another_size(tmp_path):
    code = textwrap.dedent("""
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_production_mesh
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        try:
            make_production_mesh(device="cpu")
        except RuntimeError as e:
            print("raised", "launched" in str(e))
        dist.destroy_process_group()
        m = make_production_mesh(multi_pod=True, device="cpu")
        m2 = make_production_mesh(device="cpu")      # a fake group of another size: replaced
        print(tuple(m.mesh.shape), m.mesh_dim_names, tuple(m2.mesh.shape), dist.get_world_size())
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[:2] == [
        "raised True", "(2, 16, 16) ('pod', 'data', 'model') (16, 16) 256"]
