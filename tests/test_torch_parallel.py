"""The port's parallel layer against the JAX package's (CPU): sharding
specs of every parameter and cache leaf, the divisibility invariants, int8
compression with error feedback, and on 8 gloo ranks of a (2, 2, 2) mesh
the hierarchical all-reduce (against JAX on 8 forced host devices) and the
grouped MoE under the mesh.

Tolerances: specs and int8 payloads equal; the all-reduce within 1e-6 of
JAX's (f32 sums of a few ranks in another order); the grouped MoE within
1e-5 of the flat dispatch (tests/test_parallel.py's limit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from _hypo import given, settings, st

import torch_mesh_harness as harness
from repro.config import get_model_config as jax_get_model_config
from repro.config import get_parallel_config as jax_get_parallel_config
from repro.models import build_model as jax_build_model
from repro.models.transformer import init_caches as jax_init_caches
from repro.parallel import compression as jcomp
from repro.parallel.sharding import ShardingRules as JaxShardingRules
from repro_torch.config import get_model_config, get_parallel_config, list_archs
from repro_torch.models import build_model
from repro_torch.parallel import (
    P, ShardingRules, compress_with_feedback, dequantize_int8, inter_pod_bytes_per_step,
    placements, quantize_int8,
)
from repro_torch.serve.kvcache import cache_shape_specs, cache_shardings

from repro.parallel.collectives import inter_pod_bytes_per_step as jax_inter_pod_bytes


def _jax_paths(tree, prefix=""):
    """(path, leaf) of a JAX spec tree, '/'-joined as JAX's rules walk it."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, JP):
        for i, v in enumerate(tree):
            yield from _jax_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _unstacked(cfg, jax_specs, top: str):
    """The port's leaf name -> JAX's spec without the layer-stack lead, as
    ``convert.params_from_jax`` unstacks the groups (``top``: "backbone."
    for params, "" for caches)."""
    pat = cfg.block_pattern or ((None, None),)
    n_groups = cfg.num_layers // len(pat)
    out = {}
    for path, spec in _jax_paths(jax_specs):
        parts = path.strip("/").split("/")
        if "groups" in parts:
            k = parts.index("groups")
            i, rest = int(parts[k + 1]), ".".join(parts[k + 2:])
            assert spec[0] is None, (path, spec)
            for g in range(n_groups):
                out[f"{top}layers.{g * len(pat) + i}.{rest}" if top
                    else f"{g * len(pat) + i}.{rest}"] = tuple(spec)[1:]
        elif "rem" in parts:
            k = parts.index("rem")
            j, rest = int(parts[k + 1]), ".".join(parts[k + 2:])
            n = n_groups * len(pat) + j
            out[f"{top}layers.{n}.{rest}" if top else f"{n}.{rest}"] = tuple(spec)
        else:
            out[".".join(parts)] = tuple(spec)
    return out


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_specs_match_jax(arch, multi_pod):
    """Every parameter's spec is JAX's spec of its counterpart, and every
    sharded dim divides by its mesh axes (the dry run's invariant)."""
    jcfg = jax_get_model_config(arch)
    jpar = jax_get_parallel_config(arch, multi_pod=multi_pod)
    jparams = jax.eval_shape(lambda: jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    jspecs = JaxShardingRules(jcfg, jpar).params_tree_specs(jparams)
    cfg, par = get_model_config(arch), get_parallel_config(arch, multi_pod=multi_pod)
    model = build_model(cfg, device="meta")
    rules = ShardingRules(cfg, par)
    params = dict(model.named_parameters())
    specs = rules.params_tree_specs(params)
    want = _unstacked(cfg, jspecs, "backbone.")
    assert set(specs) == set(want)
    sizes = {"pod": par.pods, "data": par.data, "model": par.model}
    for name, spec in specs.items():
        assert isinstance(spec, P) and tuple(spec) == want[name], (name, spec, want[name])
        for dim, ax in enumerate(spec):
            if ax is not None:
                total = int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
                assert params[name].shape[dim] % total == 0, (name, spec)


@pytest.mark.parametrize("arch", ["deepseek-67b", "recurrentgemma-2b", "mamba2-370m",
                                  "qwen1.5-0.5b"])
def test_cache_specs_match_jax(arch):
    jcfg = jax_get_model_config(arch)
    jpar = jax_get_parallel_config(arch, multi_pod=False)
    jcaches = jax.eval_shape(lambda: jax_init_caches(jcfg, 128, 32768, jnp.bfloat16))
    want = _unstacked(jcfg, JaxShardingRules(jcfg, jpar).cache_tree_specs(jcaches), "")
    cfg, par = get_model_config(arch), get_parallel_config(arch, multi_pod=False)
    caches = cache_shape_specs(cfg, 128, 32768)
    assert all(t.device.type == "meta" for c in caches for t in c.values())
    specs = ShardingRules(cfg, par).cache_tree_specs(caches)
    sizes = {"pod": par.pods, "data": par.data, "model": par.model}
    got = {f"{i}.{k}": (s, caches[i][k]) for i, c in enumerate(specs) for k, s in c.items()}
    assert set(got) == set(want)
    for name, (spec, t) in got.items():
        assert tuple(spec) == want[name], (name, spec, want[name])
        for dim, ax in enumerate(spec):
            if ax is not None:
                total = int(np.prod([sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,))]))
                assert t.shape[dim] % total == 0, (name, spec, tuple(t.shape))


def test_placements_of_specs():
    """A spec on a mesh: Shard of the tensor dim on each named mesh dim (a
    dim split over several, major first), Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert placements(Mesh, P(("pod", "data"), None, "model")) == (Shard(0), Shard(0), Shard(2))
    assert placements(Mesh, P(None, "data")) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        placements(Mesh, P(("data", "pod")))
    cfg, par = get_model_config("qwen1.5-0.5b"), get_parallel_config("qwen1.5-0.5b")
    sh, spec = cache_shardings(cfg, par, Mesh, 4, 64)
    assert sh[0]["k"].placements == placements(Mesh, spec[0]["k"])


@pytest.mark.parametrize("kw", [dict(), dict(compress=True), dict(pods=4, bytes_per_el=4)])
def test_inter_pod_bytes_match_jax(kw):
    assert inter_pod_bytes_per_step(123_456_789, **kw) == jax_inter_pod_bytes(123_456_789, **kw)


# ------------------------- compression -------------------------

@pytest.mark.parametrize("seed,n", [(0, 3), (1, 2048), (2, 2049), (3, 5000), (4, 70_001)])
def test_int8_payloads_bit_equal_jax(seed, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10).astype(np.float32)
    err = (rng.standard_normal(n) * 0.05).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        dequantize_int8(q, s, (n,), torch.float32).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, (n,), jnp.float32)))
    jq2, js2, jerr = jcomp.compress_with_feedback(jnp.asarray(x), jnp.asarray(err))
    q2, s2, terr = compress_with_feedback(torch.from_numpy(x), torch.from_numpy(err))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(js2))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 5), st.integers(3, 4000))
def test_quantize_roundtrip_error_bound(seed, n):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 10)
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale, x.shape, torch.float32) - x).abs()
    assert float(err.max()) <= float(scale.max()) / 2 + 1e-6


def test_error_feedback_accumulates_residual():
    x = torch.from_numpy(np.linspace(-1, 1, 100).astype(np.float32))
    q, scale, err2 = compress_with_feedback(x, torch.zeros_like(x))
    torch.testing.assert_close(err2, x - dequantize_int8(q, scale, x.shape, torch.float32),
                               atol=1e-6, rtol=0)


def test_error_feedback_unbiased_over_time():
    """Compressing the same gradient with error feedback recovers it in the
    long-run average (the EF guarantee); without the residual it does not."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(256).astype(np.float32))
    for carried in (True, False):
        err, total = torch.zeros_like(g), torch.zeros_like(g)
        for _ in range(50):
            q, scale, new_err = compress_with_feedback(g, err)
            err = new_err if carried else torch.zeros_like(g)
            total += dequantize_int8(q, scale, g.shape, torch.float32)
        assert (float((total / 50 - g).abs().max()) < 5e-3) == carried


# ------------------------- 8 ranks -------------------------

_JAX_HIER = """
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.parallel import make_hierarchical_allreduce
    from repro.parallel.compat import make_mesh, set_mesh
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    g = {"a": jnp.arange(37, dtype=jnp.float32) * 0.1,
         "b": jnp.ones((5, 3), jnp.bfloat16)}
    errs = jax.tree.map(lambda x: jnp.zeros_like(x, dtype=jnp.float32), g)
    with set_mesh(mesh):
        out, _ = jax.jit(make_hierarchical_allreduce(mesh))(g, errs)
        outc, ne = jax.jit(make_hierarchical_allreduce(mesh, compress=True))(g, errs)
    f = lambda x: np.asarray(jnp.asarray(x, jnp.float32))
    np.savez(OUT, a=f(out["a"]), b=f(out["b"]), ca=f(outc["a"]), cb=f(outc["b"]),
             ea=f(ne["a"]), eb=f(ne["b"]), ga=f(g["a"]))
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 8-rank jobs' results and the JAX reference of the all-reduce."""
    d = tmp_path_factory.mktemp("mesh")
    ref = harness.run_jax(_JAX_HIER, d / "jax.npz")
    g = {"a": torch.from_numpy(ref["ga"]), "b": torch.ones((5, 3), dtype=torch.bfloat16)}
    return ref, harness.run_ranks("all", {"g": g}, d / "port.pt")


@pytest.mark.parametrize("case", ["plain", "compressed"])
def test_hierarchical_allreduce_matches_jax(ranks, case):
    ref, res = ranks
    out = res["hierarchical"][case]
    pre = "" if case == "plain" else "c"
    assert out["b"].dtype == torch.bfloat16 and out["a"].dtype == torch.float32
    for k in ("a", "b"):
        np.testing.assert_allclose(out[k].float().numpy(), ref[pre + k], rtol=0, atol=1e-6)
    if case == "plain":
        np.testing.assert_allclose(out["a"].numpy(), ref["ga"], rtol=0, atol=1e-6)
    else:
        rel = np.abs(out["a"].numpy() - ref["ga"]).max() / np.abs(ref["ga"]).max()
        assert rel < 0.02, rel
        for k in ("a", "b"):
            np.testing.assert_allclose(res["hierarchical"]["err"][k].numpy(), ref["e" + k],
                                       rtol=0, atol=1e-6)


def test_grouped_moe_under_the_mesh_matches_flat(ranks):
    r = ranks[1]["grouped_moe"]
    assert float((r["y_flat"] - r["y_grouped"]).abs().max()) < 1e-5
    assert r["aux"]["moe_drop_frac"] == 0.0
