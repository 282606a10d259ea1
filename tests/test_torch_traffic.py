"""The port's training-traffic model and arch configs against the JAX
package's, on the same inputs:

  * ``ParallelConfig``'s fields, defaults and mesh helpers;
  * every arch's full and smoke ``ModelConfig`` (and its ``param_count`` /
    ``active_param_count``), and ``get_parallel_config`` over the ten archs
    x ``multi_pod`` x ``pod_compression``;
  * ``step_traffic``, ``iteration_profile``, ``training_workload(...).arrays()``,
    ``period_slots``, ``pp_stage_bytes`` and ``aicb_workload``: host-side
    Python over floats, so equal bit for bit;
  * the port's counterparts of ``tests/test_traffic.py``'s seven properties.

Nothing here builds a model: ``get_model_config`` is data for every arch,
and only ``build_model`` refuses an arch the port does not run.
"""
import dataclasses

import numpy as np
import pytest

from repro.config import base as jbase
from repro.config import registry as jreg
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import workload as jwork
from repro import traffic as jtraffic
from repro_torch.config import base as pbase
from repro_torch.config import registry as preg
from repro_torch.config.net import NetConfig
from repro_torch.netsim import workload as pwork
from repro_torch import traffic as ptraffic

ARCHS = jreg.list_archs()
TC = (256, 4096)


def _tc(base):
    return base.TrainConfig(global_batch=TC[0], seq_len=TC[1])


def test_archs_listed_as_jax():
    assert preg.list_archs() == ARCHS and len(ARCHS) == 10
    assert set(preg.ported_archs()) < set(ARCHS)


def test_parallel_config_matches_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(jbase.ParallelConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(pbase.ParallelConfig)]
    assert pf == jf
    for multi in (False, True):
        kw = dict(multi_pod=multi, pods=3, data=4, model=2)
        j, p = jbase.ParallelConfig(**kw), pbase.ParallelConfig(**kw)
        assert p.axis_names() == j.axis_names()
        assert p.mesh_shape() == j.mesh_shape()
        assert p.batch_axes() == j.batch_axes()
        assert p.num_devices == j.num_devices


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_config_matches_jax(arch, smoke):
    j = jreg.get_model_config(arch, smoke=smoke)
    p = preg.get_model_config(arch, smoke=smoke)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.param_count() == j.param_count()
    assert p.active_param_count() == j.active_param_count()
    assert p.layer_blocks() == j.layer_blocks()


@pytest.mark.parametrize("arch", ARCHS)
def test_parallel_config_of_each_arch_matches_jax(arch):
    for multi in (False, True):
        for comp in ("none", "int8"):
            j = jreg.get_parallel_config(arch, multi_pod=multi, pod_compression=comp)
            p = preg.get_parallel_config(arch, multi_pod=multi, pod_compression=comp)
            assert dataclasses.asdict(p) == dataclasses.asdict(j)
            assert p.num_devices == j.num_devices


@pytest.mark.parametrize("arch", ARCHS)
def test_traffic_matches_jax_bit_for_bit(arch):
    jm, pm = jreg.get_model_config(arch), preg.get_model_config(arch)
    for multi in (False, True):
        for comp in ("none", "int8"):
            for flat in (False, True):
                kw = dict(multi_pod=multi, pod_compression=comp,
                          hierarchical_allreduce=not flat)
                jp = jreg.get_parallel_config(arch, **kw)
                pp = preg.get_parallel_config(arch, **kw)
                jt = jtraffic.step_traffic(jm, jp, _tc(jbase))
                pt = ptraffic.step_traffic(pm, pp, _tc(pbase))
                assert dataclasses.asdict(pt) == dataclasses.asdict(jt)
                for overlap in (0.0, 0.5):
                    ji = jtraffic.iteration_profile(jm, jp, _tc(jbase), overlap_frac=overlap)
                    pi = ptraffic.iteration_profile(pm, pp, _tc(pbase), overlap_frac=overlap)
                    assert dataclasses.asdict(pi) == dataclasses.asdict(ji)
                ji = jtraffic.iteration_profile(jm, jp, _tc(jbase))
                pi = ptraffic.iteration_profile(pm, pp, _tc(pbase))
                assert ptraffic.period_slots(pi, NetConfig()) == \
                    jtraffic.period_slots(ji, JNetConfig())
    jp = jreg.get_parallel_config(arch, multi_pod=True)
    pp = preg.get_parallel_config(arch, multi_pod=True)
    for flows, intra in ((16, 8), (4, 0)):
        ja = jtraffic.training_workload(jm, jp, _tc(jbase), num_flows=flows,
                                        with_intra=intra).arrays()
        pa = ptraffic.training_workload(pm, pp, _tc(pbase), num_flows=flows,
                                        with_intra=intra).arrays()
        assert sorted(pa) == sorted(ja)
        for k in ja:
            assert np.array_equal(pa[k], ja[k]), k
            assert pa[k].dtype == ja[k].dtype, k
    for mb in (1, 8):
        assert ptraffic.pp_stage_bytes(pm, _tc(pbase), mb) == \
            jtraffic.pp_stage_bytes(jm, _tc(jbase), mb)


@pytest.mark.parametrize("jitter,seed", [(0.0, 0), (0.3, 0), (0.3, 7)])
def test_aicb_workload_matches_jax(jitter, seed):
    kw = dict(comm_bytes_per_iter=2.5e9, iter_us=8_000.0, comm_frac=0.25,
              num_flows=6, msg_size=1 << 20, concurrency=8, jitter=jitter, seed=seed)
    j, p = jwork.aicb_workload(**kw), pwork.aicb_workload(**kw)
    assert p.flows == tuple(pwork.FlowSpec(**dataclasses.asdict(f)) for f in j.flows)
    ja, pa = j.arrays(), p.arrays()
    for k in ja:
        assert np.array_equal(pa[k], ja[k]), k


# ---------------------------------------------------------------------------
# tests/test_traffic.py's properties, on the port
# ---------------------------------------------------------------------------

PTC = _tc(pbase)


def test_dp_bytes_formula():
    m = preg.get_model_config("qwen1.5-0.5b")
    t = ptraffic.step_traffic(m, preg.get_parallel_config("qwen1.5-0.5b"), PTC)
    assert abs(t.dp_grad_bytes - 2 * m.param_count() * 2) < 1e-3


def test_hierarchical_beats_flat_interpod():
    m = preg.get_model_config("deepseek-67b")
    p_h = pbase.ParallelConfig(multi_pod=True, hierarchical_allreduce=True, fsdp=True)
    p_f = pbase.ParallelConfig(multi_pod=True, hierarchical_allreduce=False, fsdp=True)
    assert (ptraffic.step_traffic(m, p_h, PTC).inter_pod_bytes
            < ptraffic.step_traffic(m, p_f, PTC).inter_pod_bytes / 100)


def test_compression_halves_interpod():
    m = preg.get_model_config("deepseek-67b")
    p = pbase.ParallelConfig(multi_pod=True, pod_compression="int8")
    p0 = pbase.ParallelConfig(multi_pod=True)
    assert (ptraffic.step_traffic(m, p, PTC).inter_pod_bytes
            == 0.5 * ptraffic.step_traffic(m, p0, PTC).inter_pod_bytes)


def test_moe_has_ep_bytes():
    m = preg.get_model_config("phi3.5-moe-42b-a6.6b")
    par = preg.get_parallel_config("phi3.5-moe-42b-a6.6b", multi_pod=True)
    assert ptraffic.step_traffic(m, par, PTC).ep_alltoall_bytes > 0
    dense = preg.get_model_config("deepseek-67b")
    td = ptraffic.step_traffic(dense, preg.get_parallel_config("deepseek-67b",
                                                               multi_pod=True), PTC)
    assert td.ep_alltoall_bytes == 0


def test_comm_frac_bounded():
    for arch in ("deepseek-67b", "mamba2-370m", "nemotron-4-340b"):
        t = ptraffic.step_traffic(preg.get_model_config(arch),
                                  preg.get_parallel_config(arch, multi_pod=True), PTC)
        assert 0.0 < t.comm_frac < 1.0


def test_iteration_profile_and_workload():
    m = preg.get_model_config("granite-moe-1b-a400m")
    par = preg.get_parallel_config("granite-moe-1b-a400m", multi_pod=True)
    prof = ptraffic.iteration_profile(m, par, PTC)
    assert prof.comm_us > 0 and prof.iter_us > prof.comm_us
    wl = ptraffic.training_workload(m, par, PTC, num_flows=8, with_intra=4)
    assert wl.num_flows == 12
    arrays = wl.arrays()
    assert arrays["is_inter"].sum() == 8
    assert (arrays["duty"][arrays["is_inter"] > 0] <= 1.0).all()


def test_pp_stage_bytes():
    m = preg.get_model_config("qwen1.5-0.5b")
    b = ptraffic.pp_stage_bytes(m, PTC, microbatches=8)
    expected = 2 * 8 * (256 * 4096 / 8) * m.d_model * 2
    assert abs(b - expected) < 1.0
