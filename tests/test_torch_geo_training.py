"""``python -m repro_torch.launch.geo_training`` (the torch twin of
``examples/geo_training_sim.py``) on the CPU at a cut horizon: its rows
against the JAX package's ``run_experiment_batch`` of the same nets and the
same AICB workload (``torch_parity.assert_rows_close``, the Fig. 3 rows'
1e-3), the printed table and repair lines, and the arch guard: every arch's
traffic runs, only ``build_model`` (so ``launch.serve``) refuses the
unported archs' models."""
import json

import pytest

from repro.config import get_model_config as jget_model, get_parallel_config as jget_par
from repro.config.base import NetConfig as JNetConfig, TrainConfig as JTrainConfig
from repro.netsim import get_scheme as jget_scheme, run_experiment_batch as jrun
from repro.traffic import training_workload as jtraining_workload
from repro_torch.config import get_model_config, list_archs, ported_archs
from repro_torch.launch import geo_training
from torch_parity import assert_rows_close

H_US = 1_500.0
DISTANCES = (10.0, 1000.0)


def _jax_rows(arch, compress, scheme, lossy=False):
    wl = jtraining_workload(jget_model(arch), jget_par(arch, multi_pod=True,
                                                      pod_compression=compress),
                            JTrainConfig(global_batch=256, seq_len=4096), num_flows=16)
    if lossy:
        nets = [JNetConfig(distance_km=d, num_otn_links=3, loss_rate=lr, loss_burst_len=4.0)
                for d in DISTANCES for lr in geo_training.LOSS_RATES]
        return jrun(nets, wl, jget_scheme(scheme), H_US, trace_mode="metrics",
                    channel="bernoulli_loss")
    return jrun([JNetConfig(distance_km=d) for d in DISTANCES], wl, jget_scheme(scheme),
                H_US, trace_mode="metrics")


def test_geo_training_rows_match_jax(capsys):
    out = geo_training.main(["--device", "cpu", "--horizon-us", str(H_US), "--lossy",
                             "--distances-km", ",".join(str(d) for d in DISTANCES)])
    text = capsys.readouterr().out
    assert "=== deepseek-67b  pod_compression=int8 ===" in text
    assert "=== lossy long haul" in text
    for compress in ("none", "int8"):
        rows = out["training"][compress]["rows"]
        assert sorted(rows) == ["dcqcn", "matchrdma"]
        for scheme, prows in rows.items():
            assert_rows_close(prows, _jax_rows("deepseek-67b", compress, scheme),
                              metrics_mode=True, what=f"{compress}/{scheme}")
    # within the horizon the comm phase outlasts it under both compressions:
    # the same workload, so the same rows
    assert json.dumps(out["training"]["none"]["rows"]) == \
        json.dumps(out["training"]["int8"]["rows"])
    for scheme, prows in out["lossy"]["rows"].items():
        assert_rows_close(prows, _jax_rows("deepseek-67b", "none", scheme, lossy=True),
                          metrics_mode=True, what=f"lossy/{scheme}")
    n_lines = text.count("sdr_rdma repairs")
    assert n_lines == len(out["lossy"]["repair_speedup"]) and n_lines > 0
    assert [r["cells"] for r in out["runs"]] == [2, 2, 2, 2, 6, 6]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_geo_training_runs_every_arch_of_the_registry(arch):
    """The traffic model needs an arch's config only: a model the port does
    not build (and an MoE one) still gives its training traffic."""
    assert arch not in ported_archs() and arch in list_archs()
    out = geo_training.main(["--arch", arch, "--device", "cpu", "--horizon-us", "600",
                             "--distances-km", "10", "--schemes", "dcqcn"])
    rows = out["training"]["none"]["rows"]["dcqcn"]
    assert len(rows) == 1 and rows[0]["throughput_gbps"] > 0


def test_unported_models_refused_by_build_model_and_serve():
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    for arch in sorted(set(list_archs()) - set(ported_archs())):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3"):
            build_model(get_model_config(arch), device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3"):
        serve.build("deepseek-67b", device="cpu")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "deepseek-67b", "--device", "cpu"])
