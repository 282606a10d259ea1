"""The port's run manifests and timelines against the JAX package's:

  * ``write_manifest`` / ``read_manifest`` round trip (non-finite floats and
    numpy scalars as the JAX package writes them);
  * ``tools/obs_report.py``, run as it is (a subprocess), summarizes and
    diffs a port manifest, and diffs a JAX manifest against a port manifest
    of the same plan (every launch matched);
  * a resumed launch is recorded as ``resumed``, as in JAX;
  * the Perfetto document of the port's exporter equals JAX's from the same
    arrays (window rings and event rings, full-mode traces).
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import repro.netsim as jnetsim
from repro.config.base import NetConfig as JNetConfig
from repro.netsim import fluid as jfl
from repro.netsim import workload as jwork
from repro.netsim.obs import profile as jprof
from repro.netsim.obs import timeline as jtl
from repro_torch.config.net import NetConfig
from repro_torch.netsim import runner as prunner
from repro_torch.netsim import workload as pwork
from repro_torch.netsim.obs import profile as pprof
from repro_torch.netsim.obs import timeline as ptl

ROOT = Path(__file__).resolve().parents[1]
H_US = 400.0


def _obs_report(*args):
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "obs_report.py"), *args],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _grid(netconfig, work):
    cfgs = [netconfig(distance_km=d) for d in (50.0, 300.0, 1000.0)]
    return cfgs, work.throughput_workload(1 << 20, 1, 2)


def _sweep(path, **kw):
    cfgs, wl = _grid(NetConfig, pwork)
    return prunner.sweep_grid(cfgs, wl, ("dcqcn", "matchrdma"), H_US, trace_mode="metrics",
                              chunk_cells=2, manifest_path=str(path), device="cpu", **kw)


def test_manifest_roundtrip_as_jax(tmp_path):
    header = {"fingerprint": "abc", "n": np.int64(3), "x": float("nan")}
    launches = [{"scheme": "dcqcn", "lo": 0, "hi": 2, "execute_s": np.float32(0.5),
                 "inf": float("inf"), "nested": {"a": (1, 2)}}]
    pprof.write_manifest(str(tmp_path / "p.jsonl"), dict(header, git_rev="r", timestamp="t"),
                         launches)
    jprof.write_manifest(str(tmp_path / "j.jsonl"), dict(header, git_rev="r", timestamp="t"),
                         launches)
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert pprof.read_manifest(str(tmp_path / "p.jsonl")) == \
        jprof.read_manifest(str(tmp_path / "j.jsonl"))
    head, recs = pprof.read_manifest(str(tmp_path / "p.jsonl"))
    assert head["record"] == "header" and head["manifest_version"] == pprof.MANIFEST_VERSION
    assert recs[0]["record"] == "launch" and recs[0]["inf"] == "inf"


def test_port_manifest_through_obs_report(tmp_path):
    path = tmp_path / "m.jsonl"
    rows = _sweep(path)
    head, recs = pprof.read_manifest(str(path))
    assert len(rows) == 6 and head["n_launches"] == len(recs) == 4
    assert head["backend"] == "cpu" and head["n_devices"] == 1
    assert head["trace_mode"] == "metrics" and head["n_cells"] == 3
    assert [(r["scheme"], r["lo"], r["hi"]) for r in recs] == [
        ("dcqcn", 0, 2), ("dcqcn", 2, 3), ("matchrdma", 0, 2), ("matchrdma", 2, 3)]
    for r in recs:
        assert r["compile_s"] == 0.0 and r["compile_cached"] is False
        assert r["execute_s"] > 0 and r["backend"] == "cpu"
        assert "temp_size_in_bytes" not in r          # device figures: card only
    summary = _obs_report("summarize", str(path))
    assert "totals:" in summary and "backend        cpu" in summary
    assert "matched launches: 4 (only-old: 0, only-new: 0)" in _obs_report(
        "diff", str(path), str(path))


def test_jax_and_port_manifests_of_one_plan_diff(tmp_path):
    """The same plan (grid, workload, horizon, modes, schemes) in both
    packages: obs_report matches every launch, and the fingerprints are the
    same digest of the same plan."""
    _sweep(tmp_path / "p.jsonl")
    cfgs, wl = _grid(JNetConfig, jwork)
    jnetsim.sweep_grid(cfgs, wl, ("dcqcn", "matchrdma"), H_US, trace_mode="metrics",
                       chunk_cells=2, manifest_path=str(tmp_path / "j.jsonl"))
    (jh, jl), (ph, pl) = (pprof.read_manifest(str(tmp_path / n)) for n in ("j.jsonl", "p.jsonl"))
    assert [(r["scheme"], r["lo"], r["hi"], r["pad_to"], r["n_real"]) for r in pl] == \
        [(r["scheme"], r["lo"], r["hi"], r["pad_to"], r["n_real"]) for r in jl]
    for k in ("trace_mode", "decimate", "horizon_us", "steps", "warm_steps", "n_cells",
              "schemes", "n_launches", "n_resumed", "manifest_version"):
        assert ph[k] == jh[k], k
    out = _obs_report("diff", str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl"))
    assert "matched launches: 4 (only-old: 0, only-new: 0)" in out
    assert "backend: cpu -> cpu" not in out


def test_resumed_launches_recorded_as_jax(tmp_path):
    ck = tmp_path / "ck"
    with pytest.raises(RuntimeError, match="abort_after_launches"):
        _sweep(tmp_path / "a.jsonl", checkpoint_dir=str(ck), abort_after_launches=1)
    rows = _sweep(tmp_path / "b.jsonl", checkpoint_dir=str(ck), resume=True)
    assert json.dumps(rows) == json.dumps(_sweep(tmp_path / "c.jsonl"))
    head, recs = pprof.read_manifest(str(tmp_path / "b.jsonl"))
    assert head["n_resumed"] == 1 and head["n_launches"] == 4
    assert recs[0] == {"record": "launch", "scheme": "dcqcn", "lo": 0, "hi": 2,
                       "pad_to": 2, "resumed": True}
    assert all("execute_s" in r for r in recs[1:])
    assert "(resumed from checkpoint)" in _obs_report("summarize", str(tmp_path / "b.jsonl"))


def test_window_timeline_equals_jax_from_the_same_arrays(tmp_path):
    """JAX's window-mode run of a batch, its arrays handed to both
    exporters: the same document, and the same file."""
    cfgs = [dataclasses.replace(JNetConfig(distance_km=d), event_ring_slots=16,
                                trace_window_steps=32) for d in (100.0, 300.0)]
    wl = jwork.congestion_workload(num_inter=4, num_intra=4, burst_start_us=200.0,
                                   burst_len_us=600.0, horizon_us=1_000.0)
    _, aux = jfl.simulate_batch(cfgs, wl, jnetsim.get_scheme("dcqcn"), 1_000.0,
                                trace_mode="window")
    np_aux = SimpleNamespace(window={k: np.asarray(v) for k, v in aux.window.items()},
                             events=type(aux.events)(*(np.asarray(x) for x in aux.events)))
    kw = dict(dt_us=5.0, steps=200, window_steps=32, event_ring_slots=16,
              labels=["a", "b"])
    jdoc, pdoc = jtl.timeline_from_window(np_aux, **kw), ptl.timeline_from_window(np_aux, **kw)
    assert any(r["ph"] == "i" for r in jdoc["traceEvents"])
    assert pdoc == jdoc
    jtl.export_timeline(str(tmp_path / "j.json"), jdoc)
    ptl.export_timeline(str(tmp_path / "p.json"), np_aux, **kw)
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()


def test_trace_timeline_equals_jax_from_the_same_arrays():
    rng = np.random.default_rng(0)
    traces = {"q_dst": rng.random((2, 10)).astype(np.float32),
              "q_dst_link": rng.random((2, 10, 3)).astype(np.float32)}
    for kw in (dict(decimate=4), dict(cell=1), dict(labels=["x", "y"])):
        assert ptl.timeline_from_traces(traces, dt_us=5.0, **kw) == \
            jtl.timeline_from_traces(traces, dt_us=5.0, **kw)
    single = {k: v[0] for k, v in traces.items()}
    assert ptl.timeline_from_traces(single, dt_us=5.0) == \
        jtl.timeline_from_traces(single, dt_us=5.0)


def test_obs_figure_on_cpu(tmp_path, capsys):
    """``launch.netsim --figure obs`` end to end on the CPU: its asserts
    hold (window rows equal to metrics rows, obs_report's summary and diff,
    PFC and brake events in the timeline), and ``--manifest-out`` names the
    smoke's manifest."""
    from repro_torch.launch import netsim as launch
    out = launch.main(["--figure", "obs", "--device", "cpu", "--out-dir", str(tmp_path),
                       "--manifest-out", str(tmp_path / "copy.jsonl")])
    notes = {name: note for name, _, note in out["rows"]}
    assert "dcqcn:otn_xoff_cross|pfc_xoff|pfc_xon" in notes["obs/event_kinds"]
    assert "matchrdma:scheme_brake" in notes["obs/event_kinds"]
    head, recs = pprof.read_manifest(str(tmp_path / "copy.jsonl"))
    assert head["trace_mode"] == "window" and [r["scheme"] for r in recs] == [
        "dcqcn", "matchrdma"]
    assert not (tmp_path / "manifest.jsonl").exists()
    doc = json.loads((tmp_path / "timeline.json").read_text())
    assert {r["pid"] for r in doc["traceEvents"]} == {0, 1, 2, 3}
