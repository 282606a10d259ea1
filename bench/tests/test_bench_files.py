"""BENCHMARK.json against the files it names, and the contract's shapes."""
import json
import re

import pytest

from bench import harness

BM = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BM["workloads"]]
METRICS = BM["end_to_end"] + BM["per_layer"]


def test_top_level_keys_and_command():
    assert set(BM) == {"command", "paths", "run_seconds", "configs", "workloads",
                       "end_to_end", "per_layer"}
    assert BM["command"] == ["python3", "bench/run.py"] and BM["paths"] == ["bench"]
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BM["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_the_contracts_keys():
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BM["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BM["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert "setup_s" in {m["name"] for m in BM["end_to_end"]}


def test_names_units_and_lines():
    names = ([c["name"] for c in BM["configs"]] + CELLS + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BM["workloads"]]
             + [k for c in BM["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in (BM["configs"], BM["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    lines = ([w["why"] for w in BM["workloads"] + BM["configs"]] + [c["source"] for c in BM["configs"]]
             + [m["layer"] for m in BM["per_layer"]])
    assert all(1 <= len(s) <= 200 and "\n" not in s and "\t" not in s for s in lines)
    assert len(json.dumps(BM)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    w = harness.cell(cell, BM)
    cfg, mx, lim = harness.config(w["config"]), harness.mix(w["traffic"]), harness.limits(cell)
    spec = harness.load_json(harness.BENCH / "workloads" / f"{cell}.json")
    assert (spec["config"], spec["traffic"], spec["chips"]) == (w["config"], w["traffic"], w["chips"])
    assert cfg["name"] == w["config"] and harness.driver(mx["driver"]).run
    assert lim and all(v > 0 for v in lim.values())


@pytest.mark.parametrize("entry", BM["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    assert entry["file"] == f"bench/configs/{entry['name']}.json"
    cfg = harness.config(entry["name"])
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert set(entry["reduced"]) <= set(cfg["departures"])
    assert any(w["config"] == entry["name"] for w in BM["workloads"])


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_metric_files(entry):
    mod = harness.metric(entry["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (entry["unit"], entry["better"], entry["source"])
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
    assert all(c in CELLS for c in entry.get("workloads", CELLS))


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.metrics_of(cell, False, BM)}
        assert "setup_s" in e2e and len(e2e) >= 2
        for m in harness.metrics_of(cell, True, BM):
            assert m["moves"] in e2e, (cell, m["name"])
        assert harness.metrics_of(cell, True, BM)
