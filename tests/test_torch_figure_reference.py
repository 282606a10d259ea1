"""``tests/torch_figure_reference.json``: the JAX package's netsim figure rows
that ``chip_smoke.py`` holds the card's against, and the holding rule.

The file names every figure the card holds, at ``chip_smoke.py``'s horizons;
its recorded base batches, replayed through the port's figure functions (no
simulation), give its rows, names, order, notes and numbers; a live JAX rerun
of Fig. 3e's base run equals it; and the rule passes every recorded run,
fails a number moved just past its limit, and recomputes each derived row
from its parts.
"""
import copy
import math
from unittest import mock

import pytest
import torch

import chip_smoke
import torch_figure_reference as ref
import torch_parity
from repro_torch.launch import geo_training
from repro_torch.launch import netsim as launch

DOC = ref.load()
FIGS = DOC["figures"]


def _rows(fig: dict, run: int = 0) -> dict:
    """One recorded run of a figure as the card's rows are held."""
    return {r["name"]: {"values": {f: v[run] for f, v in r["values"].items()},
                        "specs": r["specs"]} for r in fig["rows"]}


def _same(a, b) -> bool:
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def test_the_file_names_every_held_figure_at_chip_smokes_horizons():
    assert list(FIGS) == [*ref.HELD, ref.GEO]
    assert DOC["ulps"] == [0, *ref.ULPS] and len(ref.ULPS) <= 8
    assert DOC["link_gbps"] == [ref.link_gbps(k) for k in DOC["ulps"]]
    assert DOC["link_gbps"][0] == 100.0 and len(set(DOC["link_gbps"])) == 9
    assert DOC["jax"] and DOC["command"].startswith(
        "PYTHONPATH=src python tests/torch_figure_reference.py")
    for name, (full, horizon, _) in chip_smoke.NETSIM_FIG3.items():
        assert ref.HELD[name] == (full, horizon)
    assert ref.HELD["scheme_compare"][1] == chip_smoke.NETSIM_COMPARE_H_US
    assert ref.GEO_ARGS[1] == chip_smoke.GEO_DISTANCES and "--lossy" in ref.GEO_ARGS
    assert ref.GEO_H_US == geo_training.HORIZON_US
    for name, fig in FIGS.items():
        want = ref.GEO_H_US if name == ref.GEO else ref.HELD[name][1]
        assert fig["horizon_us"] == want, name
        assert all(b["horizon_us"] == want for b in fig["batches"]), name
        for r in fig["rows"]:
            for f, vals in r["values"].items():
                assert len(vals) == 9
                if not ref.derived_parts(r["name"], [x["name"] for x in fig["rows"]]):
                    assert _same(r["lo"][f], min(vals)) and _same(r["hi"][f], max(vals))


def test_every_named_parting_is_a_row_of_the_file():
    rows = {r["name"] for fig in FIGS.values() for r in fig["rows"]}
    assert ref.FIGURE_PARTS and set(ref.FIGURE_PARTS) <= rows
    for step, threshold, jax_value, card_value in ref.FIGURE_PARTS.values():
        assert step > 0 and threshold and jax_value != card_value


def test_figures_py_prints_the_files_fig3_rows():
    """benchmarks/figures.py's own Fig. 3b-e (per message size for 3b), at the
    same grids and horizons, print the file's base rows."""
    for name in ("fig3b", "fig3cd", "fig3e"):
        assert FIGS[name]["figures_py"]["rows"] == len(FIGS[name]["rows"])
        assert FIGS[name]["figures_py"]["apart"] == [], name


def _replay(fig: dict, seen: list):
    """A stand-in for the port's runner that returns the file's base batches
    in their order (each call's scheme and horizon checked)."""
    batches = iter(fig["batches"])

    def run(cfgs, workload, scheme, horizon_us, *, device=None, profile=None,
            manifest_path=None, **kw):
        b = next(batches)
        assert (b["scheme"], b["horizon_us"]) == (scheme, horizon_us)
        assert len(b["rows"]) == len(cfgs)
        seen.append(scheme)
        if profile is not None:
            profile.append({"steps": cfgs[0].horizon_steps(horizon_us), "run_ms": 0.0,
                            "capture_s": 0.0})
        return copy.deepcopy(b["rows"])

    return run


@pytest.mark.parametrize("name", [*ref.HELD, ref.GEO])
def test_the_ports_figure_functions_give_the_files_rows(name):
    """The port's figure function, at chip_smoke.py's grid and horizon, fed
    the file's recorded batches: the file's row names, order, notes and
    numbers, and every batch read."""
    fig, seen = FIGS[name], []
    run = _replay(fig, seen)
    with mock.patch.object(launch, "run_experiment_batch", run), \
            mock.patch.object(geo_training, "run_experiment_batch", run):
        if name == ref.GEO:
            got = ref.geo_values(geo_training.main(
                [*ref.GEO_ARGS, "--device", "cpu"]))
        else:
            full, horizon = ref.HELD[name]
            f = launch.Figure(name, torch.device("cpu"), horizon, profile_steps=0)
            printed = launch.FIGURES[name](f, full=full)
            assert [n for n, _, _ in printed] == list(f.values)
            got = {n: dict(f.values[n], note=note) for n, _, note in printed}
    assert len(seen) == len(fig["batches"])
    assert list(got) == [r["name"] for r in fig["rows"]]
    for r in fig["rows"]:
        assert got[r["name"]]["note"] == r["note"], r["name"]
        assert got[r["name"]]["specs"] == r["specs"], r["name"]
        for f, v in got[r["name"]]["values"].items():
            assert _same(v, r["values"][f][0]), (r["name"], f)


def test_a_live_jax_rerun_of_fig3e_equals_the_file():
    rec = ref.record("fig3e", with_figures_py=False)
    want = {r["name"]: r for r in FIGS["fig3e"]["rows"]}
    assert list(rec["rows"]) == list(want)
    for name, row in rec["rows"].items():
        assert row["note"] == want[name]["note"]
        for f, v in row["values"].items():
            assert _same(v, want[name]["values"][f][0]), (name, f)


@pytest.mark.parametrize("name", [*ref.HELD, ref.GEO])
def test_the_rule_passes_every_recorded_run_and_recomputes_the_derived_rows(name):
    fig = FIGS[name]
    names = [r["name"] for r in fig["rows"]]
    for run in range(9):
        held = ref.hold(_rows(fig, run), fig)
        assert held["inside"] == held["rows"] == len(names), held["outside"][:3]
    ref_rows = {r["name"]: r for r in fig["rows"]}
    derived = [n for n in names if ref.derived_parts(n, names)]
    assert derived
    for n in derived:
        for f, stored in ref_rows[n]["values"].items():
            lo, hi, vals = ref.envelope(ref_rows, n, f, names)
            assert all(_same(a, b) for a, b in zip(vals, stored)), (n, f)
            assert _same(lo, ref_rows[n]["lo"][f]) and _same(hi, ref_rows[n]["hi"][f])


def _moved(fig, row, field, by):
    card = _rows(fig)
    card[row]["values"][field] = by(card[row]["values"][field])
    return card


@pytest.mark.parametrize("row,field", [
    ("fig3d/pause_ratio/dcqcn/d100km", "pause_ratio"),
    ("fig3c/peak_buffer_mb/matchrdma/d500km", "p99_buffer_mb"),
    ("fig3b/thr_gbps/matchrdma/d1000km/msg8192KB", "throughput_gbps")])
def test_a_number_just_past_its_limit_falls_outside(row, field):
    fig = FIGS[{"fig3c": "fig3cd", "fig3d": "fig3cd"}.get(row[:5], row[:5])]
    r = next(x for x in fig["rows"] if x["name"] == row)
    hi = r["hi"][field]
    spec = r["specs"][field]
    limit = ref.widening(field, hi) + ref.unit(spec, hi)
    inside = ref.hold(_moved(fig, row, field, lambda x: hi + 0.999 * limit), fig)
    assert row not in [o["row"] for o in inside["outside"]]
    got = inside["readings"][row][field]
    assert got["dist"] <= got["limit"] == pytest.approx(hi - r["values"][field][0] + limit)
    outside = ref.hold(_moved(fig, row, field, lambda x: hi + 1.01 * limit), fig)
    assert row in [o["row"] for o in outside["outside"]]
    got = next(o for o in outside["outside"] if o["row"] == row)[field]
    assert got["dist"] > got["limit"] and got["lo"] <= got["hi"] == hi


def test_a_derived_row_is_recomputed_from_its_parts():
    fig = FIGS["fig3cd"]
    part, derived = "fig3d/pause_ratio/matchrdma/d100km", "fig3d/pause_reduction/d100km"
    card = _moved(fig, part, "pause_ratio", lambda x: x + 0.05)
    # the part moved and the derived row as printed before: the recomputation
    # disagrees with the printed number
    held = ref.hold(card, fig)
    bad = {o["row"]: o for o in held["outside"]}
    assert part in bad and "recomputed" in bad[derived]["pause_pct"]
    # the derived row printed from the moved part: outside by its own reading
    dq = card["fig3d/pause_ratio/dcqcn/d100km"]["values"]["pause_ratio"]
    m = card[part]["values"]["pause_ratio"]
    card[derived]["values"]["pause_pct"] = -100 * (1 - m / max(dq, 1e-9))
    held = ref.hold(card, fig)
    bad = {o["row"]: o for o in held["outside"]}
    assert "recomputed" not in bad[derived]["pause_pct"]
    assert bad[derived]["pause_pct"]["dist"] > bad[derived]["pause_pct"]["limit"]
    # a named parting takes the rows derived from it along
    held = ref.hold(card, fig, parts={part: (0, "planted", 0.0, 0.0)})
    assert not held["outside"] and set(held["parts"]) >= {part, derived}


def test_the_rows_limits_are_the_ports():
    assert ref.COLUMN_REL == torch_parity.COLUMN_REL == chip_smoke.NETSIM_TOL["throughput"]
    assert ref.PAUSE_ABS == torch_parity.PAUSE_ABS == chip_smoke.NETSIM_TOL["pause_ratio"]
    assert ref.FLOORS["_gbps"] == chip_smoke.NETSIM_FLOOR["throughput"] * 8 / 1e9
    assert ref.FLOORS["_mb"] == chip_smoke.NETSIM_FLOOR["peak_buffer"] / 1e6
    assert ref.COLUMN_REL * ref.FLOORS["_us"] == chip_smoke.NETSIM_TOL["done_at_us"]
    assert ref.unit(".4g", 123.456) == 0.1 and ref.unit("+.1f", -62.7) == 0.1
    assert ref.unit(".0f", 5.0) == 1.0 and ref.unit(".4g", 0.0) == 0.0
