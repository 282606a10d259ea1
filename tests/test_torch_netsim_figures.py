"""The reduced Fig. 3 rows of ``python -m repro_torch.launch.netsim`` against
``benchmarks/figures.py``'s, names, order and values, the derived rows (max
speedup vs DCQCN, buffer and pause reduction, FCT improvement) included.

Both run with every batch's horizon cut (``CUT_US``), so that the port's CPU
path, hundreds of small torch operations a step, fits a test: figures.py's
own code runs with its ``run_experiment_batch`` wrapped to take the cut
horizon, and the port's with ``--horizon-us``. The cuts keep each figure's
regime: fig3b's 12 ms covers the 1000 km round trip, fig3cd's 10 ms the
intra-DC burst's start at 20 ms (so it is the build-up of the inter-DC load
alone), fig3e's 2 ms ends before its requests start at 30 ms (every FCT is
inf on both sides: its rows check names, order and the inf/nan rows only;
the runner test holds finite FCTs). The full horizons are run once, outside
the tests, with the results in PERF.md.

Values are read back from each row's note; each number must agree within one
unit of its last printed digit plus 1e-3 of its value (the rows' 1e-3
tolerance), 0.2 for the printed percentages (differences of two ratios,
each within 1e-3).
"""
import re

import numpy as np
import pytest

from benchmarks import figures
from repro_torch.launch import netsim as launch

CUT_US = {"fig3b": 12_000.0, "fig3cd": 10_000.0, "fig3e": 2_000.0}
NUM = re.compile(r"[-+]?(?:\d+\.?\d*|inf|nan)")


def _numbers(note: str):
    out = []
    for tok in NUM.findall(note.split("(paper")[0].replace("x", " ")):
        decimals = len(tok.split(".")[1]) if "." in tok else 0
        out.append((float(tok), decimals))
    return out


@pytest.mark.parametrize("figure", sorted(CUT_US))
def test_reduced_rows_match_figures_py(figure, monkeypatch):
    real = figures.run_experiment_batch

    def cut(cfgs, wl, scheme, horizon_us, *args, **kw):
        return real(cfgs, wl, scheme, CUT_US[figure], *args, **kw)

    monkeypatch.setattr(figures, "run_experiment_batch", cut)
    jrows = getattr(figures, launch.FIGURES[figure].__name__)()
    out = launch.main(["--figure", figure, "--device", "cpu",
                       "--horizon-us", str(CUT_US[figure])])
    prows = out["rows"]
    assert [r[0] for r in prows] == [r[0] for r in jrows]
    for (name, _, pnote), (_, _, jnote) in zip(prows, jrows):
        pn, jn = _numbers(pnote), _numbers(jnote)
        assert len(pn) == len(jn) and pn, (name, pnote, jnote)
        for (p, dec), (j, _) in zip(pn, jn):
            if np.isnan(j) or np.isinf(j):
                assert p == j or (np.isnan(p) and np.isnan(j)), (name, pnote, jnote)
                continue
            lim = 10.0 ** -dec + 1e-3 * abs(j) + (0.2 if "%" in jnote else 0.0)
            assert abs(p - j) <= lim, (name, pnote, jnote)
    assert [r["scheme"] for r in out["schemes"]] == list(launch.SCHEMES)
