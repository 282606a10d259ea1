"""The port's gradient tuner against its bracket search and against the JAX
package's tuner (mirroring tests/test_grad_tune.py), on its cell: matchrdma,
100 km, 6 ms, the congestion workload, the budget_headroom knob.

  * the port's bracket search (``launch.grad_tune.netsim_tune``): 10
    evaluations, the knob on the box's lower wall 0.85, the score within 0.5
    of 267.392 (tests/test_grad_tune.py's pin of JAX's);
  * the grad tuner reaches at least that score with fewer evaluations
    (2 per Adam step + 1), its surrogate finite and rising step by step;
  * its final knob within 1e-3 of the box's width of JAX's ``tune`` on the
    same cell;
  * the adversarial mode's knob validation, and ``configs.paper`` equal to
    the JAX package's.
"""
import numpy as np
import pytest

from repro.netsim import grad_tune as jgrad_tune
from repro_torch.launch.grad_tune import netsim_tune
from repro_torch.netsim import grad_tune

DISTS = (100.0,)
HORIZON = 6_000.0


@pytest.fixture(scope="module")
def hillclimb_result():
    return netsim_tune("headroom", iters=2, dists=DISTS, horizon_us=HORIZON,
                       device="cpu")


@pytest.fixture(scope="module")
def grad_result():
    return grad_tune.tune(knobs=("budget_headroom",), dists=DISTS,
                          horizon_us=HORIZON, steps=4, device="cpu")


def test_hillclimb_seeded_pin(hillclimb_result):
    val, score, evals = hillclimb_result
    assert evals == 10
    assert val == pytest.approx(0.85, abs=1e-9)
    assert score == pytest.approx(267.392, abs=0.5)


def test_grad_tuner_beats_hillclimb_on_evals(hillclimb_result, grad_result):
    _, hc_score, hc_evals = hillclimb_result
    assert grad_result.sim_evals < hc_evals
    assert grad_result.objective >= hc_score - 1e-6, (grad_result.objective, hc_score)
    lo, hi = grad_tune.KNOB_BOUNDS["budget_headroom"]
    assert lo <= grad_result.knobs["budget_headroom"] <= hi


def test_grad_tuner_surrogate_improves(grad_result):
    surr = [h["surrogate"] for h in grad_result.history]
    assert len(surr) == 4 and np.all(np.isfinite(surr))
    assert all(b >= a - 1e-3 for a, b in zip(surr, surr[1:])), surr
    assert surr[-1] > surr[0], surr


def test_grad_tuner_honest_eval_accounting(grad_result):
    assert grad_result.sim_evals == 2 * 4 + 1


def test_tune_lands_on_jax_tune(grad_result):
    ref = jgrad_tune.tune(knobs=("budget_headroom",), dists=DISTS,
                          horizon_us=HORIZON, steps=4)
    lo, hi = grad_tune.KNOB_BOUNDS["budget_headroom"]
    assert abs(grad_result.knobs["budget_headroom"]
               - ref.knobs["budget_headroom"]) <= 1e-3 * (hi - lo)
    assert grad_result.objective == pytest.approx(ref.objective, abs=0.5)
    for mine, theirs in zip(grad_result.history, ref.history):
        assert mine["surrogate"] == pytest.approx(theirs["surrogate"], rel=1e-4)


def test_adversarial_mode_knob_validation():
    with pytest.raises(ValueError, match="unknown knob"):
        grad_tune.tune(knobs=("budget_headroom",), adversarial=True, device="cpu")
    assert grad_tune.ADVERSARIAL_BOUNDS == jgrad_tune.ADVERSARIAL_BOUNDS
    assert grad_tune.KNOB_BOUNDS == jgrad_tune.KNOB_BOUNDS


def test_paper_config_matches_jax():
    import dataclasses

    from repro.configs import paper as jpaper
    from repro_torch.configs import paper
    for name in ("DISTANCES_KM", "MESSAGE_SIZES", "CONCURRENCY", "SCHEMES"):
        assert getattr(paper, name) == getattr(jpaper, name), name
    for d in (1.0, 300.0):
        mine = dataclasses.asdict(paper.net_at(d, slot_us=50.0))
        theirs = dataclasses.asdict(jpaper.net_at(d, slot_us=50.0))
        assert mine == theirs


def test_fd_table_is_test_grads():
    """The port's one FD table (FD_EPS: the card checks and the CPU FD
    battery) is tests/test_grad.py's, knob for knob and eps for eps."""
    import test_grad
    assert grad_tune.FD_EPS == {**dict(test_grad.FD_NET_KNOBS),
                                **{f"wl.{n}": e for n, e in test_grad.FD_WL_KNOBS}}
