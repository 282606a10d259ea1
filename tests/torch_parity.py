"""Parity helpers for the port's netsim tests: the same values from a JAX
callable and its torch twin, compared leaf by leaf with stated tolerances.

Not a test module (pytest collects ``test_*.py`` only); the netsim parity
tests import it. It imports no JAX itself: leaves are read with numpy.
"""
import numpy as np
import torch


def leaves(tree, prefix: str = "") -> dict:
    """``{"a.b.c": ndarray}`` for every array leaf of a NamedTuple / dict /
    tuple / array tree (JAX arrays, numpy arrays, torch tensors; None skipped)."""
    if tree is None:
        return {}
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        out = {}
        for f in fields:
            out.update(leaves(getattr(tree, f), f"{prefix}{f}."))
        return out
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(leaves(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaves(v, f"{prefix}{i}."))
        return out
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree.detach().cpu().numpy()}
    return {prefix[:-1]: np.asarray(tree)}


def max_errors(port, ref, scales: dict = None) -> dict:
    """Per shared leaf: max |port - ref| / scale, the scale being
    ``scales[name]`` when given, else max |ref| of the leaf (1 for a leaf
    that is all zero)."""
    p, r = leaves(port), leaves(ref)
    out = {}
    for k in r:
        if k not in p:
            continue
        a = np.asarray(p[k], np.float64)
        b = np.asarray(r[k], np.float64)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        s = (scales or {}).get(k)
        if s is None:
            s = float(np.abs(b).max()) if b.size else 1.0
        out[k] = float(np.abs(a - b).max()) / (s or 1.0) if a.size else 0.0
    return out


def assert_close(port, ref, rel: float, scales: dict = None,
                 limits: dict = None, what: str = "") -> None:
    """Every shared leaf within ``rel`` of its scale (``limits`` overrides
    the limit of named leaves); both trees must share at least one leaf."""
    errs = max_errors(port, ref, scales)
    assert errs, f"{what}: no shared leaves"
    bad = {k: e for k, e in errs.items() if e > (limits or {}).get(k, rel)}
    assert not bad, f"{what}: leaves over the limit {rel:g}: {bad}"


# ---------------------------------------------------------------------------
# The golden scenarios of tests/golden/generate_goldens.py, run live
# ---------------------------------------------------------------------------

SCHEMES = ("dcqcn", "pseudo_ack", "themis", "matchrdma")
SEQ_KW = dict(num_inter=4, num_intra=4, burst_start_us=3_000.0,
              burst_len_us=4_000.0, horizon_us=10_000.0)
# name -> (distances, workload builder, its arguments, horizon us)
GOLDEN = {
    "seq": ((100.0,), "congestion_workload", SEQ_KW, 10_000.0),
    "batch": ((1.0, 300.0), "throughput_workload",
              dict(msg_size=1 << 20, concurrency=1, num_flows=4), 8_000.0),
}

# Where a free run of the port parts from JAX's on these scenarios, and the
# hard threshold that flips there (found by tests/test_torch_netsim_step.py,
# whose single steps agree to 1e-6 on both sides of each of these steps).
# Before the step the traces agree within TRACE_REL; after it the runs are
# two trajectories of the same system, held to the Fig. 3 columns.
PARTS = {
    ("seq", "dcqcn"): (306, "src-OTN -> sender PFC: sum(q_src) settles on "
                            "xoff_otn = 2e7 B (0.1 x 2D x C_otn at 100 km); "
                            "19,999,998 B in JAX, 20,000,002 B in the port"),
    ("seq", "themis"): (306, "the same src-OTN -> sender PFC threshold"),
    ("batch", "dcqcn"): (953, "DCQCN byte counter of the 1 km cell: "
                              "bytes_ctr + 62,500 B reaches 1e7 B in the port "
                              "(9,937,500) and misses it in JAX (9,937,499)"),
    ("batch", "themis"): (953, "the same DCQCN byte counter"),
}
# Traces before a part: the steps' ulp-level differences (1e-7 relative, an
# XLA FMA against torch's two roundings) accumulate over up to 2000 steps in
# the queue levels, which are differences of byte counters.
TRACE_REL = 2e-4
# ``cons_err`` is itself a residual of cancelling counters: absolute limit.
CONS_ERR_ABS = 1e-5
# The Fig. 3 columns over the whole horizon (ROADMAP's parity targets).
COLUMN_REL = 1e-3        # throughput, peak / mean / p99 buffer
PAUSE_ABS = 1e-3         # pause ratio
FINAL_REL = 1e-4         # final sent / delivered, of the largest value


def golden_configs(name, netconfig):
    return [netconfig(distance_km=d) for d in GOLDEN[name][0]]


def golden_workload(name, workload_module):
    _, build, kw, _ = GOLDEN[name]
    return getattr(workload_module, build)(**kw)


def fig3_columns(traces: dict, steps: int) -> dict:
    """The trace-derived Fig. 3 columns of ``runner._metrics_batch`` ([B])."""
    warm = int(steps * 0.1)
    q = np.asarray(traces["q_dst"], np.float64)
    return {
        "throughput": np.asarray(traces["thr_inter"])[:, warm:].mean(1),
        "peak_buffer": q.max(1),
        "mean_buffer": q[:, warm:].mean(1),
        "p99_buffer": np.percentile(q[:, warm:], 99, axis=1),
        "pause_ratio": np.asarray(traces["pause_dst"])[:, warm:].mean(1),
    }


def assert_columns_close(port: dict, ref: dict, what: str = "") -> None:
    for k, r in ref.items():
        r, p = np.asarray(r, np.float64), np.asarray(port[k], np.float64)
        if k == "pause_ratio":
            err, lim = np.abs(p - r).max(), PAUSE_ABS
        else:
            err, lim = (np.abs(p - r) / np.maximum(np.abs(r), 1e-30)).max(), COLUMN_REL
        assert err <= lim, f"{what} {k}: {p} vs {r} (error {err:.3e} > {lim:g})"


def assert_final_close(port_state, ref_state, dt_us: float, what: str = "") -> None:
    """Final ``sent``/``delivered`` within FINAL_REL of the largest value;
    ``done_at_us`` unfinished alike and otherwise within one step."""
    p_np, r_np = leaves(port_state), leaves(ref_state)
    for k in ("sent", "delivered"):
        r, p = r_np[k].astype(np.float64), p_np[k].astype(np.float64)
        assert p.shape == r.shape, (what, k)
        err = np.abs(p - r).max() / max(np.abs(r).max(), 1.0)
        assert err <= FINAL_REL, f"{what} final {k}: error {err:.3e}"
    r = r_np["done_at_us"].astype(np.float64)
    p = p_np["done_at_us"].astype(np.float64)
    unfinished = r >= 5e29
    assert np.array_equal(p >= 5e29, unfinished), f"{what} done_at_us"
    assert np.abs(p - r)[~unfinished].max(initial=0.0) <= dt_us, f"{what} done_at_us"


def assert_traces_close_before(port: dict, ref: dict, part: int, what: str = "",
                               every: int = 1) -> None:
    """Every trace key within TRACE_REL of its largest value (cons_err
    within CONS_ERR_ABS) on the rows before step ``part``."""
    rows = part // every
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        p = np.asarray(port[k], np.float64)
        assert p.shape == r.shape, (what, k, p.shape, r.shape)
        d = np.abs(p[:, :rows] - r[:, :rows]).max(initial=0.0)
        if k == "cons_err":
            assert d <= CONS_ERR_ABS, f"{what} {k}: {d:.3e}"
        else:
            rel = d / max(np.abs(r).max(), 1e-30)
            assert rel <= TRACE_REL, f"{what} {k}: {rel:.3e} before step {part}"
