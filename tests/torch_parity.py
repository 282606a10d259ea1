"""Parity helpers for the port's netsim tests: the same values from a JAX
callable and its torch twin, compared leaf by leaf with stated tolerances.

Not a test module (pytest collects ``test_*.py`` only); the netsim parity
tests import it. It imports no JAX itself: leaves are read with numpy.
"""
import numpy as np
import torch

from repro_torch.config.net import NetConfig
from repro_torch.netsim.streaming import HIST_BINS


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

RELATED = ("geopipe", "sdr_rdma", "rdmacell")
ALL_SCHEMES = SCHEMES + RELATED

# The multi-link scenarios: one cell of benchmarks/scheme_compare.py's
# topology grid (100 km, three links, its widest delay spread and capacity
# skew) under the golden congestion workload, 10 ms; and the 3-site mesh of
# scheme_compare.SITES_EDGES (two parallel 0->1 edges, a thin relay through
# site 2) under scheme_compare._sites_workload, cut to 6 ms.
LINKS3 = dict(distance_km=100.0, num_paths=3, path_delay_scale=(1.0, 2.0, 4.0),
              path_cap_frac=(0.6, 0.3, 0.1))
LINKS3_H_US = 10_000.0
MESH_H_US = 6_000.0


def links3_config(netconfig):
    return netconfig(**LINKS3)


def mesh_config(netconfig, topology):
    e = topology.SiteEdge
    edges = (e(0, 1), e(0, 1, delay_scale=1.5), e(0, 2, cap_frac=0.2),
             e(2, 1, cap_frac=0.2))
    return topology.SiteGraph(3, edges).to_net_config(netconfig(distance_km=100.0))


def mesh_workload(work, horizon_us: float = MESH_H_US):
    """Inter-DC load on all three site pairs and an intra-DC burst at site 1's
    leaf through the middle third (scheme_compare._sites_workload)."""
    fs = work.FlowSpec
    inter = [fs(True, 1 << 20, 16) for _ in range(2)]
    inter += [fs(True, 1 << 20, 16, src_site=0, dst_site=2),
              fs(True, 1 << 20, 16, src_site=2, dst_site=1)]
    intra = [fs(False, 256 << 10, 8, dst_site=1, start_us=horizon_us / 3.0,
                period_us=horizon_us, duty=1.0 / 3.0) for _ in range(2)]
    return work.Workload(tuple(inter + intra))


# The golden congestion cell under the ``impaired`` channel (loss, jitter and
# flap at once: the knobs of tests/test_channel.py's conservation test), cut
# to 3 ms (the port's CPU path draws its noise in ~500 eager ops a step).
IMPAIRED_KNOBS = dict(distance_km=100.0, loss_rate=0.01, loss_burst_len=4.0,
                      jitter_us=20.0, flap_period_us=2_000.0, flap_depth=0.5)
IMPAIRED_H_US = 3_000.0

_EMPTY = "the step's throughput reads the gap as it drains empty: "
_XOFF_50KM = ("src-OTN -> sender PFC: sum(q_src) settles on xoff_otn = 1e7 B "
              "(0.1 x 2D x C_otn at 50 km), 9,999,999 B in JAX, 10,000,001 B "
              "in the port; one flow-step (250,000 B) more is sent in JAX")

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
    ("seq", "rdmacell"): (306, "rdmacell is dcqcn on one link: the same "
                               "src-OTN -> sender PFC threshold"),
    ("seq", "sdr_rdma"): (709, "cons_err, the conservation residual of f32 "
                               "byte counters of ~3.5e7 B, drifts by a "
                               "rounding a step at its own rate in each "
                               "(single steps agree to 1e-6): 4.4e-7 of sent "
                               "in JAX, 1.04e-5 in the port. The queues part "
                               "at step 898, where the destination OTN drains "
                               "empty and min(backlog, capacity) hands the "
                               "1,380 B gap of q_dst to the leaf at once"),
    ("seq", "geopipe"): (381, "the credit gate: the source releases its whole "
                              "credit, so credit = window - (released - "
                              "granted) lands on 0 within the ulp (1-2 B) of "
                              "counters of 1e7 B, and credit_stall (credit "
                              "<= 1 B) reads 2 B in JAX, 0 B in the port"),
    ("batch", "geopipe"): (124, "the same credit gate (the 1 km cell)"),
    # the multi-link scenarios: most part where a queue drains empty; its
    # level, a difference of byte counters, is a few ulps of drift apart by
    # then, and min(backlog, capacity) hands the whole gap on in one step
    ("links3", "dcqcn"): (510, _EMPTY + "the destination OTN (95 B apart)"),
    ("links3", "themis"): (510, _EMPTY + "the destination OTN (95 B apart)"),
    ("links3", "sdr_rdma"): (906, _EMPTY + "the destination leaf (439 B)"),
    ("links3", "rdmacell"): (922, _EMPTY + "the destination leaf (272 B)"),
    ("links3", "geopipe"): (384, "the credit gate, as on the golden cell"),
    ("mesh", "dcqcn"): (748, "link 0's destination PFC releases at XON = "
                             "3e6 B: q_dst_link[0] reads 3,000,045.75 B in "
                             "JAX, 2,999,991.75 B in the port"),
    ("mesh", "themis"): (551, _EMPTY + "the source OTN (212 B), so the "
                                       "last spray differs on every link"),
    ("mesh", "sdr_rdma"): (847, _EMPTY + "the destination leaf (52 B)"),
    ("mesh", "rdmacell"): (462, _EMPTY + "the destination leaf (64 B)"),
    ("mesh", "geopipe"): (305, "the credit gate, as on the golden cell"),
    # the golden congestion cell under the impaired channel (IMPAIRED_KNOBS):
    # the draws are the same numbers in both runs, so the runs part where a
    # hard threshold meets the counters' few-byte drift, as on the ideal
    # one. Past this horizon (found at 5 ms): dcqcn / themis / rdmacell at
    # step 923, where the destination leaf drains empty 752 B apart, and
    # sdr_rdma at 836 (ROADMAP, "Deliberate differences").
    ("impaired", "geopipe"): (456, "the credit gate, as on the golden cell"),
    # the sites grid's cell at schedule scale 1, relay spread 1.5, under
    # trace_replay (tests/test_torch_netsim_replay.py)
    ("sites", "dcqcn"): (543, _EMPTY + "the source OTN (110 B apart), so the "
                                       "last spray differs on every link"),
    ("sites", "rdmacell"): (578, _EMPTY + "the destination leaf (200 B)"),
    # a site outage (every link down, 600-1500 us) on three unequal links at
    # 100 km under a streaming workload (tests/test_torch_netsim_failures.py)
    ("site_outage", "geopipe"): (312, "src-OTN -> sender PFC: sum(q_src) settles "
                                      "on xoff_otn = 2e7 B while every link is "
                                      "down; 20,000,000 B in JAX, 20,000,002 B "
                                      "in the port"),
    ("site_outage", "rdmacell"): (606, "the same src-OTN -> sender PFC threshold "
                                       "after the outage: sum(q_src) reaches "
                                       "19,999,998 B in JAX and 20,000,002 B in "
                                       "the port at step 605"),
    # scheme_compare's 50 km cell, cut to 3 ms (tests/test_torch_netsim_compare.py)
    ("compare_50km", "dcqcn"): (153, _XOFF_50KM),
    ("compare_50km", "themis"): (153, _XOFF_50KM),
    ("compare_50km", "rdmacell"): (153, _XOFF_50KM),
}
# Row columns that are read at a parting's threshold itself, over the whole
# run, and with it why they are not held to COLUMN_REL.
ROW_PARTS = {
    ("geopipe", "credit_stall_frac"): (
        "the share of steps with credit <= 1 B: the credit-paced source "
        "spends its credit to 0 within the 1-2 B ulp of its counters, so "
        "each such step's flag is decided by f32 rounding (golden batch, "
        "1 km: 0.281 in the port, 0.169 in JAX; every other column of "
        "those rows within 1e-3)"),
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
# Queue levels are differences of byte counters that move about C.dt = 1e6 B
# a step (1.6 Tb/s for 5 us); a drained queue holds f32 residues of that
# size's ulp (a few 1e-3 B, of either sign), so the new tests read queue
# errors against at least QUEUE_SCALE bytes (1e-6 of it is one byte).
QUEUE_SCALE = 1e6
# rdmacell's reorder-buffer trace (MB) is a difference of its cumulative
# per-link tx and arrival ledgers (1e7 B and more): f32 rounding leaves
# residues of a few bytes (JAX reads 2e-6 MB where the port reads 0 from step
# 401 of the site outage), so the new tests read it against its own limit,
# rdmacell_rob_limit_mb, as the queues are read against QUEUE_SCALE.
ROB_SCALE_MB = NetConfig().rdmacell_rob_limit_mb
QUEUE_LEAVES = ("q_src", "q_dst", "q_leaf", "q_dst_link", "out.q_src",
                "out.q_dst", "out.q_leaf", "out.q_dst_link",
                "extra.acc_queue", "extra.mr.acc_queue")


# PFC pause signals are 0/1 in the hard step and gate weights in [0, 1] in
# the soft one, where a queue far below its threshold pauses by a residue:
# their unit is 1 (a hard run that pauses at all reaches it anyway).
GATE_LEAVES = ("pause_dst", "pause_line", "out.pause_dst", "out.src_paused",
               "out.link_pause")


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


# Where a column's reference is itself a residue (a queue that never holds
# more than f32 residues of drained bytes), it is read against at least these:
# 100 B under the buffers, 1e-4 Gb/s under the throughput (chip_smoke.py's
# NETSIM_FLOOR). The new multi-link tests pass them.
COLUMN_FLOORS = {"peak_buffer": 100.0, "mean_buffer": 100.0, "p99_buffer": 100.0,
                 "throughput": 1e-4 * 1e9 / 8.0}


def assert_columns_close(port: dict, ref: dict, what: str = "",
                         floors: dict = None) -> None:
    for k, r in ref.items():
        r, p = np.asarray(r, np.float64), np.asarray(port[k], np.float64)
        if k == "pause_ratio":
            err, lim = np.abs(p - r).max(), PAUSE_ABS
        else:
            scale = np.maximum(np.abs(r), (floors or {}).get(k, 1e-30))
            err, lim = (np.abs(p - r) / scale).max(), COLUMN_REL
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
                               every: int = 1, floors: dict = None) -> None:
    """Every trace key within TRACE_REL of its largest value, or of
    ``floors[key]`` where that is larger (cons_err within CONS_ERR_ABS), on
    the rows before step ``part``."""
    rows = part // every
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        p = np.asarray(port[k], np.float64)
        assert p.shape == r.shape, (what, k, p.shape, r.shape)
        d = np.abs(p[:, :rows] - r[:, :rows]).max(initial=0.0)
        if k == "cons_err":
            assert d <= CONS_ERR_ABS, f"{what} {k}: {d:.3e}"
        else:
            rel = d / max(np.abs(r).max(), (floors or {}).get(k, 0.0), 1e-30)
            assert rel <= TRACE_REL, f"{what} {k}: {rel:.3e} before step {part}"


# ---------------------------------------------------------------------------
# Rows (runner): the Fig. 3 columns and the schemes' streamed columns
# ---------------------------------------------------------------------------

BIN_RATIO = 10 ** (12 / (HIST_BINS - 1))
# on top of the relative limit, 100 bytes (1e-4 MB; 1e-4 Gbps for the rates):
# a drained queue holds f32 residues of a few bytes (available minus drained
# bytes of order 1e6; JAX leaves -2e-9 MB where the port leaves 0), and its
# p99 or mean is made of them
ABS_FLOOR = 1e-4


def assert_rows_close(prows, jrows, metrics_mode=False, what=""):
    """Row for row, each column as the module docstring of
    tests/test_torch_netsim_runner.py states; a column of ``ROW_PARTS`` only
    present and within [0, 1]."""
    assert len(prows) == len(jrows), what
    for p, j in zip(prows, jrows):
        assert sorted(p) == sorted(j), (what, sorted(set(p) ^ set(j)))
        assert p["scheme"] == j["scheme"] and p["distance_km"] == j["distance_km"]
        for k, r in j.items():
            if k in ("scheme", "distance_km"):
                continue
            if (p["scheme"], k) in ROW_PARTS:
                assert 0.0 <= p[k] <= 1.0, (what, p["scheme"], k, p[k])
                continue
            v = p[k]
            if k == "completion_frac":
                ok = v == r
            elif k == "avg_fct_us":
                ok = (np.isnan(v) and np.isnan(r)) or v == r or abs(v - r) <= 5.0
            elif k == "pause_ratio":
                ok = abs(v - r) <= PAUSE_ABS
            elif k in ("p99_buffer_mb", "p99_repair_latency_us") and metrics_mode:
                ok = v == r or (min(v, r) > 0 and max(v, r) / min(v, r) <= BIN_RATIO * 1.0001)
            else:
                ok = abs(v - r) <= COLUMN_REL * abs(r) + ABS_FLOOR
            assert ok, f"{what} {p['scheme']} d={p['distance_km']} {k}: {v} vs {r}"
