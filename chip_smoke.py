#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA Hopper GPU: build, check, serve, train, netsim.

    python3 chip_smoke.py

Run from a checkout of the repository; it puts ``src`` on ``sys.path`` itself
and builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/kernels`` at first use. Phases, each of which fails the run:

1. card: ``nvidia-smi`` name and power limit; requires compute capability 9.0;
2. build: every kernel source, one nvcc each, all started together, with
   each instantiation's registers and spills; then ``cuobjdump -sass`` of the
   flash and SSD libraries, which fails the run unless every bf16
   instantiation of the flash kernel (D = 16 ... 256, D = 192 included) and
   of the SSD-scan kernel issues ``HGMMA`` (Hopper's wgmma: the tensor
   cores), and the f32 SSD instantiations none (the scalar kernel);
3. kernels: each kernel against its plain PyTorch version on the card, f32
   and bf16. Flash attention at the serving shape, qwen's training shape
   (B=8, S=2048, H=16, D=64), a GQA shape and ragged S,
   with and without softcap, and at head dims 8 (zero-padded to the D=16
   instantiation) and 192; then kernel, plain version, library call and
   bound timed at S=512 and S=4096. Windowed flash attention against
   ``attention_ref(window=)`` at recurrentgemma-2b's serving shape (B=4,
   S=4096, Hq=10, Hk=1, D=256, W=2048), ragged S=1000 with W=100, W=1, W >= S
   (which must equal causal) and D=192; then timed there, with SDPA on the
   band as a boolean mask as the library call. The SSD scan (y and final
   state) against the step-by-step oracle at the mamba2 serving shape, ragged
   S=1000, two groups, chunk 64 and the smoke shape, and in bf16 also against
   its plain version with the same roundings (``ssd_scan_plain(round_to=)``);
   then kernel, plain version and bound timed at the serving shape. The
   RG-LRU scan (two kernels a call) against the step-by-step oracle at the
   recurrentgemma-2b serving shape [4, 4096, 2560], ragged S=1000 with W=200
   and the three shapes of tests/test_kernels.py, and bit for bit against
   ``rglru_chunked_ref``, its arithmetic in plain PyTorch; then timed at the
   serving shape. Then each op's autograd Function: the grads of every input
   against autograd through the kernel's plain version, f32 and bf16, at
   qwen's attention shapes (serving B=4, S=512 and training B=8, S=2048;
   H=16, D=64), recurrentgemma's windowed
   one, mamba2's SSD serving shape and the RG-LRU at [4, 4096, 2560], S=1
   and ragged S=1000; and each Function's forward and forward+backward timed;
4. serve qwen1.5-0.5b at full width, bf16, random weights from a seed, through
   ``repro_torch.launch.serve`` (its default workload: batch 4, prompt 512, 32
   new tokens); the flash kernel's launch count over that run must be one per
   attention layer, and the card's prefill logits must agree with the same
   weights' f32 prefill on the CPU (plain path) at B=1, S=128. As a control,
   the same check is read with the plain path in place of the kernel, with
   P rounded to bf16 (as the bf16 kernel rounds it; read for comparison)
   and with the causal mask dropped, which must fail it;
5. serve mamba2-370m the same way (its default workload: batch 4, prompt
   2048, 32 new tokens): one SSD-scan launch per SSD layer (48) per prefill,
   and the card-vs-CPU check at B=1, S=300 (two chunks of 128 and a ragged
   third), on the logits and on the first layer's final SSD state, with the
   controls "state not carried across chunks", which must fail it, and "xdt
   and C B^T L rounded to bf16" (the JAX model path's rounding), which is
   read;
6. serve recurrentgemma-2b the same way (its default workload: batch 4,
   prompt 4096, two windows of its local attention, 32 new tokens): one
   flash launch per local-attention layer (8) and one RG-LRU launch per
   RG-LRU layer (18) per prefill, and the card-vs-CPU check at B=1, S=300 on
   the logits and on the first layer's final RG-LRU state, with the control
   "recurrence restarted every 256 steps" (the TPU kernel's state carry
   across sequence blocks dropped), which must fail it;
7-9. train qwen1.5-0.5b, mamba2-370m and recurrentgemma-2b at full width
   through ``repro_torch.launch.train`` (each arch's default workload: batch
   8 x 2048 tokens for 5 steps, 4 x 2048 for 3, 1 x 4096 for 3; bf16, AdamW,
   remat "block"): every step's loss and grad norm finite, the loss after the
   last step (on step 1's batch) below step 1's, no restart, and the
   kernels' launches per step as the remat policy makes them (a kernel in a
   rematerialised group runs twice, in the forward and in the recompute; the
   RG-LRU backward runs the kernel once more). qwen's trained state is
   saved as a checkpoint under ``build/``, restored and compared bit for
   bit. Then the card's loss and grads at B=1 (the serving checks' length)
   against the same weights' f32 loss and grads on the CPU (plain path):
   the loss, ``embed.tok``, the first layer's mixer input projection and the
   last layer's MLP (mamba2: mixer) output projection, with the card in bf16
   (its training dtype) and in f32 (the same weights cast up). Planted
   faults in the backward must each fail the check: "flash backward without
   the causal mask" (qwen), "SSD backward with dA dropped" (mamba2, read on
   the first layer's ``A_log`` too) and "RG-LRU backward with a_t in place of
   a_{t+1}" (recurrentgemma).
10. the netsim Fig. 3 path (the fluid long-haul simulator and the paper's
   four schemes, batched torch ops replayed as CUDA graphs; no kernel of its
   own): the golden scenarios of tests/golden/generate_goldens.py (the
   congestion cell at 100 km, 10 ms; the throughput batch at 1 and 300 km,
   8 ms) on the card and on the CPU (eager), held to each other on the
   Fig. 3 columns and the final state (``NETSIM_TOL``); the golden batch for
   512 steps through CUDA graphs and through eager steps on the card, bit
   for bit; two planted faults in the card's run, each of which must read
   over a limit ("ring wraps at delay_pad instead of each scenario's
   d_steps" on the batch that mixes distances, "MatchRDMA's source-OTN
   release ignores the budget gate"); then Fig. 3b at full width through
   ``launch.netsim``: 7 distances x 6 message sizes = 42 cells of 4 flows at
   44 ms (8,800 steps; a fifth of the paper's 220 ms, so that phase 11 fits),
   one [B=42] batch per scheme, with its wall time, cell-steps per second,
   device ms per step (CUDA events), kernels per step (100 eager steps under
   the profiler), the device's idle share (a profiled graph replay), the
   rows and the max speedup vs DCQCN.
11. the seven schemes over the multi-link and multi-site long haul (the
   related-work pack geopipe / sdr_rdma / rdmacell, the [L] link axis, site
   graphs; again no kernel of its own): card vs CPU with phase 10's limits
   for the three on the golden scenarios, and for all seven on a
   three-link delay-spread cell of scheme_compare's topology grid and on
   its 3-site mesh (4 ms each); graphs vs eager steps bit for bit for the
   three on the golden batch and all seven on the three-link cell; two
   planted faults that must read over a limit ("every link's ring read at
   link 0's delay", "rdmacell's route_weights returns the base route");
   then ``launch.netsim``'s ``scheme_compare`` (7 distances at 44 ms, a
   fifth of its 220 ms, so that phase 12 fits; one [B=7] batch a scheme) and
   ``topology`` (3 x 3 unequal three-link cells, 20 ms, [B=9]) grids with
   their row asserts, wall, cell-steps per second, device ms and kernels per
   step for each scheme.
12. the impaired, replayed and failing long haul (the channel models, the
   threefry PRNG, the loss-repair path, failure schedules, the hardened
   runner; again no kernel of its own): the threefry draws on the card bit
   for bit against the CPU's over 2^20 counters; card vs CPU with phase 10's
   limits for all seven schemes on the golden congestion cell under the
   ``impaired`` channel (loss, jitter and flap, 4 ms), on the 3-site mesh
   under ``trace_replay`` at schedule scale 1 and on the link-0 and site
   outages of three links (4 ms); graphs vs eager steps bit for bit on
   those; three planted faults, each of which must fail its check ("the
   step key folded from a count read at capture time": graph vs eager;
   "a dead link's arrivals delivered, not dumped": card vs CPU; "loss
   notifications never reach the retransmit backlog": ``strict_conservation``
   must raise ``ConservationError``); the kernels one step's draws launch;
   then ``launch.netsim``'s ``impairment`` (6 cells), ``sites`` (9) and
   ``failover`` (6) grids at full width (20 ms, one batch a scheme) with
   their asserts, rows, wall, capture, cell-steps per second, device ms and
   kernels per step for each scheme.

Each serving and training path runs with every kernel's launch count set to
0 just before it and read just after. The last lines are the serving,
training, netsim, multi-link and channel netsim JSON records, the card's
``name, power.limit``, the kernels' JSON record, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

QWEN, MAMBA, RG = "qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-2b"
# launch.serve's default workload of each arch: (batch, prompt_len, max_new)
WORKLOADS = {QWEN: (4, 512, 32), MAMBA: (4, 2048, 32), RG: (4, 4096, 32)}
# (num_layers, d_model, vocab_size) at the published widths
FULL_WIDTH = {QWEN: (24, 1024, 151936), MAMBA: (48, 1024, 50280), RG: (26, 2560, 256000)}
PEAK_FLOPS_BF16 = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_FLOPS_F32 = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# (atol, rtol) of flash attention against the plain version computed in f32
# on the same input values: f32 sums in another order; bf16 adds one output
# rounding (2^-9 relative) to that.
KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}
# SSD scan, max abs error / max |reference| against the step-by-step oracle
# in f32 on the same input values: y in f32 as tests/test_kernels.py holds
# the Pallas kernel (1e-4); y in bf16 adds one output rounding (2^-9 of |y|);
# the final state is f32 either way.
SSD_TOL = {"float32": 1e-4, "bfloat16": 8e-3}
STATE_TOL = 1e-4
# bf16 SSD scan against its plain version with the same roundings of xdt and
# C B^T L (y in f32), as tests/test_torch_kernels_cuda.py: one output rounding
# (2^-9 of |y|) plus products that another f32 summation order rounds to the
# neighbouring bf16 value.
SSD_ROUNDED_TOL = 5e-3
# RG-LRU scan, max abs error against the step-by-step oracle in f32 on the
# same input values (tests/test_kernels.py holds the Pallas kernel to 1e-5).
RGLRU_TOL = 1e-5
# (b, s, hq, hk, d, window) of windowed flash attention at recurrentgemma-2b's
# serving shape, and (b, s, w) of its RG-LRU scan
WINDOWED_SERVING = (4, 4096, 10, 1, 256, 2048)
RGLRU_SERVING = (4, 4096, 2560)
# (b, s, h, p, g, n, chunk) of the SSD scan at the mamba2-370m serving shape
SSD_SERVING = (4, 2048, 32, 64, 1, 128, 128)
# Card (bf16 activations, kernels) vs CPU (f32, plain path) prefill of the
# same weights (see PERF.md), each reading relative to the largest value of
# its reference: bf16 rounds the residual stream at every layer.
# qwen, the last position's logits: sound runs read 1.6e-2 to 1.7e-2
# (1.653e-2 since the bf16 kernel rounds P to bf16); a dropped causal mask
# must read above the limit.
# mamba2, the logits and the first layer's final SSD state: the SSD part of a
# random-weight block is small beside its D * x skip, so the last position's
# logits barely see a state that is not carried across chunks, while the
# first layer's state, where bf16 has rounded least, does. The control
# "state not carried" must read above one of the limits.
# recurrentgemma-2b, the (softcapped) logits and the first layer's final
# RG-LRU state: sound runs read 4.7e-2 and 5.4e-3; a recurrence restarted
# every 256 steps (the TPU kernel's carry across sequence blocks dropped)
# reads 1.37 and 0.84 and must read above one of the limits.
# Phase 3 is the gate for each kernel's precision.
CARD_VS_CPU_TOL = {QWEN: {"logits": 3e-2},
                   MAMBA: {"logits": 1e-1, "layer-0 state": 5e-2},
                   RG: {"logits": 1e-1, "layer-0 state": 2e-2}}
REF_LEN = {QWEN: 128, MAMBA: 300, RG: 300}   # prompt of the card-vs-CPU check, B=1
STATE_KEY = {MAMBA: "ssm", RG: "h"}          # the first layer's cache entry read
# Each autograd Function's grads against autograd through the kernel's plain
# version on the same inputs, max abs error / max |reference grad|. f32: the
# same function in other summation orders. bf16: both sides round the grads
# to bf16, and the backward's recompute rounds as the JAX model path does (P
# to bf16 before P.V; xdt and C B^T L to bf16) where the plain version keeps
# f32: a few bf16 ulps (2^-8 relative) of the largest grad.
GRAD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# Card vs CPU (f32, plain path) loss and grads of the same weights at B=1 and
# REF_LEN, each relative to its reference (the grads: max abs error over max
# |ref|). The readings: the loss, embed.tok, the first layer's mixer input
# projection, the last layer's MLP output projection (mamba2: the mixer's),
# and for mamba2 the first layer's A_log (the only leaf dA reaches). With
# the card in bf16 every layer rounds the residual stream and the grads:
# percent-level readings (see PERF.md). With the card in f32 the two sides
# differ in summation order only. A planted fault in a backward must read
# above a limit: the RG-LRU one moves the grads by a few 1e-3, under bf16's
# rounding, so the f32 readings are the ones that catch it.
TRAIN_READ = {
    QWEN: ("embed.tok", "backbone.layers.0.attn.wq", "backbone.layers.23.mlp.w_down"),
    MAMBA: ("embed.tok", "backbone.layers.0.ssd.w_x", "backbone.layers.47.ssd.w_out",
            "backbone.layers.0.ssd.A_log"),
    RG: ("embed.tok", "backbone.layers.0.rglru.w_x", "backbone.layers.25.mlp.w_down"),
}
# bf16: sound readings up to 1.39e-1 on an H100 (mamba2's A_log; qwen's
# 3.1e-2): about twice that. f32: sound readings up to 1.5e-5; the limits
# leave a factor near 70 and sit below the RG-LRU fault (about 5e-3 in a
# CPU emulation at five layers).
TRAIN_VS_CPU_TOL = {"bfloat16": {"loss": 1e-3, "grads": 3e-1},
                    "float32": {"loss": 1e-5, "grads": 1e-3}}
# Phase 10, the netsim Fig. 3 path: the golden scenarios of
# tests/golden/generate_goldens.py, (distances km, workload builder and its
# arguments, horizon us), and the paper's four schemes.
NETSIM_GOLDEN = {
    "seq": ((100.0,), "congestion_workload",
            dict(num_inter=4, num_intra=4, burst_start_us=3_000.0,
                 burst_len_us=4_000.0, horizon_us=10_000.0), 10_000.0),
    "batch": ((1.0, 300.0), "throughput_workload",
              dict(msg_size=1 << 20, concurrency=1, num_flows=4), 8_000.0),
}
NETSIM_SCHEMES = ("dcqcn", "pseudo_ack", "themis", "matchrdma")
# Card (CUDA graphs) vs CPU (eager) on those scenarios, each reading the
# largest over the cells: the Fig. 3 columns relative to the CPU's (pause
# ratio absolute; a 100-byte floor under the buffers and 1e-4 Gbps under the
# throughput, where a drained queue holds f32 residues of a few bytes), the
# final sent/delivered relative to their largest value, completion times in
# us. The card multiplies by a constant's reciprocal where the CPU divides
# and sums in another order, an ulp a step apart; runs that sit on a hard
# threshold part there and stay two trajectories of one system. The limits
# are those the CPU tests hold the port to against JAX (tests/torch_parity.py).
NETSIM_TOL = {"throughput": 1e-3, "peak_buffer": 1e-3, "mean_buffer": 1e-3,
              "p99_buffer": 1e-3, "pause_ratio": 1e-3, "final": 1e-4,
              "done_at_us": 5.0}
NETSIM_FLOOR = {"throughput": 1e-4 * 1e9 / 8.0, "peak_buffer": 100.0,
                "mean_buffer": 100.0, "p99_buffer": 100.0}
NETSIM_GRAPH_STEPS = 512   # graph vs eager on the card, the golden batch
# Fig. 3b's horizon here: a fifth of the paper's 220 ms (8,800 steps), so
# that phases 10 and 11 together fit the script's time; the full depth runs
# through `python -m repro_torch.launch.netsim --figure fig3b --full`.
NETSIM_FIG3B_H_US = 44_000.0
# Phase 11, the seven schemes over the multi-link and multi-site long haul:
# the related-work pack, and two multi-link scenarios: one
# delay-spread cell of benchmarks/scheme_compare.py's topology grid (100 km,
# three links, delays x1/x2/x4, capacities 0.6/0.3/0.1) under the golden
# congestion workload, and scheme_compare's 3-site mesh (SITES_EDGES) under
# its _sites_workload; cut to 4 ms, as the CPU side runs eagerly.
NETSIM_RELATED = ("geopipe", "sdr_rdma", "rdmacell")
NETSIM_ALL = NETSIM_SCHEMES + NETSIM_RELATED
NETSIM_LINKS3 = dict(distance_km=100.0, num_paths=3, path_delay_scale=(1.0, 2.0, 4.0),
                     path_cap_frac=(0.6, 0.3, 0.1))
NETSIM_LINKS_H_US = 4_000.0
# scheme_compare's distance grid in phase 11: a fifth of its 220 ms (8,800
# steps), so that phase 12 fits the script's time
NETSIM_COMPARE_H_US = 44_000.0
# Phase 12, the channel and failure paths: the golden congestion cell under
# the impaired channel (tests/test_channel.py's conservation knobs), the
# 3-site mesh under its replayed schedule at amplitude 1, and link-0 and
# site outages on three unequal links at 100 km under a streaming workload;
# 4 ms each, as the CPU side runs eagerly (the draws ~500 ops a step).
NETSIM_IMPAIRED = dict(distance_km=100.0, loss_rate=0.01, loss_burst_len=4.0,
                       jitter_us=20.0, flap_period_us=2_000.0, flap_depth=0.5)
NETSIM_CHANNEL_H_US = 4_000.0
NETSIM_CHANNEL_SCHEMES = ("dcqcn", "matchrdma", "rdmacell")
# the site outage with sdr_rdma in rdmacell's place: rdmacell's site-outage
# run parts between card and CPU within 4 ms (final sent 1.383e-3 apart on an
# H100 80GB HBM3 at 700 W), as it parts from JAX at step 401 on its
# reorder-buffer trace
NETSIM_SITE_SCHEMES = ("dcqcn", "matchrdma", "sdr_rdma")
# graphs vs eager on the channel cases: 192 steps through graphs of 64
NETSIM_CHANNEL_GRAPH = (192, 64)
# profiled eager steps a scheme for the phase 12 figures' kernel counts
NETSIM_CHANNEL_PROFILE_STEPS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS_BF16):
    """(least time in ms, what bounds it): operations at the peak of their
    type (bf16 unless said) or bytes at the memory rate, whichever takes longer."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bound_ms(b: int, s: int, hq: int, hk: int, d: int, itemsize: int,
                       window: int = 0):
    """Least time for causal attention on these inputs: its operations (QK^T and
    P.V over the (query, key) pairs in the causal band: S(S+1)/2, or with a
    window W < S, W(W+1)/2 + (S-W)W) and its bytes (q, k, v read once, o
    written once)."""
    w = window if 0 < window < s else s
    pairs = w * (w + 1) / 2 + (s - w) * w
    return bound(4.0 * b * hq * d * pairs, 2.0 * b * s * (hq + hk) * d * itemsize)


def rglru_bound_ms(b: int, s: int, w: int, itemsize: int):
    """Least time for the RG-LRU recurrence on these inputs: a multiply and an
    add an element in f32, and its bytes (a and b read once in their dtype, h
    written once in f32)."""
    n = b * s * w
    return bound(2.0 * n, n * (2 * itemsize + 4), PEAK_FLOPS_F32)


def ssd_bound_ms(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
                 itemsize: int):
    """Least time for the SSD scan on these inputs: its operations (per head
    and chunk, C B^T and its product with xdt, 2L^2(n+p), and C.state and
    the state update, 4Lnp) and its bytes (x, B, C read once in their dtype,
    dt and A in f32; y written once in x's dtype, the final state in f32)."""
    nc = -(-s // chunk)
    flops = b * h * nc * (2.0 * chunk ** 2 * (n + p) + 4.0 * chunk * n * p)
    nbytes = (2 * b * s * h * p * itemsize + 2 * b * s * g * n * itemsize
              + 4 * (b * s * h + h) + 4 * b * h * n * p)
    return bound(flops, nbytes)


def tensor_core_instr(source: str, key) -> dict:
    """HGMMA count in the SASS of each kernel instantiation of the built
    library of ``source`` that ``key`` names (it maps a SASS function line to
    a name, or None to skip it), from ``cuobjdump -sass``."""
    from repro_torch.kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(source))],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()[-2000:]}")
    counts, current = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            current = key(line)
            if current:
                counts[current] = 0
        elif current and "HGMMA" in line:
            counts[current] += 1
    return counts


def flash_instantiation(line: str):
    """"D=<d> windowed=<0|1>" of a bf16 flash instantiation, else None."""
    import re
    name = re.search(r"fa_fwd_bf16_kernelILi(\d+)ELb([01])E", line)
    return f"D={name.group(1)} windowed={name.group(2)}" if name else None


def ssd_instantiation(line: str):
    """"bf16" or "f32 PT=<pt>" of an SSD-scan instantiation, else None."""
    import re
    if "ssd_bf16_kernel" in line:
        return "bf16"
    name = re.search(r"ssd_f32_kernelILi(\d+)E", line)
    return f"f32 PT={name.group(1)}" if name else None


def _wrappers() -> dict:
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd
    return {"flash_attention": flash_attention_fwd, "ssd_scan": ssd_scan_fwd,
            "rglru_scan": rglru_scan_fwd}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def top_kernel(torch, fn) -> str:
    """Name of the CUDA kernel that takes most of one call's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return max(kernels, key=lambda e: e.self_device_time_total).key[:120] if kernels else "?"


def phase_flash(torch, card: str) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.launch.train import TRAIN_WORKLOADS

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch, prompt_len, _ = WORKLOADS[QWEN]
    train_batch, train_len, _ = TRAIN_WORKLOADS[QWEN]

    def inputs(b, s, hq, hk, d, dtype):
        return tuple(torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
                     for h in (hq, hk, hk))

    cases = [  # name, B, S, Hq, Hk, D, dtype, softcap
        ("serving shape", batch, prompt_len, 16, 16, 64, "bfloat16", 0.0),
        ("serving shape", batch, prompt_len, 16, 16, 64, "bfloat16", 20.0),
        ("serving shape", batch, prompt_len, 16, 16, 64, "float32", 0.0),
        ("training shape", train_batch, train_len, 16, 16, 64, "bfloat16", 0.0),
        ("training shape", train_batch, train_len, 16, 16, 64, "float32", 0.0),
        ("gqa 8/2 d128", 2, 512, 8, 2, 128, "bfloat16", 0.0),
        ("gqa 8/2 d128", 2, 512, 8, 2, 128, "float32", 20.0),
        ("ragged S=1000", 2, 1000, 8, 2, 128, "bfloat16", 30.0),
        ("ragged S=1000", 2, 1000, 16, 16, 64, "float32", 0.0),
        ("ragged d256", 1, 300, 4, 2, 256, "bfloat16", 0.0),
        ("ragged d32", 2, 77, 6, 2, 32, "float32", 50.0),
        ("head dim 8", 2, 300, 4, 2, 8, "bfloat16", 0.0),    # padded to D=16
        ("head dim 8", 2, 300, 4, 2, 8, "float32", 20.0),
        ("head dim 192", 2, 300, 4, 2, 192, "bfloat16", 0.0),
        ("head dim 192", 2, 300, 4, 2, 192, "bfloat16", 20.0),
        ("head dim 192", 2, 300, 4, 2, 192, "float32", 0.0),
    ]
    checks = []
    for name, b, s, hq, hk, d, dtype, softcap in cases:
        q, k, v = inputs(b, s, hq, hk, d, getattr(torch, dtype))
        out = ops.flash_attention(q, k, v, softcap=softcap)
        torch.cuda.synchronize()
        ref = attention_ref(q.float(), k.float(), v.float(), softcap=softcap)
        atol, rtol = KERNEL_TOL[dtype]
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        ok = bool((diff <= atol + rtol * ref.abs()).all()) and out.dtype == q.dtype
        print(f"  flash_attention {name:14s} B={b} S={s} Hq={hq} Hk={hk} D={d} "
              f"{dtype:8s} softcap={softcap:4.1f}: max_abs_err={err:.3e} "
              f"(tolerance |err| <= {atol:g} + {rtol:g}|ref|) {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"flash_attention disagrees with attention_ref at {name} {dtype}")
        checks.append({"case": f"{name} {dtype} softcap={softcap}", "max_abs_err": err,
                       "atol": atol, "rtol": rtol})

    b, s, hq, hk, d, w = WINDOWED_SERVING
    windowed_cases = [  # name, B, S, Hq, Hk, D, window
        ("windowed serving", b, s, hq, hk, d, w),
        ("windowed ragged", 2, 1000, hq, hk, d, 100),
        ("windowed W=1", 2, 300, 4, 2, 64, 1),
        ("windowed W>=S", 2, 300, hq, hk, d, 300),
        ("windowed d192", 2, 300, 4, 2, 192, 100),
        ("windowed d8", 2, 300, 4, 2, 8, 100),
    ]
    for name, b, s, hq, hk, d, w in windowed_cases:
        for dtype in ("float32", "bfloat16"):
            q, k, v = inputs(b, s, hq, hk, d, getattr(torch, dtype))
            out = ops.flash_attention(q, k, v, window=w)
            torch.cuda.synchronize()
            ref = attention_ref(q.float(), k.float(), v.float(), window=w)
            atol, rtol = KERNEL_TOL[dtype]
            diff = (out.float() - ref).abs()
            err = float(diff.max())
            ok = bool((diff <= atol + rtol * ref.abs()).all()) and out.dtype == q.dtype
            if w >= s:   # the window covers every key: causal attention exactly
                ok = ok and bool(torch.equal(out, ops.flash_attention(q, k, v)))
            del ref, diff
            print(f"  flash_attention {name:16s} B={b} S={s} Hq={hq} Hk={hk} D={d} W={w} "
                  f"{dtype:8s}: max_abs_err={err:.3e} (tolerance |err| <= {atol:g} + "
                  f"{rtol:g}|ref|) {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"windowed flash_attention disagrees with attention_ref at {name} {dtype}")
            checks.append({"case": f"{name} {dtype} window={w}", "max_abs_err": err,
                           "atol": atol, "rtol": rtol})

    timings = {}
    for s in (prompt_len, 4096):
        b, h, d = batch, 16, 64
        q, k, v = inputs(b, s, h, h, d, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, S, D] views
        iters = 50 if s <= 512 else 10
        ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v), iters)
        plain_ms = time_ms(torch, lambda: attention_ref(q, k, v), max(iters // 5, 2))
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters)
        bound_ms, bound_by = attention_bound_ms(b, s, h, h, d, 2)
        timings[s] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"  flash_attention B={b} S={s} H={h} D={d} bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} "
              f"ms ({bound_by}) [{card}]", flush=True)

    b, s, hq, hk, d, w = WINDOWED_SERVING
    q, k, v = inputs(b, s, hq, hk, d, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    i = torch.arange(s, device=dev)
    band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)   # True: attend

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, enable_gqa=True)

    ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v, window=w), 10)
    plain_ms = time_ms(torch, lambda: attention_ref(q, k, v, window=w), 2)
    library_ms = time_ms(torch, library, 10)
    library_kernel = top_kernel(torch, library)
    bound_ms, bound_by = attention_bound_ms(b, s, hq, hk, d, 2, window=w)
    windowed = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "library_kernel": library_kernel, "bound_ms": bound_ms, "bound_by": bound_by,
                "shape": f"B={b} S={s} Hq={hq} Hk={hk} D={d} W={w} bf16"}
    print(f"  flash_attention windowed B={b} S={s} Hq={hq} Hk={hk} D={d} W={w} bf16: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (band mask, enable_gqa) "
          f"{library_ms:.4f} ms [{library_kernel}], bound {bound_ms:.4f} ms ({bound_by}) "
          f"[{card}]", flush=True)
    return {"checks": checks, "timings": timings, "windowed": windowed}


def phase_ssd(torch, card: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_ref
    from repro_torch.kernels.ssd_scan import ssd_scan_fwd

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, s, h, p, g, n, dtype):
        """x, B, C in ``dtype``; dt and A in f32, as the model gives them."""
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = randn(b, s, h, p).to(dtype)
        dt = torch.nn.functional.softplus(randn(b, s, h))
        A = -torch.exp(randn(h) * 0.5)
        B = (randn(b, s, g, n) * 0.3).to(dtype)
        C = (randn(b, s, g, n) * 0.3).to(dtype)
        return x, dt, A, B, C

    def rel(out, ref):
        return float((out.float() - ref).abs().max()) / (float(ref.abs().max()) + 1e-6)

    cases = [  # name, (b, s, h, p, g, n, chunk)
        ("serving shape", SSD_SERVING),
        ("ragged S=1000", (2, 1000, 32, 64, 1, 128, 128)),
        ("groups g=2 h=8", (2, 512, 8, 64, 2, 128, 128)),
        ("chunk L=64", (2, 1000, 8, 64, 1, 128, 64)),
        ("smoke shape", (2, 300, 4, 32, 1, 16, 32)),
    ]
    checks = []
    for name, (b, s, h, p, g, n, chunk) in cases:
        for dtype in ("float32", "bfloat16"):
            x, dt, A, B, C = inputs(b, s, h, p, g, n, getattr(torch, dtype))
            y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
            torch.cuda.synchronize()
            y_ref, state_ref = ssd_ref(x.float(), dt, A, B.float(), C.float())
            err_y, err_state = rel(y, y_ref), rel(state, state_ref)
            abs_err = float((y.float() - y_ref).abs().max())
            ok = (err_y <= SSD_TOL[dtype] and err_state <= STATE_TOL and y.dtype == x.dtype
                  and tuple(state.shape) == (b, h, n, p))
            rounded = ""
            if dtype == "bfloat16":   # the plain version with the kernel's roundings
                y_rnd, _ = ops.ssd_scan_plain(x.float(), dt, A, B, C, chunk=chunk,
                                              round_to=torch.bfloat16)
                err_rnd = rel(y, y_rnd)
                ok = ok and err_rnd <= SSD_ROUNDED_TOL
                rounded = f", y vs rounded plain rel={err_rnd:.3e} (tolerance {SSD_ROUNDED_TOL:g})"
                del y_rnd
            print(f"  ssd_scan {name:15s} b={b} s={s} h={h} p={p} g={g} n={n} L={chunk} "
                  f"{dtype:8s}: y max_abs_err={abs_err:.3e} rel={err_y:.3e} (tolerance "
                  f"{SSD_TOL[dtype]:g}), state rel={err_state:.3e} (tolerance "
                  f"{STATE_TOL:g}){rounded} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"ssd_scan disagrees with its plain versions at {name} {dtype}")
            checks.append({"case": f"{name} {dtype}", "max_abs_err": abs_err,
                           "rel_err": err_y, "state_rel_err": err_state,
                           "rel_tol": SSD_TOL[dtype], "state_rel_tol": STATE_TOL,
                           **({"rounded_rel_err": err_rnd, "rounded_rel_tol": SSD_ROUNDED_TOL}
                              if rounded else {})})

    b, s, h, p, g, n, chunk = SSD_SERVING
    x, dt, A, B, C = inputs(b, s, h, p, g, n, torch.bfloat16)
    ms = time_ms(torch, lambda: ssd_scan_fwd(x, dt, A, B, C, chunk=chunk), 20)
    plain_ms = time_ms(torch, lambda: ops.ssd_scan_plain(x, dt, A, B, C, chunk=chunk), 5)
    bound_ms, bound_by = ssd_bound_ms(b, s, h, p, g, n, chunk, 2)
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"  ssd_scan b={b} s={s} h={h} p={p} n={n} L={chunk} bf16: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms ({bound_by}) "
          f"[{card}]", flush=True)
    return {"checks": checks, "timing": timing}


def phase_rglru(torch, card: str) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import rglru_chunked_ref, rglru_ref
    from repro_torch.kernels.rglru_scan import CHUNK, rglru_scan_fwd

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(b, s, w, dtype):
        """a = sigmoid(N(0,1)) * 0.2 + 0.79 and b ~ N(0,1), as tests/test_kernels.py."""
        a = torch.sigmoid(torch.randn((b, s, w), generator=gen, device=dev)) * 0.2 + 0.79
        return a.to(dtype), torch.randn((b, s, w), generator=gen, device=dev).to(dtype)

    cases = [  # name, (b, s, w)
        ("serving shape", RGLRU_SERVING),
        ("ragged S=1000", (2, 1000, 200)),
        ("kernel test 1", (2, 128, 256)),
        ("kernel test 2", (1, 300, 64)),
        ("kernel test 3", (3, 64, 512)),
    ]
    checks = []
    for name, (b, s, w) in cases:
        for dtype in ("float32", "bfloat16"):
            a, x = inputs(b, s, w, getattr(torch, dtype))
            h = ops.rglru_recurrence(a, x)
            torch.cuda.synchronize()
            err = float((h - rglru_ref(a, x)).abs().max())
            same = bool(torch.equal(h, rglru_chunked_ref(a, x, CHUNK)))
            ok = (err <= RGLRU_TOL and same and h.dtype == torch.float32
                  and tuple(h.shape) == (b, s, w))
            print(f"  rglru_scan {name:14s} b={b} s={s} w={w} {dtype:8s}: max_abs_err={err:.3e} "
                  f"(tolerance {RGLRU_TOL:g}), equal to rglru_chunked_ref(T={CHUNK}): {same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"rglru_scan disagrees with its plain versions at {name} {dtype}")
            checks.append({"case": f"{name} {dtype}", "max_abs_err": err, "atol": RGLRU_TOL,
                           "equal_to_chunked_plain": same})

    b, s, w = RGLRU_SERVING
    a, x = inputs(b, s, w, torch.float32)      # the model's gates are f32
    ms = time_ms(torch, lambda: rglru_scan_fwd(a, x), 20)
    plain_ms = time_ms(torch, lambda: rglru_ref(a, x), 2)
    bound_ms, bound_by = rglru_bound_ms(b, s, w, 4)
    timing = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"  rglru_scan b={b} s={s} w={w} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library none, bound {bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
    return {"checks": checks, "timing": timing}

def phase_grads(torch, card: str) -> dict:
    """Each op's autograd Function on the card: the grads of every input against
    autograd through the kernel's plain version on the same inputs, f32 and
    bf16; then the Function's forward and forward+backward timed in the
    dtypes the models give it (the RG-LRU gates are f32)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import attention_ref, rglru_ref
    from repro_torch.launch.train import TRAIN_WORKLOADS

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def qkv(b, s, hq, hk, d):
        return lambda dtype: tuple(randn(b, s, h, d).to(dtype) for h in (hq, hk, hk))

    def ssd(b, s, h, p, g, n):
        def make(dtype):
            return (randn(b, s, h, p).to(dtype), torch.nn.functional.softplus(randn(b, s, h)),
                    -torch.exp(randn(h) * 0.5), (randn(b, s, g, n) * 0.3).to(dtype),
                    (randn(b, s, g, n) * 0.3).to(dtype))
        return make

    def gates(b, s, w):
        return lambda dtype: ((torch.sigmoid(randn(b, s, w)) * 0.2 + 0.79).to(dtype),
                              randn(b, s, w).to(dtype))

    qb, qs, _ = WORKLOADS[QWEN]
    tb, ts, _ = TRAIN_WORKLOADS[QWEN]   # S > the backward's 512-query blocks: several recomputed
    _, ws, whq, whk, wd, ww = WINDOWED_SERVING
    b, s, h, p, g, n, chunk = SSD_SERVING
    rb, rs, rw = RGLRU_SERVING
    functions = {   # name: (Function, plain version, [(case, inputs(dtype))], timed dtype)
        "flash_attention": (
            lambda *t: ops.flash_attention(*t), lambda *t: attention_ref(*t),
            [(f"B={qb} S={qs} H=16 D=64", qkv(qb, qs, 16, 16, 64)),
             (f"B={tb} S={ts} H=16 D=64", qkv(tb, ts, 16, 16, 64))], torch.bfloat16),
        "flash_attention windowed": (
            lambda *t: ops.flash_attention(*t, window=ww),
            lambda *t: attention_ref(*t, window=ww),
            [(f"B=1 S={ws} Hq={whq} Hk={whk} D={wd} W={ww}", qkv(1, ws, whq, whk, wd))],
            torch.bfloat16),
        "ssd_scan": (
            lambda *t: ops.ssd_scan(*t, chunk=chunk)[0],
            lambda *t: ops.ssd_scan_plain(*t, chunk=chunk)[0],
            [(f"b={b} s={s} h={h} p={p} g={g} n={n} L={chunk}", ssd(b, s, h, p, g, n))],
            torch.bfloat16),
        "rglru_scan": (
            ops.rglru_recurrence, rglru_ref,
            [(f"b={rb} s={rs} w={rw}", gates(rb, rs, rw)), (f"b={rb} s=1 w={rw}", gates(rb, 1, rw)),
             (f"b={rb} s=1000 w={rw}", gates(rb, 1000, rw))], torch.float32),
    }

    def leaves(inputs):
        return [t.detach().clone().requires_grad_(True) for t in inputs]

    def grads(fn, inputs, cot):
        ls = leaves(inputs)
        return torch.autograd.grad(fn(*ls), ls, cot)

    out = {}
    for name, (fn, plain, cases, timed_dtype) in functions.items():
        checks = []
        for case, make in cases:
            for dtype in ("float32", "bfloat16"):
                inputs = make(getattr(torch, dtype))
                y = fn(*inputs)
                cot = randn(*y.shape).to(y.dtype)
                got, ref = grads(fn, inputs, cot), grads(plain, inputs, cot)
                torch.cuda.synchronize()
                errs = [float((a.float() - r.float()).abs().max()) / (float(r.abs().max()) or 1.0)
                        for a, r in zip(got, ref)]
                finite = all(bool(torch.isfinite(a).all()) for a in got)
                ok = finite and max(errs) <= GRAD_TOL[dtype] and all(
                    a.dtype == r.dtype for a, r in zip(got, ref))
                print(f"  grad {name} {case} {dtype:8s}: max_abs_err/max|ref| per input "
                      f"{', '.join(f'{e:.3e}' for e in errs)} (tolerance {GRAD_TOL[dtype]:g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"the {name} Function's grads disagree with its plain version "
                          f"at {case} {dtype}")
                checks.append({"case": f"{case} {dtype}", "rel_errs": errs,
                               "rel_tol": GRAD_TOL[dtype]})
                del inputs, y, cot, got, ref
        inputs = cases[0][1](timed_dtype)
        y = fn(*inputs)
        cot = randn(*y.shape).to(y.dtype)
        big = "windowed" in name or name == "ssd_scan"
        fwd_ms = time_ms(torch, lambda: fn(*inputs), 5 if big else 20)
        fwd_bwd_ms = time_ms(torch, lambda: grads(fn, inputs, cot), 3 if big else 10)
        plain_fwd_bwd_ms = time_ms(torch, lambda: grads(plain, inputs, cot), 2, warmup=1)
        out[name] = {"shape": f"{cases[0][0]} {str(timed_dtype).removeprefix('torch.')}",
                     "fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_bwd_ms, "bwd_ms": fwd_bwd_ms - fwd_ms,
                     "plain_fwd_bwd_ms": plain_fwd_bwd_ms, "checks": checks}
        print(f"  {name} Function {out[name]['shape']}: forward {fwd_ms:.4f} ms, forward+"
              f"backward {fwd_bwd_ms:.4f} ms (backward {fwd_bwd_ms - fwd_ms:.4f} ms), plain "
              f"version forward+backward {plain_fwd_bwd_ms:.4f} ms [{card}]", flush=True)
        del inputs, y, cot
        torch.cuda.empty_cache()
    return out


def f32_copy(torch, model, device="cpu"):
    """The same weights in f32 on ``device``, copied parameter by parameter
    into a model made on ``meta`` (no second whole copy of the state dict)."""
    from repro_torch.models import build_model
    cfg = dataclasses.replace(model.cfg, act_dtype="float32", param_dtype="float32")
    copy = build_model(cfg, device="meta").to_empty(device=device)
    dst = copy.state_dict()
    with torch.no_grad():
        for name, t in model.state_dict().items():
            dst[name].copy_(t)
    return copy


def phase_serve(torch, card: str, arch: str, planted: dict, must_fail: str) -> dict:
    """Serves ``arch`` at full width through launch.serve and checks it.

    ``planted`` maps a fault's name to (module, attribute, replacement): the
    card-vs-CPU logits check is read again with each in place of the kernel's
    op, and the reading of ``must_fail`` must exceed the limit."""
    from repro_torch.config.base import ATTN, LOCAL_ATTN, RGLRU, SSD
    from repro_torch.launch import serve as launch_serve

    batch, prompt_len, max_new = WORKLOADS[arch]
    check(tuple(launch_serve.WORKLOADS[arch]) == WORKLOADS[arch],
          f"chip_smoke's {arch} workload is not launch.serve's default workload")
    model = launch_serve.build(arch, device="cuda")
    cfg = model.cfg
    check((cfg.num_layers, cfg.d_model, cfg.vocab_size) == FULL_WIDTH[arch],
          f"{arch} is not at full width: {cfg}")
    mixers = [mixer for mixer, _ in cfg.layer_blocks()]
    expected = {"flash_attention": mixers.count(ATTN) + mixers.count(LOCAL_ATTN),
                "ssd_scan": mixers.count(SSD), "rglru_scan": mixers.count(RGLRU)}
    prompt = launch_serve.random_prompt(model, batch, prompt_len)
    launch_serve.serve(model, prompt, 2)     # warm-up: cuBLAS handles, allocator

    reset_counts()
    res = launch_serve.serve(model, prompt, max_new)
    launches = read_counts()
    print(f"  serve {arch} B={batch} prompt={prompt_len} new={max_new}: prefill "
          f"{res.prefill_ms:.2f} ms, decode {res.decode_tok_s:.1f} tok/s "
          f"({res.decode_tokens} tokens in {res.decode_ms:.2f} ms), launches {launches} "
          f"[{card}]", flush=True)
    check(launches == expected, f"kernel launches {launches} in one prefill, expected "
          f"{expected} (one per layer of the kernel's mixer)")
    check(tuple(res.tokens.shape) == (batch, max_new), f"tokens {tuple(res.tokens.shape)}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()), "token out of range")
    for name, t in (("prefill", res.prefill_logits), ("last decode", res.logits)):
        check(tuple(t.shape) == (batch, cfg.vocab_size) and t.dtype == torch.float32,
              f"{name} logits {tuple(t.shape)} {t.dtype}")
        check(bool(torch.isfinite(t).all()), f"{name} logits are not finite")

    # The same weights' prefill in f32 on the CPU through the plain path.
    ref_len, limits = REF_LEN[arch], CARD_VS_CPU_TOL[arch]
    small = launch_serve.random_prompt(model, 1, ref_len, seed=2)
    reset_counts()
    card_out = model.prefill(small, max_len=ref_len)
    check(read_counts() == expected, "reference prefill missed the kernels")
    cpu_model = f32_copy(torch, model)
    cpu_caches, cpu_logits = cpu_model.prefill(small.cpu(), max_len=ref_len)
    del cpu_model
    refs = {"logits": cpu_logits}
    if "layer-0 state" in limits:
        refs["layer-0 state"] = cpu_caches[0][STATE_KEY[arch]]

    def readings_of(out) -> dict:
        caches, logits = out
        got = {"logits": logits, "layer-0 state": caches[0].get(STATE_KEY.get(arch))}
        return {k: float((got[k].cpu() - ref).abs().max()) / float(ref.abs().max())
                for k, ref in refs.items()}

    sound = readings_of(card_out)
    same_top = bool((card_out[1].argmax(-1).cpu() == cpu_logits.argmax(-1)).all())
    print(f"  card bf16 vs CPU f32 prefill (B=1, S={ref_len}), max_abs_err / max|ref|: "
          + ", ".join(f"{k} {v:.3e} (tolerance {limits[k]:g})" for k, v in sound.items())
          + f"; same argmax={same_top}", flush=True)
    check(all(v <= limits[k] for k, v in sound.items()),
          f"{arch}: card prefill disagrees with the CPU f32 path")

    # Controls: the same readings with a fault planted in place of the kernel.
    controls = {}
    for fault, (module, attr, fn) in planted.items():
        kernel_path = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            controls[fault] = readings_of(model.prefill(small, max_len=ref_len))
        finally:
            setattr(module, attr, kernel_path)
        print(f"  control, {fault}: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                                   controls[fault].items()), flush=True)
    check(any(v > limits[k] for k, v in controls[must_fail].items()),
          f"the card-vs-CPU check does not catch: {must_fail}")
    return {"arch": arch, "batch": batch, "prompt_len": prompt_len, "max_new": max_new,
            "launches": launches, "prefill_ms": res.prefill_ms,
            "decode_tok_s": res.decode_tok_s, "card_vs_cpu": sound,
            "card_vs_cpu_tol": limits, "planted": controls}


def qwen_faults(torch) -> dict:
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import transformer

    def mask_dropped(q, k, v):   # qwen: Hq = Hk
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.float()).to(q.dtype)

    def p_bf16(q, k, v):
        return attention_ref(q, k, v, p_dtype=torch.bfloat16)

    return {"P rounded to bf16": (transformer, "flash_attention", p_bf16),
            "causal mask dropped": (transformer, "flash_attention", mask_dropped)}


def mamba_faults(torch) -> dict:
    from repro_torch.kernels.ops import ssd_scan_plain
    from repro_torch.models import ssm

    def state_not_carried(x, dt, A, B, C, *, chunk):
        """Each chunk scanned from a zero state: y_off dropped."""
        s = x.shape[1]
        step = min(chunk, s)
        parts = [ssd_scan_plain(x[:, i:i + step], dt[:, i:i + step], A, B[:, i:i + step],
                                C[:, i:i + step], chunk=step) for i in range(0, s, step)]
        return torch.cat([y for y, _ in parts], dim=1), parts[-1][1]

    def model_path_rounding(x, dt, A, B, C, *, chunk):
        """ssd_chunked in x's dtype, as the JAX model path runs it."""
        return ssm.ssd_chunked(x, dt, A, B, C, chunk=chunk)

    return {"state not carried across chunks": (ssm, "ssd_scan", state_not_carried),
            "xdt and C B^T L rounded to bf16": (ssm, "ssd_scan", model_path_rounding)}


def rglru_faults(torch) -> dict:
    from repro_torch.kernels.ops import rglru_recurrence
    from repro_torch.models import rglru

    def restarted(a, b):
        """The recurrence from a zero state at every 256th step: the TPU
        kernel's carry across sequence blocks dropped."""
        return torch.cat([rglru_recurrence(a[:, i:i + 256], b[:, i:i + 256])
                          for i in range(0, a.shape[1], 256)], dim=1)

    return {"recurrence restarted every 256 steps": (rglru, "rglru_recurrence", restarted)}


def train_faults(torch) -> dict:
    """Per arch: {fault: (module, attribute, replacement)}, each a fault planted
    in a Function's backward (the forward on the card is the kernel's)."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention, ssm

    def no_causal_mask(q, k, v, *, softcap=0.0, window=0):   # qwen: Hq = Hk
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
        return torch.einsum("bhqk,bkhd->bqhd", sc.softmax(-1), v.float()).to(q.dtype)

    ssd_chunked = ssm.ssd_chunked

    def da_dropped(x, dt, A, B, C, **kwargs):
        return ssd_chunked(x, dt, A.detach(), B, C, **kwargs)

    def a_not_shifted(a, h, gh):
        g = ops._recurrence(a.flip(1).to(gh.dtype), gh.flip(1)).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        return g * h_prev, g

    return {
        QWEN: {"flash backward without the causal mask":
               (attention, "model_path_attention", no_causal_mask)},
        MAMBA: {"SSD backward with dA dropped": (ssm, "ssd_chunked", da_dropped)},
        RG: {"RG-LRU backward with a_t in place of a_{t+1}":
             (ops, "rglru_reverse", a_not_shifted)},
    }


def expected_train_launches(cfg) -> dict:
    """Kernel launches in one train step under remat "block": a kernel in a
    rematerialised pattern group runs in the forward and in the recompute,
    one in a remainder layer once; the RG-LRU backward runs its kernel once
    more (the reverse recurrence)."""
    from repro_torch.config.base import ATTN, LOCAL_ATTN, SSD
    n_pat = len(cfg.block_pattern or (None,))
    n_grouped = cfg.num_layers - cfg.num_layers % n_pat
    out = {"flash_attention": 0, "ssd_scan": 0, "rglru_scan": 0}
    for i, (mixer, _) in enumerate(cfg.layer_blocks()):
        runs = 2 if i < n_grouped else 1
        if mixer in (ATTN, LOCAL_ATTN):
            out["flash_attention"] += runs
        elif mixer == SSD:
            out["ssd_scan"] += runs
        else:
            out["rglru_scan"] += runs + 1
    return out


def _bits(torch, t):
    """The tensor's bits as an integer tensor of its width (for bitwise equality)."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def check_checkpoint(torch, model, opt_state) -> dict:
    """Saves the trained state under build/, restores it, compares bit for bit."""
    import shutil
    from repro_torch.train import CheckpointManager
    directory = ROOT / "build" / "ckpt-check"
    shutil.rmtree(directory, ignore_errors=True)
    state = {"params": dict(model.named_parameters()),
             "opt": {"step": opt_state.step, "m": opt_state.m, "v": opt_state.v}}
    mgr = CheckpointManager(str(directory), keep=1, async_save=False)
    t0 = time.perf_counter()
    step = int(opt_state.step)
    mgr.save(step, state)
    t1 = time.perf_counter()
    got_step, restored = mgr.restore(None, state)
    t2 = time.perf_counter()
    pairs = list(zip(_flat(state), _flat(restored)))
    same = got_step == step and all(
        pa == pb and a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
        and bool(torch.equal(_bits(torch, a.detach()), _bits(torch, b))) for (pa, a), (pb, b) in pairs)
    nbytes = sum(a.numel() * a.element_size() for (_, a), _ in pairs)
    shutil.rmtree(directory, ignore_errors=True)
    print(f"  checkpoint of the trained state: {len(pairs)} leaves, {nbytes / 1e9:.2f} GB, saved "
          f"in {t1 - t0:.1f} s, restored in {t2 - t1:.1f} s, bit-equal: {same}", flush=True)
    check(same, "the restored checkpoint differs from the saved state")
    return {"leaves": len(pairs), "gb": nbytes / 1e9, "save_s": t1 - t0, "restore_s": t2 - t1,
            "bit_equal": same}


def train_readings(torch, model, batch, names, refs) -> dict:
    """The loss and the grads of ``names`` at ``batch``, each against ``refs``
    (loss: relative error; grads: max abs error / max |ref|)."""
    params = dict(model.named_parameters())
    loss, _ = model.loss_fn(batch)
    # a fault that cuts a leaf off the graph (dA dropped) leaves it a zero grad
    grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True,
                                materialize_grads=True)
    out = {"loss": abs(float(loss.detach()) - refs["loss"]) / abs(refs["loss"])}
    for n, g in zip(names, grads):
        out[n] = float((g.float().cpu() - refs[n]).abs().max()) / float(refs[n].abs().max())
    return out


def over_limits(readings: dict) -> list:
    """The readings above their limits: {precision: {name: value}}."""
    return [f"{p} {n}" for p, r in readings.items() for n, v in r.items()
            if v > TRAIN_VS_CPU_TOL[p]["loss" if n == "loss" else "grads"]]


def phase_train(torch, card: str, arch: str, planted: dict) -> dict:
    """Trains ``arch`` at full width through launch.train and checks it (see
    the module docstring); every fault in ``planted`` must fail the card-vs-CPU
    gradient check."""
    from repro_torch.config.base import TrainConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.train import SyntheticDataset

    dev = torch.device("cuda", 0)
    batch, seq, steps = launch_train.TRAIN_WORKLOADS[arch]
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res = launch_train.main(["--arch", arch])   # no checkpoints at full width
    launches = read_counts()
    model, hist = res.model, res.history
    cfg = model.cfg
    check((cfg.num_layers, cfg.d_model, cfg.vocab_size) == FULL_WIDTH[arch],
          f"{arch} is not at full width: {cfg}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    per_step = {k: v / steps for k, v in launches.items()}
    expected = expected_train_launches(cfg)
    params = sum(p.numel() for p in model.parameters())
    tokens = batch * seq
    for r in hist:
        r["model_flops_share"] = 6.0 * params * tokens / (r["ms"] / 1e3) / PEAK_FLOPS_BF16
        print(f"  train {arch} step {r['step']}: loss {r['loss']:.4f}, grad norm "
              f"{r['grad_norm']:.4f}, lr {r['lr']:.3e}, {r['ms']:.2f} ms, "
              f"{r['tokens_per_s']:.0f} tokens/s, model-FLOPs share "
              f"{r['model_flops_share']:.4f} [{card}]", flush=True)
    check(len(hist) == steps and res.final_step == steps, f"{len(hist)} steps taken of {steps}")
    check(res.restarts == 0, f"{res.restarts} restarts: a step failed and was replayed")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in hist),
          "a loss or grad norm is not finite")
    check(per_step == expected, f"kernel launches per train step {per_step}, expected {expected}")
    data = SyntheticDataset(cfg, TrainConfig(global_batch=batch, seq_len=seq), device=dev)
    with torch.no_grad():
        after = float(model.loss_fn(data.batch_at(0))[0])
    print(f"  loss on step 1's batch: {hist[0]['loss']:.4f} at step 1, {after:.4f} after step "
          f"{steps}; launches per step {per_step}; peak memory {peak_gb:.1f} GB", flush=True)
    check(math.isfinite(after) and after < hist[0]["loss"],
          "the loss after the last step is not below step 1's")
    steady = hist[1:] or hist
    step_ms = sum(r["ms"] for r in steady) / len(steady)
    out = {"arch": arch, "batch": batch, "seq": seq, "steps": steps, "params": params,
           "history": hist, "loss_after_on_step1_batch": after,
           "step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
           "model_flops_share": 6.0 * params * tokens / (step_ms / 1e3) / PEAK_FLOPS_BF16,
           "launches_per_step": per_step, "restarts": res.restarts, "peak_memory_gb": peak_gb}
    if arch == QWEN:
        out["checkpoint"] = check_checkpoint(torch, model, res.opt_state)
    del res
    torch.cuda.empty_cache()

    # The same weights' loss and grads in f32 on the CPU (plain path).
    names, ref_len = TRAIN_READ[arch], REF_LEN[arch]
    toks = torch.randint(0, cfg.vocab_size, (1, ref_len + 1),
                         generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    small = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    t0 = time.perf_counter()
    cpu_model = f32_copy(torch, model)
    cpu_model.remat = "none"
    cpu_params = dict(cpu_model.named_parameters())
    loss_c, _ = cpu_model.loss_fn({k: t.cpu() for k, t in small.items()})
    refs = {"loss": float(loss_c.detach()), **dict(zip(names, torch.autograd.grad(
        loss_c, [cpu_params[n] for n in names])))}
    del cpu_model, cpu_params, loss_c
    cpu_s = time.perf_counter() - t0
    card_models = {"bfloat16": model, "float32": f32_copy(torch, model, dev)}

    def readings() -> dict:
        return {p: train_readings(torch, m, small, names, refs) for p, m in card_models.items()}

    reset_counts()
    sound = readings()
    check(all(read_counts()[k] > 0 for k, v in expected.items() if v),
          "the card-vs-CPU gradient check missed the kernels")
    for p, r in sound.items():
        print(f"  card {p} vs CPU f32 (B=1, S={ref_len}; CPU {cpu_s:.1f} s), relative: "
              + ", ".join(f"{n} {v:.3e}" for n, v in r.items())
              + f" (tolerance loss {TRAIN_VS_CPU_TOL[p]['loss']:g}, grads "
              f"{TRAIN_VS_CPU_TOL[p]['grads']:g})", flush=True)
    check(not over_limits(sound), f"{arch}: card grads disagree with the CPU f32 path: "
                                  f"{over_limits(sound)}")
    controls = {}
    for fault, (module, attr, fn) in planted.items():
        kept = getattr(module, attr)
        setattr(module, attr, fn)
        try:
            controls[fault] = readings()
        finally:
            setattr(module, attr, kept)
        caught = over_limits(controls[fault])
        print(f"  control, {fault}: " + "; ".join(
            f"{p} " + ", ".join(f"{n} {v:.3e}" for n, v in r.items())
            for p, r in controls[fault].items()) + f"; over the limits: {caught}", flush=True)
        check(bool(caught), f"the card-vs-CPU gradient check does not catch: {fault}")
    del card_models, model
    torch.cuda.empty_cache()
    out.update(card_vs_cpu=sound, card_vs_cpu_tol=TRAIN_VS_CPU_TOL, planted=controls)
    return out


def netsim_scenario(name: str):
    """(configs, workload, horizon us, channel) of a golden scenario
    (NETSIM_GOLDEN), ``links3`` or ``mesh`` (NETSIM_LINKS3, the 3-site
    mesh), or a channel case: ``impaired`` (NETSIM_IMPAIRED), ``sites`` (the
    mesh under its replayed schedule), ``link0`` / ``site`` (outages)."""
    from repro_torch.config.net import NetConfig
    from repro_torch.launch import netsim as launch_netsim
    from repro_torch.netsim import FailureSchedule, topology, workload

    if name in NETSIM_GOLDEN:
        dists, build, kw, horizon = NETSIM_GOLDEN[name]
        return ([NetConfig(distance_km=d) for d in dists],
                getattr(workload, build)(**kw), horizon, None)
    h = NETSIM_LINKS_H_US
    if name == "links3":
        return ([NetConfig(**NETSIM_LINKS3)],
                workload.congestion_workload(**NETSIM_GOLDEN["seq"][2]), h, None)
    if name == "impaired":
        return ([NetConfig(**NETSIM_IMPAIRED)],
                workload.congestion_workload(**NETSIM_GOLDEN["seq"][2]),
                NETSIM_CHANNEL_H_US, "impaired")
    if name in ("link0", "site"):
        fs = FailureSchedule.empty(3)
        fs = (fs.link_outage(0, 600.0, 2_000.0) if name == "link0"
              else fs.site_outage(1, 600.0, 1_500.0, ((0, 1),) * 3))
        return ([fs.apply(NetConfig(distance_km=100.0, num_paths=3,
                                    path_cap_frac=(0.5, 0.3, 0.2)))],
                workload.throughput_workload(1 << 23, 4, 4), NETSIM_CHANNEL_H_US, None)
    mesh = topology.SiteGraph(3, launch_netsim.SITES_EDGES)
    cfg = mesh.to_net_config(NetConfig(distance_km=100.0))
    if name == "mesh":
        return [cfg], launch_netsim.sites_workload(h), h, None
    h = NETSIM_CHANNEL_H_US
    cfg = dataclasses.replace(cfg, channel_schedule=launch_netsim.sites_schedule(1.0),
                              channel_schedule_dt_us=h / 8.0)
    return [cfg], launch_netsim.sites_workload(h), h, "trace_replay"


def netsim_golden_run(torch, name: str, scheme: str, device) -> dict:
    """One scenario (``netsim_scenario``) through ``simulate_batch``: the
    Fig. 3 columns of its traces (per cell) and its final state, as numpy."""
    import numpy as np

    from repro_torch.netsim import fluid

    cfgs, wl, horizon, channel = netsim_scenario(name)
    final, traces = fluid.simulate_batch(cfgs, wl, scheme, horizon, device=device,
                                         channel=channel)
    tr = {k: v.cpu().numpy().astype(np.float64) for k, v in traces.items()}
    warm = int(tr["q_dst"].shape[1] * fluid.WARMUP_FRAC)
    return {
        "throughput": tr["thr_inter"][:, warm:].mean(1),
        "peak_buffer": tr["q_dst"].max(1),
        "mean_buffer": tr["q_dst"][:, warm:].mean(1),
        "p99_buffer": np.percentile(tr["q_dst"][:, warm:], 99, axis=1),
        "pause_ratio": tr["pause_dst"][:, warm:].mean(1),
        **{k: getattr(final, k).cpu().numpy().astype(np.float64)
           for k in ("sent", "delivered", "done_at_us")}}


def netsim_readings(card: dict, cpu: dict) -> dict:
    """Card vs CPU, one reading per NETSIM_TOL key (see there)."""
    import numpy as np

    out = {k: float((np.abs(card[k] - cpu[k]) / (np.abs(cpu[k]) + f)).max())
           for k, f in NETSIM_FLOOR.items()}
    out["pause_ratio"] = float(np.abs(card["pause_ratio"] - cpu["pause_ratio"]).max())
    out["final"] = max(float(np.abs(card[k] - cpu[k]).max() / max(np.abs(cpu[k]).max(), 1.0))
                       for k in ("sent", "delivered"))
    fin_c, fin_p = card["done_at_us"] < 5e29, cpu["done_at_us"] < 5e29
    out["done_at_us"] = (float(np.abs(card["done_at_us"] - cpu["done_at_us"])[fin_p].max(
        initial=0.0)) if np.array_equal(fin_c, fin_p) else float("inf"))
    return out


def netsim_leaves(torch, tree, prefix: str = "") -> dict:
    """Every tensor of a netsim result (NamedTuples, dicts, tuples) by path."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = zip(getattr(tree, "_fields", range(len(tree))), tree)
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(netsim_leaves(torch, v, f"{prefix}/{k}"))
    return out


def over_netsim(readings: dict) -> list:
    return sorted(k for k, v in readings.items() if v > NETSIM_TOL[k])


def phase_netsim(torch, card: str) -> dict:
    """The netsim Fig. 3 path on the card (phase 10): card vs CPU on the
    golden scenarios, graph vs eager bit for bit, two planted faults, and
    Fig. 3b at full width (7 distances x 6 message sizes = 42 cells, 4 flows
    each; 44 ms, a fifth of the paper's 220 ms) for the four schemes, one
    [B=42] batch a scheme."""
    from repro_torch.launch import netsim as launch_netsim
    from repro_torch.netsim import fluid
    from repro_torch.netsim.schemes.base import Scheme
    from repro_torch.netsim.schemes.matchrdma import MatchRdmaScheme

    dev = torch.device("cuda")
    out = {"card_vs_cpu_tol": NETSIM_TOL}

    # 1. card (graphs) vs CPU (eager) on the golden scenarios
    t0 = time.perf_counter()
    out["card_vs_cpu"], cpu, cards = netsim_card_vs_cpu(
        torch, [(n, s) for n in NETSIM_GOLDEN for s in NETSIM_SCHEMES], dev)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 2. graph vs eager on the card, bit for bit
    netsim_graph_vs_eager(torch, [("batch", s) for s in NETSIM_SCHEMES], dev)

    # 3. planted faults, in the card's run only; each must read over a limit
    def wrap_at_pad(t, d_steps, delay_pad):
        return torch.remainder(t, torch.full_like(d_steps, delay_pad))

    out["planted"] = netsim_planted(torch, (
        ("ring wraps at delay_pad instead of each scenario's d_steps",
         "batch/dcqcn", (fluid, "ring_row", wrap_at_pad)),
        ("MatchRDMA's source-OTN release ignores the budget gate",
         "seq/matchrdma", (MatchRdmaScheme, "src_otn_release",
                           Scheme.src_otn_release))), cpu, dev)
    print(f"  peak buffer (seq, card), MB: " + ", ".join(
        f"{s} {cards['seq/' + s]['peak_buffer'][0] / 1e6:.3f}" for s in NETSIM_SCHEMES),
        flush=True)

    # 4. Fig. 3b at full width (at NETSIM_FIG3B_H_US), each scheme's 42
    # cells as one batch
    t0 = time.perf_counter()
    fig = launch_netsim.Figure("fig3b", dev, horizon_us=NETSIM_FIG3B_H_US)
    rows = launch_netsim.fig3b_throughput(fig, full=True)
    for r in fig.records:
        check(r["cells"] == 42 and r["launches"] == 1,
              f"fig3b {r['scheme']}: {r['cells']} cells in {r['launches']} launches")
        print(f"  fig3b {r['scheme']}: {r['cells']} cells x {r['steps']} steps, wall "
              f"{r['wall_s']:.2f} s (capture {r['capture_s']:.2f} s), "
              f"{r['cell_steps_per_s']:.0f} cell-steps/s, device "
              f"{r['device_ms_per_step']:.4f} ms/step, {r['kernels_per_step']:.0f} "
              f"kernels/step; profiled graph of {r['graph_steps']} steps: "
              f"{r['graph_kernel_ms_per_step']:.4f} ms of kernels in "
              f"{r['graph_span_ms_per_step']:.4f} ms a step, idle "
              f"{100 * r['idle_share']:.1f}% [{card}]", flush=True)
    for name, _, note in rows:
        print(f"  {name}: {note}")
    speedup = rows[-1][2]
    check(rows[-1][0] == "fig3b/max_speedup_vs_dcqcn", "no max-speedup row")
    thr = [float(note[:-4]) for name, _, note in rows[:-1]]
    check(len(thr) == 168 and all(math.isfinite(x) and x >= 0.0 for x in thr),
          f"fig3b rows: {len(thr)} throughputs, finite and >= 0 expected")
    print(f"  fig3b max speedup vs dcqcn: {speedup} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    out["fig3b_full"] = {"schemes": [{k: v for k, v in r.items() if k != "top_kernels"}
                                     for r in fig.records],
                         "max_speedup_vs_dcqcn": speedup}
    return out


def netsim_card_vs_cpu(torch, cases, dev) -> dict:
    """Card (CUDA graphs) vs CPU (eager) readings for each (scenario, scheme)
    of ``cases``; fails the run over NETSIM_TOL. Returns the readings, the
    CPU runs (the planted faults are read against them) and the card's."""
    cpu, cards, sound = {}, {}, {}
    for name, scheme in cases:
        key = f"{name}/{scheme}"
        cpu[key] = netsim_golden_run(torch, name, scheme, "cpu")
        cards[key] = netsim_golden_run(torch, name, scheme, dev)
        sound[key] = netsim_readings(cards[key], cpu[key])
        print(f"  card vs CPU {key}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in sound[key].items()), flush=True)
    bad = {k: over_netsim(v) for k, v in sound.items() if over_netsim(v)}
    check(not bad, f"netsim card vs CPU over the limits {NETSIM_TOL}: {bad}")
    return sound, cpu, cards


def netsim_graph_vs_eager(torch, cases, dev, steps: int = NETSIM_GRAPH_STEPS,
                          graph_block: int = 0) -> dict:
    """Each (scenario, scheme) for ``steps`` steps through CUDA graphs (of
    ``graph_block`` steps; 0 = fluid.GRAPH_BLOCK) and through eager steps on
    the card; fails the run unless every leaf of the result is equal."""
    from repro_torch.netsim import fluid

    equal = netsim_graph_diffs(torch, cases, dev, steps, graph_block)
    check(not any(equal.values()), f"CUDA graphs differ from the eager steps: {equal}")
    return equal


def netsim_graph_diffs(torch, cases, dev, steps: int, graph_block: int = 0) -> dict:
    """The leaves where graphs and eager steps differ, per (scenario, scheme)."""
    from repro_torch.netsim import fluid

    equal = {}
    for name, scheme in cases:
        cfgs, wl, _, channel = netsim_scenario(name)
        h = steps * cfgs[0].dt_us
        runs = [fluid.simulate_batch(cfgs, wl, scheme, h, device=dev, graph_block=g,
                                     channel=channel)
                for g in (0, graph_block or fluid.GRAPH_BLOCK)]
        a, b = (netsim_leaves(torch, r) for r in runs)
        equal[f"{name}/{scheme}"] = sorted(k for k in a if not torch.equal(a[k], b[k]))
        print(f"  graph vs eager {name}/{scheme}, {steps} steps: {len(a)} "
              f"leaves, {len(equal[f'{name}/{scheme}'])} differ", flush=True)
    return equal


def netsim_planted(torch, faults, cpu, dev) -> dict:
    """Each (fault, "scenario/scheme", (owner, attribute, replacement)) run
    on the card with the attribute replaced; fails the run unless its
    readings against the sound CPU run go over a limit."""
    controls = {}
    for fault, key, (owner, attr, repl) in faults:
        kept = owner.__dict__[attr]
        setattr(owner, attr, repl)
        try:
            name, scheme = key.split("/")
            planted = netsim_golden_run(torch, name, scheme, dev)
        finally:
            setattr(owner, attr, kept)
        r = netsim_readings(planted, cpu[key])
        controls[fault] = {"case": key, "readings": r, "over": over_netsim(r),
                           "peak_buffer_mb": (planted["peak_buffer"] / 1e6).tolist(),
                           "throughput_gbps": (planted["throughput"] * 8 / 1e9).tolist()}
        print(f"  control, {fault} ({key}): " + ", ".join(
            f"{k} {v:.3e}" for k, v in r.items()) + f"; peak buffer "
            f"{controls[fault]['peak_buffer_mb']} MB, throughput "
            f"{controls[fault]['throughput_gbps']} Gbps", flush=True)
        check(bool(controls[fault]["over"]), f"the card-vs-CPU check does not catch: {fault}")
    return controls


def netsim_figure(torch, card: str, name: str, n_cells: int,
                  horizon_us=None, profile_steps=None) -> dict:
    """One of launch.netsim's seven-scheme figures on the card (its default
    grid, at ``horizon_us`` if given), each scheme's grid one batch: rows,
    wall, capture, cell-steps/s, device ms a step, kernels a step
    (``profile_steps`` eager steps profiled; None = launch.netsim's
    default)."""
    from repro_torch.launch import netsim as launch_netsim

    t0 = time.perf_counter()
    kw = {} if profile_steps is None else {"profile_steps": profile_steps}
    fig = launch_netsim.Figure(name, torch.device("cuda"), horizon_us, **kw)
    rows = launch_netsim.FIGURES[name](fig, full=False)
    check([r["scheme"] for r in fig.records] == list(NETSIM_ALL),
          f"{name}: schemes {[r['scheme'] for r in fig.records]}")
    for r in fig.records:
        check(r["cells"] == n_cells and r["launches"] == 1,
              f"{name} {r['scheme']}: {r['cells']} cells in {r['launches']} launches")
        print(f"  {name} {r['scheme']}: {r['cells']} cells x {r['steps']} steps, wall "
              f"{r['wall_s']:.2f} s (capture {r['capture_s']:.2f} s), "
              f"{r['cell_steps_per_s']:.0f} cell-steps/s, device "
              f"{r['device_ms_per_step']:.4f} ms/step, {r['kernels_per_step']:.0f} "
              f"kernels/step; profiled graph of {r['graph_steps']} steps: "
              f"{r['graph_kernel_ms_per_step']:.4f} ms of kernels in "
              f"{r['graph_span_ms_per_step']:.4f} ms a step, idle "
              f"{100 * r['idle_share']:.1f}% [{card}]", flush=True)
    for row, _, note in rows:
        if "/summary/" in row:
            print(f"  {row}: {note}", flush=True)
    check(len(rows) == 7 * n_cells + 7, f"{name}: {len(rows)} rows")
    print(f"  ({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return {"schemes": [{k: v for k, v in r.items() if k != "top_kernels"}
                        for r in fig.records],
            "rows": rows}


def phase_netsim_links(torch, card: str) -> dict:
    """The seven schemes over the multi-link and multi-site long haul (phase
    11): card vs CPU, graph vs eager, two planted faults, and the
    scheme_compare and topology grids of launch.netsim on the card."""
    from repro_torch.netsim import fluid
    from repro_torch.netsim.schemes.base import Scheme
    from repro_torch.netsim.schemes.rdmacell import RdmaCellScheme

    dev = torch.device("cuda")
    out = {"card_vs_cpu_tol": NETSIM_TOL}
    t0 = time.perf_counter()
    out["card_vs_cpu"], cpu, _ = netsim_card_vs_cpu(
        torch, [(n, s) for n in NETSIM_GOLDEN for s in NETSIM_RELATED]
        + [(n, s) for n in ("links3", "mesh") for s in NETSIM_ALL], dev)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    netsim_graph_vs_eager(torch, [("batch", s) for s in NETSIM_RELATED]
                          + [("links3", s) for s in NETSIM_ALL], dev)

    def ring_at_link0(t, link_d_steps):
        return torch.remainder(t, link_d_steps[..., :1]).expand_as(link_d_steps)

    out["planted"] = netsim_planted(torch, (
        ("every link's ring read at link 0's delay", "links3/dcqcn",
         (fluid, "link_ring_row", ring_at_link0)),
        ("rdmacell's route_weights returns the base route", "links3/rdmacell",
         (RdmaCellScheme, "route_weights", Scheme.route_weights))), cpu, dev)
    out["scheme_compare"] = netsim_figure(torch, card, "scheme_compare", 7,
                                          horizon_us=NETSIM_COMPARE_H_US)
    out["topology"] = netsim_figure(torch, card, "topology", 9)
    return out


def prng_kernels_per_step(torch, dev) -> dict:
    """Kernels one impaired step's draws launch on the card, at L = 1 and at
    L = 3 (the step key, the link keys, the loss and jitter subkeys, the
    uniforms of 8 flows), counted under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.netsim import prng

    key0 = prng.fold_in(prng.prng_key(0, dev)[None, :], torch.arange(4, device=dev))
    t = torch.zeros((), dtype=torch.int32, device=dev)
    sub = torch.tensor([0, 1], device=dev)
    out = {}
    for links in (1, 3):
        def draws():
            key = prng.fold_in(key0, t)
            if links > 1:
                key = prng.fold_in(key[..., None, :], torch.arange(links, device=dev))
            return prng.uniform(prng.fold_in(key[..., None, :], sub), (8,))
        draws()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            draws()
            torch.cuda.synchronize(dev)
        out[f"L={links}"] = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    return out


def phase_netsim_channel(torch, card: str) -> dict:
    """The channel and failure paths (phase 12): threefry card vs CPU, card
    vs CPU and graph vs eager on the impaired cell, the replayed mesh and
    the outages, three planted faults, the draws' kernels a step, and the
    impairment, sites and failover grids of launch.netsim on the card."""
    import itertools

    from repro_torch.netsim import fluid, prng, runner

    dev = torch.device("cuda")
    out = {"card_vs_cpu_tol": NETSIM_TOL}

    # 1. threefry on the card against the CPU, bit for bit
    keys = prng.fold_in(prng.prng_key(7)[None, :], torch.arange(4))
    bits_cpu = prng.random_bits(keys, (1 << 20,))
    bits_card = prng.random_bits(keys.to(dev), (1 << 20,)).cpu()
    u_cpu = prng.uniform(keys, (1 << 20,)).view(torch.int32)
    u_card = prng.uniform(keys.to(dev), (1 << 20,)).cpu().view(torch.int32)
    out["threefry_words_differing"] = int((bits_cpu != bits_card).sum())
    out["uniform_bits_differing"] = int((u_cpu != u_card).sum())
    print(f"  threefry, 4 keys x 2^20 counters: {out['threefry_words_differing']} "
          f"words and {out['uniform_bits_differing']} uniforms differ from the CPU's",
          flush=True)
    check(out["threefry_words_differing"] == 0 and out["uniform_bits_differing"] == 0,
          "the card's threefry draws differ from the CPU's")
    out["prng_kernels_per_step"] = prng_kernels_per_step(torch, dev)
    print(f"  kernels of one step's draws: {out['prng_kernels_per_step']}", flush=True)

    # 2. card (graphs) vs CPU (eager)
    t0 = time.perf_counter()
    cases = ([("impaired", s) for s in NETSIM_ALL]
             + [(n, s) for n in ("sites", "link0") for s in NETSIM_CHANNEL_SCHEMES]
             + [("site", s) for s in NETSIM_SITE_SCHEMES])
    out["card_vs_cpu"], cpu, _ = netsim_card_vs_cpu(torch, cases, dev)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)

    # 3. graphs vs eager, bit for bit
    steps, block = NETSIM_CHANNEL_GRAPH
    netsim_graph_vs_eager(torch, cases, dev, steps, block)

    # 4. planted faults, each of which must fail its check
    count = itertools.count()
    kept = fluid.step_key
    fluid.step_key = lambda key, t: prng.fold_in(key, next(count))
    try:
        diff = netsim_graph_diffs(torch, [("impaired", "dcqcn")], dev, steps, block)
    finally:
        fluid.step_key = kept
    planted = {"step key folded from a count read at capture time": {
        "check": "graph vs eager", "leaves_differing": diff["impaired/dcqcn"]}}
    print(f"  control, step key from capture time: {len(diff['impaired/dcqcn'])} leaves "
          f"differ from the eager steps", flush=True)
    check(bool(diff["impaired/dcqcn"]), "graph vs eager does not catch a step key "
          "folded from a count read at capture time")
    planted.update(netsim_planted(torch, (
        ("a dead link's arrivals delivered, not dumped", "link0/dcqcn",
         (fluid, "outage_dump", lambda down, arrivals: (arrivals, arrivals * 0.0))),),
        cpu, dev))
    cfgs, wl, h, _ = netsim_scenario("link0")
    kept = fluid.notified_backlog
    fluid.notified_backlog = lambda backlog, retx_arr: backlog
    try:
        runner.run_experiment_batch(cfgs, wl, "dcqcn", h, trace_mode="decimate",
                                    decimate=4, strict_conservation=True, device=dev)
        caught = None
    except runner.ConservationError as err:
        caught = {"cell": err.cell, "step": err.step, "err": err.err, "tol": err.tol}
    finally:
        fluid.notified_backlog = kept
    planted["loss notifications never reach the retransmit backlog"] = {
        "check": "strict_conservation", "conservation_error": caught}
    print(f"  control, notifications dropped at the source: ConservationError {caught}",
          flush=True)
    check(caught is not None, "strict_conservation does not catch loss notifications "
          "that never reach the retransmit backlog")
    out["planted"] = planted

    # 5. the three grids at full width
    for name, n_cells in (("impairment", 6), ("sites", 9), ("failover", 6)):
        out[name] = netsim_figure(torch, card, name, n_cells,
                                  profile_steps=NETSIM_CHANNEL_PROFILE_STEPS)
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = smi_line()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[1/12] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}, compute capability {cap[0]}.{cap[1]}", flush=True)
    check(cap == (9, 0), f"needs compute capability 9.0 (sm_90a), found {cap}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(build.sources())
    print(f"[2/12] build: {len(logs)} of {len(build.sources())} kernel sources compiled "
          f"in {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "warning")):
                print(f"  {src}: {line.strip()}")
    hgmma = tensor_core_instr("flash_attention", flash_instantiation)
    print(f"  flash_attention SASS, HGMMA instructions per bf16 instantiation: {hgmma}",
          flush=True)
    check(len(hgmma) == 12 and all(hgmma.values()),
          f"a bf16 flash instantiation runs no HGMMA (tensor cores): {hgmma}")
    check(all(f"D=192 windowed={w}" in hgmma for w in (0, 1)),
          f"no bf16 flash instantiation at D=192: {sorted(hgmma)}")
    ssd_hgmma = tensor_core_instr("ssd_scan", ssd_instantiation)
    print(f"  ssd_scan SASS, HGMMA instructions per instantiation: {ssd_hgmma}", flush=True)
    check(ssd_hgmma.get("bf16", 0) > 0,
          f"the bf16 SSD-scan instantiation runs no HGMMA (tensor cores): {ssd_hgmma}")
    check(len(ssd_hgmma) == 4 and not any(v for k, v in ssd_hgmma.items() if k != "bf16"),
          f"the f32 SSD-scan instantiations are not the scalar kernel: {ssd_hgmma}")

    t0 = time.perf_counter()
    print("[3/12] kernels against their plain versions", flush=True)
    flash = phase_flash(torch, card)
    ssd = phase_ssd(torch, card)
    scan = phase_rglru(torch, card)
    grads = phase_grads(torch, card)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)

    served = {}
    for i, (arch, faults, must_fail) in enumerate((
            (QWEN, qwen_faults(torch), "causal mask dropped"),
            (MAMBA, mamba_faults(torch), "state not carried across chunks"),
            (RG, rglru_faults(torch), "recurrence restarted every 256 steps")), start=4):
        t0 = time.perf_counter()
        print(f"[{i}/12] serve {arch} at full width", flush=True)
        served[arch] = phase_serve(torch, card, arch, faults, must_fail)
        print(f"  ({time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
        torch.cuda.empty_cache()

    trained, faults = {}, train_faults(torch)
    for i, arch in enumerate((QWEN, MAMBA, RG), start=7):
        t0 = time.perf_counter()
        print(f"[{i}/12] train {arch} at full width", flush=True)
        trained[arch] = phase_train(torch, card, arch, faults[arch])
        print(f"  ({time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    t0 = time.perf_counter()
    print("[10/12] netsim Fig. 3 path", flush=True)
    netsim = phase_netsim(torch, card)
    print(f"  ({time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    t0 = time.perf_counter()
    print("[11/12] netsim: seven schemes over the multi-link and multi-site long haul",
          flush=True)
    netsim_links = phase_netsim_links(torch, card)
    print(f"  ({time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    t0 = time.perf_counter()
    print("[12/12] netsim: the impaired, replayed and failing long haul", flush=True)
    netsim_channel = phase_netsim_channel(torch, card)
    print(f"  ({time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    def worst(checks, prefix):
        return max(c["max_abs_err"] for c in checks if c["case"].startswith(prefix))

    qb, qs, _ = WORKLOADS[QWEN]
    flash_main = flash["timings"][qs]
    b, s, h, p, g, n, chunk = SSD_SERVING

    def launches(kernel):
        by_arch = {arch: r["launches"][kernel] for arch, r in served.items()
                   if r["launches"][kernel]}
        per_train_step = {arch: r["launches_per_step"][kernel] for arch, r in trained.items()
                          if r["launches_per_step"][kernel]}
        return {"launches": sum(by_arch.values()), "launches_by_arch": by_arch,
                "launches_per_train_step": per_train_step}

    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        **launches("flash_attention"),
        "max_abs_err": worst(flash["checks"], "serving shape bfloat16"),
        "ms": flash_main["ms"], "plain_ms": flash_main["plain_ms"],
        "bound_ms": flash_main["bound_ms"], "bound_by": flash_main["bound_by"],
        "library_ms": flash_main["library_ms"],
        "shape": f"B={qb} S={qs} H=16 D=64 bf16",
        "s4096": flash["timings"][4096],
        "windowed_d256": {**flash["windowed"], "max_abs_err": worst(
            flash["checks"], "windowed serving bfloat16")},
        "tensor_core_instr": {"instruction": "HGMMA", "per_bf16_instantiation": hgmma},
        "checks": flash["checks"],
        "autograd": {"causal": grads["flash_attention"],
                     "windowed": grads["flash_attention windowed"]},
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:71",
        **launches("ssd_scan"),
        "max_abs_err": worst(ssd["checks"], "serving shape bfloat16"),
        **ssd["timing"],
        "shape": f"b={b} s={s} h={h} p={p} g={g} n={n} L={chunk} bf16",
        "tensor_core_instr": {"instruction": "HGMMA", "per_instantiation": ssd_hgmma},
        "checks": ssd["checks"],
        "autograd": grads["ssd_scan"],
    }, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:42",
        **launches("rglru_scan"),
        "max_abs_err": worst(scan["checks"], ""),
        **scan["timing"],
        "shape": "b={} s={} w={} f32".format(*RGLRU_SERVING),
        "kernels_per_call": ["rglru_aggregate_kernel", "rglru_chunk_kernel"],
        "checks": scan["checks"],
        "autograd": grads["rglru_scan"],
    }]}
    print(json.dumps({"serve": served}))
    print(json.dumps({"train": trained}))
    print(json.dumps({"netsim": netsim}))
    print(json.dumps({"netsim_links": netsim_links}))
    print(json.dumps({"netsim_channel": netsim_channel}))
    print(smi_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
