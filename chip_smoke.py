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
   22 ms (4,400 steps; a tenth of the paper's 220 ms, so that phases 11-13
   fit),
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
   then ``launch.netsim``'s ``scheme_compare`` (7 distances at 22 ms, a
   tenth of its 220 ms, so that phases 12-13 fit; one [B=7] batch a scheme) and
   ``topology`` (3 x 3 unequal three-link cells, 20 ms, [B=9]) grids with
   their row asserts, wall, cell-steps per second, device ms and kernels per
   step for each scheme.
12. the impaired, replayed and failing long haul (the channel models, the
   threefry PRNG, the loss-repair path, failure schedules, the hardened
   runner; again no kernel of its own): the threefry draws on the card bit
   for bit against the CPU's over 2^20 counters; card vs CPU with phase 10's
   limits for all seven schemes on the golden congestion cell under the
   ``impaired`` channel (loss, jitter and flap, 3 ms), on the 3-site mesh
   under ``trace_replay`` at schedule scale 1 and on the link-0 and site
   outages of three links (3 ms, cut from 4 so that phase 13 fits); graphs
   vs eager steps bit for bit on
   those; three planted faults, each of which must fail its check ("the
   step key folded from a count read at capture time": graph vs eager;
   "a dead link's arrivals delivered, not dumped": card vs CPU; "loss
   notifications never reach the retransmit backlog": ``strict_conservation``
   must raise ``ConservationError``); the kernels one step's draws launch;
   then ``launch.netsim``'s ``impairment`` (6 cells), ``sites`` (9) and
   ``failover`` (6) grids at full width (20 ms, one batch a scheme) with
   their asserts, rows, wall, capture, cell-steps per second, device ms and
   kernels per step for each scheme.
13. observability and training traffic (window mode, event rings, run
   manifests, Perfetto timelines, the AICB traffic model; again no kernel
   of its own): ``launch.netsim``'s ``obs`` smoke (a window-mode sweep of
   dcqcn and matchrdma at 100 and 300 km, 12 ms, with a run manifest; its
   rows equal to metrics mode's; the manifest summarised and diffed by
   ``tools/obs_report.py``; a timeline with PFC events in the dcqcn cells
   and brakes in the matchrdma cells); window-mode graphs vs eager steps
   bit for bit for the seven schemes (256 steps through graphs of 64, a
   ring of 64 steps and 32 event slots, the discard slot left out); card
   vs CPU on the golden congestion cell (3 ms) and the site outage for
   dcqcn, matchrdma and sdr_rdma: the same events at the same steps,
   values within 1e-4, and phase 10's limits on the streamed columns; two
   planted faults that must fail that check ("event positions without the
   prefix sum": the three ``fail_enter`` events of the outage collide;
   "candidates read from the post-step state": no edge fires); then
   ``launch.geo_training --distances-km 10,1000 --lossy`` at full width
   (deepseek-67b's traffic on the 2 x 16 x 16 mesh, 120 ms = 24,000 steps,
   both compressions, and the 3-link lossy grid of 6 cells for dcqcn and
   sdr_rdma): rows complete and finite, the two compressions' rows equal,
   and the "repairs Nx faster" lines.
14. the differentiable engine and the gradient tuner (the soft step,
   autograd through the whole run, ``netsim.grad_tune``, ``launch.grad_tune``;
   eager on the card, no kernel of its own): tests/test_grad.py's base point
   (96 km) at 2 ms for the seven schemes on the ideal channel and dcqcn and
   matchrdma on ``impaired``, each a batch of three cells at soft_temp 1.0,
   0.3 and 0.3 raised by one ulp; each cell's surrogate and the gradient of
   every NetParams and WorkloadParams leaf on the card against the CPU's
   (run in worker processes meanwhile): every gradient finite, at 1.0 the
   surrogate and every FD knob's gradient within ``SOFT_GRAD_TOL``, at 0.3
   within ``SOFT_COLD_TOL``, printed beside the CPU's own move under the
   one-ulp nudge; device ms a step forward and forward+backward; the tuner
   against the bracket search on tests/test_grad_tune.py's cell (2
   iterations, 10 evaluations, against 4 Adam steps, 9), which must reach
   its score with fewer evaluations; two planted faults that must fail the
   check ("reset gates not detached": the tangents blow up; "soft mode folds
   the knob bits into the channel key": the impaired surrogate parts).

Phases 1-9 run alone. Phases 10-14 (no kernel of the port's three) then run
as units in four child processes of this script beside one another on the
card (``NETSIM_LANES``), so that their wall and device times are read beside
the other lanes' load; each unit's output is printed in phase order once all
have ended. Their card-vs-CPU checks run the CPU side in three spawned worker
processes while the card runs (``cpu_pool``).

Each serving and training path runs with every kernel's launch count set to
0 just before it and read just after. The last lines are the serving,
training, netsim, multi-link, channel netsim, observability and
differentiable-engine JSON records, the card's
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
# Fig. 3b's horizon here: a tenth of the paper's 220 ms (4,400 steps), so
# that phases 10 to 13 together fit the script's time; the full depth runs
# through `python -m repro_torch.launch.netsim --figure fig3b --full`.
NETSIM_FIG3B_H_US = 22_000.0
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
# scheme_compare's distance grid in phase 11: a tenth of its 220 ms (4,400
# steps), so that phases 12 and 13 fit the script's time
NETSIM_COMPARE_H_US = 22_000.0
# Phase 12, the channel and failure paths: the golden congestion cell under
# the impaired channel (tests/test_channel.py's conservation knobs), the
# 3-site mesh under its replayed schedule at amplitude 1, and link-0 and
# site outages on three unequal links at 100 km under a streaming workload;
# 3 ms each, as the CPU side runs eagerly (the draws ~500 ops a step; 4 ms
# until phase 13 needed the time).
NETSIM_IMPAIRED = dict(distance_km=100.0, loss_rate=0.01, loss_burst_len=4.0,
                       jitter_us=20.0, flap_period_us=2_000.0, flap_depth=0.5)
NETSIM_CHANNEL_H_US = 3_000.0
NETSIM_CHANNEL_SCHEMES = ("dcqcn", "matchrdma", "rdmacell")
# the site outage: rdmacell's run parts from JAX at step 606 (3.03 ms), where
# sum(q_src) settles on the source OTN's PFC threshold xoff_otn = 2e7 B, a few
# bytes to either side (tests/torch_parity.py PARTS), and parts between card
# and CPU within 4 ms there (final sent 1.383e-3 apart on an H100 80GB HBM3 at
# 700 W); at this phase's 3 ms it holds (the Fig. 3 columns 1.6e-7 apart on
# that card). Its reorder-buffer trace reads 2e-6 MB in JAX and 0 in the port
# from step 401: f32 residue of its ledgers, not a parting.
NETSIM_SITE_SCHEMES = ("dcqcn", "matchrdma", "sdr_rdma", "rdmacell")
# graphs vs eager on the channel cases: 192 steps through graphs of 64
NETSIM_CHANNEL_GRAPH = (192, 64)
# profiled eager steps a scheme for the phase 12 figures' kernel counts
NETSIM_CHANNEL_PROFILE_STEPS = 20
# Phase 13, observability and training traffic: window mode with an event
# ring of OBS_SLOTS slots and a ring of OBS_WINDOW_STEPS steps (so that it
# wraps) on the golden congestion cell (L = 1) and the site outage of three
# links (three fail_enter events at one step), NETSIM_CHANNEL_H_US each.
# The congestion cell keeps its first three PFC edges within that horizon.
OBS_SLOTS = 32
OBS_WINDOW_STEPS = 64
OBS_CASES = ("seq", "site")
OBS_EVENT_SCHEMES = ("dcqcn", "matchrdma", "sdr_rdma")
# graphs vs eager in window mode: steps, graph block
OBS_GRAPH = (256, 64)
# launch.geo_training on the card: its distance grid (with --lossy)
GEO_DISTANCES = "10,1000"
# Phase 14, the differentiable engine: tests/test_grad.py's base point (96
# km, slot_us 112, impairment knobs engaged) at 2 ms (400 steps: the
# destination OTN's queue reaches its PFC threshold near step 230 and the
# pause is back at the source a one-way delay later), under
# throughput_workload(8e6, 4, num_flows=4); the seven schemes on the ideal
# channel and dcqcn and matchrdma on ``impaired``. Each case is one batch of
# three cells, at soft_temp 1.0 (tests/test_grad.py's FD temperature), 0.3
# (the base point's, the tuner's floor) and 0.3 raised by one f32 ulp. The
# surrogate is netsim.grad_tune's (mean throughput less the buffer and
# pause penalties).
GRAD_BASE = dict(distance_km=96.0, slot_us=112.0, soft_step=True,
                 loss_rate=0.01, loss_burst_len=4.0, jitter_us=20.0,
                 flap_period_us=1000.0, flap_depth=0.3)
GRAD_H_US = 2_000.0
GRAD_CASES = tuple((s, None) for s in NETSIM_ALL) + (("dcqcn", "impaired"),
                                                     ("matchrdma", "impaired"))
# Card vs CPU at soft_temp 1.0: the surrogate relative to the CPU's, each FD
# knob's gradient (netsim.grad_tune.FD_EPS) relative to the larger of the
# two magnitudes above the FD floor. The card's f32 sums and
# transcendentals round otherwise; JAX and the port's CPU run agree to 1e-7
# there (tests/test_torch_netsim_grad_jax.py). At 0.3 over 2 ms the gates
# are steep enough that one ulp of soft_temp moves JAX's own run by up to
# 1.1e-4 in the surrogate and 14% in the gradients
# (tests/test_torch_netsim_grad_cold.py): there the surrogate is held to ten
# times that move, and the gradients to tests/test_grad.py's gate for
# slopes through noisy mechanisms (0.75), beside the CPU's own one-ulp move.
SOFT_GRAD_TOL = {"surrogate": 1e-4, "grad": 1e-2}
SOFT_COLD_TOL = {"surrogate": 1e-3, "grad": 0.75}
# the gradient tuner on tests/test_grad_tune.py's cell: matchrdma, 100 km,
# 6 ms, the congestion workload, budget_headroom; the bracket search 2
# iterations (10 evaluations), the grad tuner 4 Adam steps (9)
TUNE_CELL = dict(dists=(100.0,), horizon_us=6_000.0)
TUNE_ITERS, TUNE_STEPS = 2, 4
# Phases 10-14 launch none of the port's three kernels. After phases 1-9
# have run alone, they run as units in child processes of this script, one
# lane a process, the lanes beside one another on the one card (each lane's
# units one after another): the netsim is host-bound (eager steps, graph
# capture, the CPU side of its checks) and leaves the card idle most of the
# time; one after another the five phases took 857 s, the script 1,081 s
# (NVIDIA H100 80GB HBM3 at 700 W), beside one another 579 s. Their wall
# and device times are therefore read beside the other lanes' load. A unit
# is a phase or a part of one: (phase, title, function).
NETSIM_UNITS = {
    "10": (10, "netsim Fig. 3 path", "phase_netsim"),
    "11": (11, "netsim: seven schemes over the multi-link and multi-site long haul",
           "phase_netsim_links"),
    "11g": (11, "", "phase_netsim_links_grids"),
    "12": (12, "netsim: the impaired, replayed and failing long haul",
           "phase_netsim_channel"),
    "12g": (12, "", "phase_netsim_channel_grids"),
    "13": (13, "observability and training traffic", "phase_obs"),
    "14": (14, "the differentiable engine and the gradient tuner", "phase_netsim_grad"),
}
# the lanes, balanced on the units' times alone (s, same card): 14 222;
# 12g 184 + 10 66; 13 147 + 11 75; 12 111 + 11g 118
NETSIM_LANES = (("14",), ("12g", "10"), ("13", "11"), ("12", "11g"))
# the lanes are stopped, and the run fails, this many seconds after the
# script's start
NETSIM_DEADLINE_S = 1_140.0


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
    each; 22 ms, a tenth of the paper's 220 ms) for the four schemes, one
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


def on_cpu(fn, *args):
    """``fn(torch, *args, "cpu")`` in a worker process of ``cpu_pool``
    (single-threaded torch, so that the pool's workers do not contend)."""
    sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(1)
    return fn(torch, *args, "cpu")


def cpu_pool():
    """Three spawned worker processes for the CPU side of a card-vs-CPU
    check, which then runs while the card does; leaving the ``with`` block
    stops them."""
    import concurrent.futures
    import multiprocessing

    return concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))


def netsim_card_vs_cpu(torch, cases, dev) -> dict:
    """Card (CUDA graphs) vs CPU (eager) readings for each (scenario, scheme)
    of ``cases`` (the CPU runs in ``cpu_pool``); fails the run over
    NETSIM_TOL. Returns the readings, the CPU runs (the planted faults are
    read against them) and the card's."""
    keys = [f"{name}/{scheme}" for name, scheme in cases]
    with cpu_pool() as pool:
        futures = [pool.submit(on_cpu, netsim_golden_run, name, scheme)
                   for name, scheme in cases]
        cards = {key: netsim_golden_run(torch, name, scheme, dev)
                 for key, (name, scheme) in zip(keys, cases)}
        cpu = {key: f.result() for key, f in zip(keys, futures)}
    sound = {}
    for key in keys:
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
    11, its checks): card vs CPU, graph vs eager and two planted faults."""
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
    return out


def phase_netsim_links_grids(torch, card: str) -> dict:
    """Phase 11's grids: launch.netsim's scheme_compare and topology on the
    card."""
    return {"scheme_compare": netsim_figure(torch, card, "scheme_compare", 7,
                                            horizon_us=NETSIM_COMPARE_H_US),
            "topology": netsim_figure(torch, card, "topology", 9)}


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
    """The channel and failure paths (phase 12, its checks): threefry card
    vs CPU, card vs CPU and graph vs eager on the impaired cell, the
    replayed mesh and the outages, three planted faults and the draws'
    kernels a step."""
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
    return out


def phase_netsim_channel_grids(torch, card: str) -> dict:
    """Phase 12's grids: launch.netsim's impairment, sites and failover at
    full width on the card."""
    out = {}
    for name, n_cells in (("impairment", 6), ("sites", 9), ("failover", 6)):
        out[name] = netsim_figure(torch, card, name, n_cells,
                                  profile_steps=NETSIM_CHANNEL_PROFILE_STEPS)
        torch.cuda.empty_cache()
    return out


def obs_case(name: str):
    """A scenario of ``netsim_scenario`` with the event ring and window of
    phase 13."""
    cfgs, wl, h, channel = netsim_scenario(name)
    cfgs = [dataclasses.replace(c, event_ring_slots=OBS_SLOTS,
                                trace_window_steps=OBS_WINDOW_STEPS) for c in cfgs]
    return cfgs, wl, min(h, NETSIM_CHANNEL_H_US), channel


def obs_run(torch, name: str, scheme: str, device, steps=None, graph_block=None):
    """``(final, WindowAux)`` of a phase 13 case in window mode (``steps``
    cuts the horizon; ``graph_block`` 0 runs eager steps on the card)."""
    from repro_torch.netsim import fluid

    cfgs, wl, h, channel = obs_case(name)
    kw = {} if graph_block is None else {"graph_block": graph_block}
    return fluid.simulate_batch(cfgs, wl, scheme, h if steps is None else steps * cfgs[0].dt_us,
                                trace_mode="window", channel=channel, device=device, **kw)


def obs_leaves(torch, run) -> dict:
    """Every leaf of a window-mode run; the event ring's discard slot E (the
    last column, written by every candidate that did not fire) left out."""
    out = netsim_leaves(torch, run)
    for k in [k for k in out if "/events/" in k and not k.endswith("/count")]:
        out[k] = out[k][..., :OBS_SLOTS]
    return out


def obs_readings(torch, card, cpu) -> dict:
    """Card vs CPU of two window-mode runs: the events (time, kind, link)
    the same (0, else inf) with values within NETSIM_TOL["final"] of the
    largest; the streamed Fig. 3 columns and the final state as phase 10
    reads them."""
    import numpy as np

    from repro_torch.netsim import fluid
    from repro_torch.netsim.obs import decode_events

    def fig3(run):
        final, aux = run
        cols = fluid.acc_columns(aux.acc)
        n = max(int(aux.window["q_dst"].shape[1]), 1)    # any positive scale
        return {"throughput": cols["sum_s"]["thr_inter"].cpu().double().numpy() / n,
                "peak_buffer": cols["maxes"]["q_dst"].cpu().double().numpy(),
                "mean_buffer": cols["sum_s"]["q_dst"].cpu().double().numpy() / n,
                "pause_ratio": cols["sum_s"]["pause_dst"].cpu().double().numpy() / n,
                **{k: getattr(final, k).cpu().double().numpy()
                   for k in ("sent", "delivered", "done_at_us")}}

    c, p = fig3(card), fig3(cpu)
    out = {k: float((np.abs(c[k] - p[k]) / (np.abs(p[k]) + NETSIM_FLOOR[k])).max())
           for k in ("throughput", "peak_buffer", "mean_buffer")}
    out["pause_ratio"] = float(np.abs(c["pause_ratio"] - p["pause_ratio"]).max())
    out["final"] = max(float(np.abs(c[k] - p[k]).max() / max(np.abs(p[k]).max(), 1.0))
                       for k in ("sent", "delivered"))
    evs = []
    for run in (card, cpu):
        ring = run[1].events
        evs.append([decode_events(ring, OBS_SLOTS, cell=i)
                    for i in range(ring.count.shape[0])])
    same = all([(e["t_us"], e["kind"], e["obj"]) for e in a]
               == [(e["t_us"], e["kind"], e["obj"]) for e in b]
               for a, b in zip(*evs))
    out["events"] = 0.0 if same else float("inf")
    vals = [(a["value"], b["value"]) for x, y in zip(*evs) for a, b in zip(x, y)]
    scale = max([abs(b) for _, b in vals] + [1.0])
    out["event_value"] = max([abs(a - b) / scale for a, b in vals] + [0.0])
    out["n_events"] = sum(len(x) for x in evs[1])
    return out


def over_obs(readings: dict) -> list:
    lim = dict(NETSIM_TOL, events=0.0, event_value=NETSIM_TOL["final"])
    return sorted(k for k, v in readings.items() if k in lim and v > lim[k])


def phase_obs(torch, card: str) -> dict:
    """Observability and training traffic (phase 13): launch.netsim's obs
    smoke, window-mode graphs vs eager bit for bit for the seven schemes,
    card vs CPU events, two planted faults, and launch.geo_training at full
    width with the lossy grid."""
    from repro_torch.launch import geo_training
    from repro_torch.launch import netsim as launch_netsim
    from repro_torch.netsim import fluid
    from repro_torch.netsim.obs import events as obs_events

    dev = torch.device("cuda")
    out = {}

    # 1. the obs smoke (benchmarks/obs_bench.py run_smoke)
    t0 = time.perf_counter()
    fig = launch_netsim.Figure("obs", dev, profile_steps=NETSIM_CHANNEL_PROFILE_STEPS)
    rows = launch_netsim.obs(fig, out_dir=str(ROOT / "build" / "obs"))
    for name, _, note in rows:
        print(f"  {name}: {note}", flush=True)
    for r in fig.records:
        print(f"  obs {r['scheme']}: {r['cells']} cells x {r['steps']} steps window mode, "
              f"wall {r['wall_s']:.2f} s (capture {r['capture_s']:.2f} s), device "
              f"{r['device_ms_per_step']:.4f} ms/step, {r['kernels_per_step']:.0f} "
              f"kernels/step (metrics mode's step) [{card}]", flush=True)
    from repro_torch.netsim.obs import read_manifest
    _, recs = read_manifest(str(ROOT / "build" / "obs" / "manifest.jsonl"))
    keys = ("argument_size_in_bytes", "temp_size_in_bytes", "output_size_in_bytes")
    check(all(r["backend"] == "cuda" and r["compile_s"] > 0 and all(k in r for k in keys)
              for r in recs), f"obs manifest launches without the card's figures: {recs}")
    out["obs_smoke"] = {"rows": rows, "manifest": recs, "schemes": [
        {k: v for k, v in r.items() if k != "top_kernels"} for r in fig.records],
        "s": time.perf_counter() - t0}

    # 2. window-mode graphs vs eager steps, bit for bit (the discard slot
    # left out), for the seven schemes
    t0 = time.perf_counter()
    steps, block = OBS_GRAPH
    differ = {}
    for scheme in NETSIM_ALL:
        a, b = (obs_leaves(torch, obs_run(torch, "seq", scheme, dev, steps, g))
                for g in (0, block))
        differ[scheme] = sorted(k for k in a if not torch.equal(a[k], b[k]))
        print(f"  window graph vs eager seq/{scheme}, {steps} steps: {len(a)} leaves, "
              f"{len(differ[scheme])} differ", flush=True)
    check(not any(differ.values()), f"window-mode graphs differ from eager steps: {differ}")
    out["window_graph_vs_eager"] = {"steps": steps, "graph_block": block,
                                    "s": time.perf_counter() - t0}

    # 3. card vs CPU, events and the streamed columns
    t0 = time.perf_counter()
    cases = [(name, scheme) for name in OBS_CASES for scheme in OBS_EVENT_SCHEMES]
    with cpu_pool() as pool:
        futures = [pool.submit(on_cpu, obs_run, *case) for case in cases]
        cards = [obs_run(torch, *case, dev) for case in cases]
        cpu = {f"{n}/{s}": f.result() for (n, s), f in zip(cases, futures)}
    sound = {}
    for (name, scheme), run in zip(cases, cards):
        key = f"{name}/{scheme}"
        sound[key] = obs_readings(torch, run, cpu[key])
        print(f"  card vs CPU {key}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in sound[key].items()), flush=True)
    bad = {k: over_obs(v) for k, v in sound.items() if over_obs(v)}
    check(not bad, f"window mode card vs CPU over the limits: {bad}")
    out["card_vs_cpu"] = sound

    # 4. planted faults, each of which must fail the card-vs-CPU check
    def no_prefix_sum(ring, slots, t_us, candidates, codes=None):
        kinds, objs = codes
        fired = torch.stack([f.expand(ring.count.shape) for *_, f in candidates], -1)
        vals = torch.stack([v.float().expand(ring.count.shape) if torch.is_tensor(v)
                            else torch.full(ring.count.shape, float(v), device=fired.device)
                            for _, _, v, _ in candidates], -1)
        pos = torch.where(fired, torch.remainder(ring.count[..., None], slots),
                          slots).long()
        ts = t_us.expand(pos.shape)
        return obs_events.EventRing(
            ring.t_us.scatter(-1, pos, ts), ring.kind.scatter(-1, pos, kinds.expand(pos.shape)),
            ring.obj.scatter(-1, pos, objs.expand(pos.shape)), ring.value.scatter(-1, pos, vals),
            ring.count + fired.int().sum(-1, dtype=torch.int32))

    kept = fluid.engine_event_candidates

    def post_step_state(ctx, prev_state, state, t):
        return kept(ctx, state, state, t)

    planted = {}
    for fault, key, attr, repl in (
            ("event positions without the prefix sum", "site/dcqcn", "push_events",
             no_prefix_sum),
            ("candidates read from the post-step state", "seq/dcqcn",
             "engine_event_candidates", post_step_state)):
        orig = getattr(fluid, attr)
        setattr(fluid, attr, repl)
        try:
            name, scheme = key.split("/")
            r = obs_readings(torch, obs_run(torch, name, scheme, dev), cpu[key])
        finally:
            setattr(fluid, attr, orig)
        planted[fault] = {"case": key, "readings": r, "over": over_obs(r)}
        print(f"  control, {fault} ({key}): " + ", ".join(
            f"{k} {v:.3e}" for k, v in r.items()), flush=True)
        check(bool(planted[fault]["over"]), f"the window card-vs-CPU check does not catch: {fault}")
    out["planted"] = planted
    out["card_vs_cpu_s"] = time.perf_counter() - t0

    # 5. launch.geo_training at full width with the lossy grid
    t0 = time.perf_counter()
    geo = geo_training.main(["--distances-km", GEO_DISTANCES, "--lossy"])
    n = len(GEO_DISTANCES.split(","))
    tables = geo["training"]
    for compress, table in tables.items():
        for scheme, rs in table["rows"].items():
            check(len(rs) == n and all(
                math.isfinite(r[c]) for r in rs for c in
                ("throughput_gbps", "peak_buffer_mb", "pause_ratio")),
                f"geo_training {compress}/{scheme}: rows {rs}")
    same = [json.dumps(tables[c]["rows"], sort_keys=True) for c in ("none", "int8")]
    check(same[0] == same[1], "geo_training: the two compressions' rows differ within 120 ms")
    lossy = geo["lossy"]["rows"]
    for scheme, rs in lossy.items():
        check(len(rs) == 3 * n and all(math.isfinite(r[c]) for r in rs for c in
                                      ("goodput_gbps", "wire_gbps", "retx_frac",
                                       "p99_repair_latency_us")),
              f"geo_training lossy {scheme}: rows {rs}")
    check(bool(geo["lossy"]["repair_speedup"]), "geo_training: no 'repairs Nx faster' line")
    out["geo_training"] = {"runs": geo["runs"], "repair_speedup": geo["lossy"]["repair_speedup"],
                           "s": time.perf_counter() - t0}
    print(f"  geo_training: {len(geo['runs'])} runs ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return out


def grad_temps(torch) -> tuple:
    """The soft temperatures of a phase-14 batch: 1.0, 0.3 and 0.3 raised by
    one f32 ulp."""
    cold = torch.tensor(0.3)
    return (1.0, 0.3, float(torch.nextafter(cold, torch.tensor(1.0))))


def grad_case(torch, scheme: str, channel, device) -> dict:
    """One soft-engine batch of GRAD_BASE on ``device``, a cell at each of
    ``grad_temps``: each cell's surrogate and the gradient of every leaf
    (``grad_tune.surrogate_grads``, autograd through the whole run), and
    the forward's and the forward+backward's device ms a step (CUDA events
    on the card, the host clock on the CPU)."""
    from repro_torch.config.net import NetConfig, batch_template
    from repro_torch.netsim import grad_tune
    from repro_torch.netsim.workload import throughput_workload

    cuda = torch.device(device).type == "cuda"
    cfgs = [NetConfig(**GRAD_BASE, soft_temp=t, horizon_us=GRAD_H_US)
            for t in grad_temps(torch)]
    steps = batch_template(cfgs).horizon_steps(None)
    marks = []

    def mark():
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    mark()
    surr, gp, gw = grad_tune.surrogate_grads(
        cfgs, throughput_workload(8e6, 4, num_flows=4), scheme, channel=channel,
        device=device, on_forward=mark)
    mark()
    if cuda:
        marks[-1].synchronize()
        ms = [marks[i].elapsed_time(marks[i + 1]) for i in (0, 1)]
    else:
        ms = [(marks[i + 1] - marks[i]) * 1e3 for i in (0, 1)]
    return {"surrogate": surr.cpu().tolist(), "steps": steps,
            "fwd_ms_per_step": ms[0] / steps,
            "fwd_bwd_ms_per_step": (ms[0] + ms[1]) / steps,
            "grads": (type(gp)(*(g.detach().cpu() for g in gp)),
                      type(gw)(*(g.detach().cpu() for g in gw)))}


def grad_readings(torch, run: dict, ref: dict, cell: int, ref_cell=None) -> dict:
    """Cell ``cell`` of ``run`` against cell ``ref_cell`` (default the same)
    of ``ref``: the surrogate's error relative to the reference's, the
    worst FD knob's gradient error (``grad_tune.fd_grad_errors``) and the
    leaves whose gradient is not finite."""
    from repro_torch.netsim import grad_tune

    ref_cell = cell if ref_cell is None else ref_cell
    s_ref = ref["surrogate"][ref_cell]
    errs = grad_tune.fd_grad_errors(run["grads"], ref["grads"], s_ref, cell,
                                    ref_cell)
    knob = max(errs, key=errs.get)
    names = ([(n, g) for n, g in zip(run["grads"][0]._fields, run["grads"][0])]
             + [(f"wl.{n}", g) for n, g in zip(run["grads"][1]._fields, run["grads"][1])])
    return {"surrogate": abs(run["surrogate"][cell] - s_ref) / max(abs(s_ref), 1e-30),
            "grad": errs[knob], "grad_knob": knob,
            "nonfinite": sorted(n for n, g in names
                                if not bool(torch.isfinite(g[cell]).all()))}


def over_grad(r: dict, cold: bool) -> list:
    """The limits a reading passes over: ``SOFT_GRAD_TOL`` at soft_temp 1.0,
    ``SOFT_COLD_TOL`` at 0.3; every gradient finite at both."""
    tol = SOFT_COLD_TOL if cold else SOFT_GRAD_TOL
    over = [k for k, lim in tol.items() if not r[k] <= lim]
    return over + (["nonfinite"] if r["nonfinite"] else [])


def phase_netsim_grad(torch, card: str) -> dict:
    """The differentiable engine and the gradient tuner (phase 14): card vs
    CPU surrogate and gradients for the GRAD_CASES (the CPU side in worker
    processes while the card runs), the tuner against the bracket search
    through launch.grad_tune, and two planted faults that must fail their
    checks."""
    from repro_torch.launch import grad_tune as launch_tune
    from repro_torch.netsim import fluid
    from repro_torch.netsim.channel import scenario_key
    from repro_torch.netsim.prng import prng_key

    dev = torch.device("cuda")
    out = {"tol": SOFT_GRAD_TOL, "cold_tol": SOFT_COLD_TOL,
           "horizon_us": GRAD_H_US, "soft_temps": grad_temps(torch)}
    with cpu_pool() as pool:
        futures = {f"{s}/{c or 'ideal'}": pool.submit(on_cpu, grad_case, s, c)
                   for s, c in GRAD_CASES}
        # 1. the card's runs (the CPU's arrive meanwhile)
        t0 = time.perf_counter()
        cards = {f"{s}/{c or 'ideal'}": grad_case(torch, s, c, dev)
                 for s, c in GRAD_CASES}
        print(f"  card runs, forward and backward: {time.perf_counter() - t0:.1f} s",
              flush=True)

        # 2. the tuner on the card against the bracket search
        t0 = time.perf_counter()
        hc_val, hc_score, hc_evals = launch_tune.netsim_tune(
            "headroom", iters=TUNE_ITERS, device=dev, **TUNE_CELL)
        hc_wall = time.perf_counter() - t0
        timer = launch_tune.StepTimer(dev)
        t0 = time.perf_counter()
        _, g_score, g_evals = launch_tune.netsim_tune(
            "grad", grad_steps=TUNE_STEPS, device=dev, timer=timer, **TUNE_CELL)
        out["tuner"] = {"hillclimb": {"knob": hc_val, "objective": hc_score,
                                      "sim_evals": hc_evals, "wall_s": hc_wall},
                        "grad": {"objective": g_score, "sim_evals": g_evals,
                                 "wall_s": time.perf_counter() - t0,
                                 "adam_wall_s": timer.wall_s,
                                 "adam_device_ms": timer.device_ms}}
        print(f"  tuner: bracket search {hc_score:.3f} in {hc_evals} evaluations "
              f"({hc_wall:.1f} s), grad tuner {g_score:.3f} in {g_evals}; Adam steps "
              f"wall {[round(x, 2) for x in timer.wall_s]} s, device "
              f"{[round(x, 1) for x in timer.device_ms]} ms [{card}]", flush=True)
        check(g_score >= hc_score - 1e-6 and g_evals < hc_evals,
              f"the grad tuner ({g_score} in {g_evals}) does not reach the bracket "
              f"search ({hc_score} in {hc_evals}) with fewer evaluations")

        # 3. planted faults on the card, read against the sound CPU runs
        mods = [m for m in list(sys.modules.values())
                if getattr(m, "__name__", "").startswith("repro_torch.")
                and "reset_gate" in getattr(m, "__dict__", {})
                and not m.__name__.endswith(".soft")]
        kept = [m.reset_gate for m in mods]
        for m in mods:
            m.reset_gate = lambda w: w
        try:
            fault_a = grad_case(torch, "dcqcn", None, dev)
        finally:
            for m, k in zip(mods, kept):
                m.reset_gate = k
        kept_key = fluid._channel_key
        fluid._channel_key = lambda cfg, params, d: scenario_key(
            prng_key(cfg.channel_seed, d), params)
        try:
            fault_b = grad_case(torch, "matchrdma", "impaired", dev)
        finally:
            fluid._channel_key = kept_key
        t0 = time.perf_counter()
        cpu = {k: f.result() for k, f in futures.items()}
        print(f"  waited {time.perf_counter() - t0:.1f} s for the CPU runs", flush=True)

    sound, cold, witness = {}, {}, {}
    for key, c in cards.items():
        sound[key] = grad_readings(torch, c, cpu[key], 0)
        cold[key] = grad_readings(torch, c, cpu[key], 1)
        witness[key] = grad_readings(torch, cpu[key], cpu[key], 2, 1)
        w, r0, r1 = witness[key], sound[key], cold[key]
        print(f"  card vs CPU {key}: at soft_temp 1.0 surrogate {c['surrogate'][0]:.6f} "
              f"(error {r0['surrogate']:.3e}), worst FD-knob gradient error "
              f"{r0['grad']:.3e} ({r0['grad_knob']}); at 0.3 surrogate "
              f"{c['surrogate'][1]:.6f} (error {r1['surrogate']:.3e}), gradient "
              f"error {r1['grad']:.3e} ({r1['grad_knob']}), the CPU's own move under "
              f"one ulp of soft_temp {w['surrogate']:.3e} / {w['grad']:.3e} "
              f"({w['grad_knob']}); non-finite {r0['nonfinite'] + r1['nonfinite']}; "
              f"device ms a step (3 cells, {c['steps']} steps): forward "
              f"{c['fwd_ms_per_step']:.3f}, forward+backward "
              f"{c['fwd_bwd_ms_per_step']:.3f}; CPU forward+backward "
              f"{cpu[key]['fwd_bwd_ms_per_step']:.3f} [{card}]", flush=True)
    out["card_vs_cpu"] = {"soft_temp_1.0": sound, "soft_temp_0.3": cold,
                          "cpu_one_ulp_at_0.3": witness}
    out["ms_per_step"] = {k: {"fwd": c["fwd_ms_per_step"],
                              "fwd_bwd": c["fwd_bwd_ms_per_step"],
                              "cpu_fwd_bwd": cpu[k]["fwd_bwd_ms_per_step"]}
                          for k, c in cards.items()}
    bad = {k: over_grad(v, False) + over_grad(cold[k], True) for k, v in sound.items()
           if over_grad(v, False) + over_grad(cold[k], True)}
    check(not bad, f"soft engine card vs CPU over the limits {SOFT_GRAD_TOL} at 1.0, "
          f"{SOFT_COLD_TOL} at 0.3: {bad}")
    planted = {}
    for fault, key, run in (
            ("reset gates not detached", "dcqcn/ideal", fault_a),
            ("soft mode folds the knob bits into the channel key",
             "matchrdma/impaired", fault_b)):
        r0 = grad_readings(torch, run, cpu[key], 0)
        r1 = grad_readings(torch, run, cpu[key], 1)
        planted[fault] = {"case": key, "readings": {"1.0": r0, "0.3": r1},
                          "over": over_grad(r0, False) + over_grad(r1, True)}
        print(f"  control, {fault} ({key}): at 1.0 surrogate error "
              f"{r0['surrogate']:.3e}, worst gradient error {r0['grad']:.3e} "
              f"({r0['grad_knob']}); at 0.3 surrogate error {r1['surrogate']:.3e}, "
              f"worst gradient error {r1['grad']:.3e} ({r1['grad_knob']}); "
              f"non-finite {r0['nonfinite'] + r1['nonfinite']}", flush=True)
        check(bool(planted[fault]["over"]), f"the soft card-vs-CPU check does not "
              f"catch: {fault}")
    out["planted"] = planted
    return out


def lane_main(out_dir: Path, units) -> None:
    """A lane (``chip_smoke.py --lane DIR UNIT...``): each unit of
    NETSIM_UNITS in turn, its standard output into ``DIR/UNIT.log`` and its
    record into ``DIR/UNIT.json``; a failed check exits non-zero."""
    import contextlib

    sys.path.insert(0, str(SRC))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)     # the lanes share the host's cores
    card = smi_line()
    for unit in units:
        fn = globals()[NETSIM_UNITS[unit][2]]
        t0 = time.perf_counter()
        with (open(out_dir / f"{unit}.log", "w", buffering=1) as log,
              contextlib.redirect_stdout(log)):
            record = fn(torch, card)
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
        (out_dir / f"{unit}.json").write_text(json.dumps(record))
        torch.cuda.empty_cache()


def run_lanes(t_start: float) -> dict:
    """Phases 10-14: the NETSIM_LANES as child processes (each in a session
    of its own, so that stopping it stops its CPU workers too), their logs
    printed in phase order once all have ended; fails the run if a lane
    fails or NETSIM_DEADLINE_S passes. Returns each unit's record."""
    import os
    import shutil
    import signal

    out_dir = ROOT / "build" / "chip_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    lanes, ended = [], {}
    try:
        for i, units in enumerate(NETSIM_LANES):
            with open(out_dir / f"lane{i}.out", "w") as out:
                lanes.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--lane", str(out_dir),
                     *units], stdout=out, stderr=subprocess.STDOUT, cwd=ROOT,
                    start_new_session=True))
        bad = None
        while len(ended) < len(lanes) and bad is None:
            time.sleep(1.0)
            for i, proc in enumerate(lanes):
                if i not in ended and proc.poll() is not None:
                    ended[i] = time.perf_counter() - t0
                    if proc.returncode != 0:
                        bad = f"lane {NETSIM_LANES[i]} exited with {proc.returncode}"
            if time.perf_counter() - t_start > NETSIM_DEADLINE_S:
                bad = f"the lanes were still running {NETSIM_DEADLINE_S:.0f} s after the start"
    finally:
        for proc in lanes:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for unit, (n, title, _) in NETSIM_UNITS.items():
        if title:
            print(f"[{n}/14] {title}", flush=True)
        lane = next(i for i, u in enumerate(NETSIM_LANES) if unit in u)
        print(f"  unit {unit}, lane {lane} ({', '.join(NETSIM_LANES[lane])}):", flush=True)
        log = out_dir / f"{unit}.log"
        print(log.read_text() if log.exists() else "  (not run)\n", end="", flush=True)
    for i, units in enumerate(NETSIM_LANES):
        print(f"  lane {i} ({', '.join(units)}): "
              + (f"ended after {ended[i]:.1f} s" if i in ended else "stopped"), flush=True)
    if bad is not None:
        for i in range(len(lanes)):
            tail = (out_dir / f"lane{i}.out").read_text()[-4000:]
            if tail.strip():
                print(f"--- lane {i} output ---\n{tail}", file=sys.stderr, flush=True)
        fail(bad)
    print(f"  (phases 10-14: {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s)", flush=True)
    return {unit: json.loads((out_dir / f"{unit}.json").read_text())
            for unit in NETSIM_UNITS}


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--lane":
        return lane_main(Path(sys.argv[2]), sys.argv[3:])
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
    print(f"[1/14] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}, compute capability {cap[0]}.{cap[1]}", flush=True)
    check(cap == (9, 0), f"needs compute capability 9.0 (sm_90a), found {cap}")

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(build.sources())
    print(f"[2/14] build: {len(logs)} of {len(build.sources())} kernel sources compiled "
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
    print("[3/14] kernels against their plain versions", flush=True)
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
        print(f"[{i}/14] serve {arch} at full width", flush=True)
        served[arch] = phase_serve(torch, card, arch, faults, must_fail)
        print(f"  ({time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
        torch.cuda.empty_cache()

    trained, faults = {}, train_faults(torch)
    for i, arch in enumerate((QWEN, MAMBA, RG), start=7):
        t0 = time.perf_counter()
        print(f"[{i}/14] train {arch} at full width", flush=True)
        trained[arch] = phase_train(torch, card, arch, faults[arch])
        print(f"  ({time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    torch.cuda.empty_cache()
    units = run_lanes(t_start)
    netsim = units["10"]
    netsim_links = {**units["11"], **units["11g"]}
    netsim_channel = {**units["12"], **units["12g"]}
    obs, netsim_grad = units["13"], units["14"]

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
    print(json.dumps({"obs": obs}))
    print(json.dumps({"netsim_grad": netsim_grad}))
    print(smi_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
