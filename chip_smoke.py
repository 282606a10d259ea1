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
   (B=8, S=2048, H=16, D=64), a GQA shape and ragged S, the prefill shapes
   of phase 15's seven archs at their workloads' batch,
   with and without softcap, and at head dims 8 (zero-padded to the D=16
   instantiation) and 192; then kernel, plain version, library call and
   bound timed at S=512 and S=4096. Windowed flash attention against
   ``attention_ref(window=)`` at recurrentgemma-2b's serving shape (B=4,
   S=4096, Hq=10, Hk=1, D=256, W=2048), ragged S=1000 with W=100, W=1, W >= S
   (which must equal causal) and D=192; then timed there, with SDPA on the
   band as a boolean mask as the library call. Each bf16 case also in bf16
   steps against the plain version of the kernel's own roundings
   (``attention_tiled_ref``: each 64-key tile's unnormalised p rounded),
   under ``FLASH_TILED_TOL``, which P kept in f32 and P normalised before
   rounding must fail. The SSD scan (y and final
   state) against the step-by-step oracle at the mamba2 serving shape, ragged
   S=1000, two groups, chunk 64 and the smoke shape, and in bf16 also against
   its plain version with the same roundings (``ssd_scan_plain(round_to=)``),
   also in bf16 steps (``SSD_ROUNDED_ULP_TOL``, which its f32 arithmetic must
   fail);
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
   new tokens), whose decode replays ``make_serve_step``'s captured CUDA
   graph: a first request captures it, and the measured second request
   through the same step must not capture again; a second decode from a copy
   of the prefill's caches through the eager steps must give the same tokens
   and last logits (bit-equal, else within ``GRAPH_VS_EAGER_TOL``), with
   decode tok/s of both and the whole request's ms (the first with its
   capture, the second, and prefill plus eager decode) printed (so in phases
   5, 6 and 15); the flash kernel's launch count over the measured request must be one per
   attention layer, and the card's prefill logits must agree with the same
   weights' f32 prefill on the CPU (plain path) at B=1, S=128, and the
   model's first attention op of that run replayed on the CPU in bf16 on the
   card's own inputs of that call (the bf16 reference: each op's plain
   version rounds as its bf16 kernel does) under ``CARD_VS_BF16_TOL`` (the
   share of outputs not bit-equal), with cuBLAS's bf16 reduced-precision
   reductions as served (printed).
   As controls, the same checks are read with the plain path in place of
   the kernel, with P kept in f32 and with P normalised before rounding
   (which must fail the bf16 check), and with the causal mask dropped
   (which must fail both). Then the served model layer by layer
   (``layer_replays``, so in phases 5 and 6): every block of that prefill
   kept, and each of its three parts replayed on the CPU in bf16 on the
   card's own input to that part (its kernel op, every call; its mixer
   from the block's input; its MLP from the block's input plus the card's
   mixer output), each under a limit fixed from the card's measured GEMM
   departures (PERF.md §6) and the part's contraction widths (``part_limits``): every
   layer at most half of it, and the controls planted in the middle layer
   (P kept in f32, P normalised before rounding, the MLP's norm in bf16)
   at least ``LAYER_REPLAY_FACTOR`` times it;
5. serve mamba2-370m the same way (its default workload: batch 4, prompt
   2048, 32 new tokens): one SSD-scan launch per SSD layer (48) per prefill,
   and the card-vs-CPU check at B=1, S=300 (two chunks of 128 and a ragged
   third), on the logits and on the first layer's final SSD state, and the
   bf16 check (its first SSD scan replayed), with the controls "state not
   carried across chunks", which must fail both, and "xdt and C B^T L
   rounded to bf16" (the JAX model path's rounding, in the states too),
   which must fail the bf16 check, and layer by layer with the controls
   "xdt and C B^T L rounded to bf16" and "the mixer's norm in bf16" in
   layer 24;
6. serve recurrentgemma-2b the same way (its default workload: batch 4,
   prompt 4096, two windows of its local attention, 32 new tokens): one
   flash launch per local-attention layer (8) and one RG-LRU launch per
   RG-LRU layer (18) per prefill, and the card-vs-CPU check at B=1, S=300 on
   the logits and on the first layer's final RG-LRU state, and the bf16
   check (its first RG-LRU scan and first attention op replayed), with the
   controls "recurrence restarted every 256 steps" (the TPU
   kernel's state carry across sequence blocks dropped), which must fail
   both, and "the 256-step carry rounded to bf16", which must fail the bf16
   check; layer by layer with that carry and "the mixer's norm in bf16" in
   layer 13;
7-9. train qwen1.5-0.5b, mamba2-370m and recurrentgemma-2b at full width
   through ``repro_torch.launch.train`` (each arch's default workload: batch
   8 x 2048 tokens for 5 steps, 4 x 2048 for 3, 1 x 4096 for 3; bf16, AdamW,
   remat "block"): every step's loss and grad norm finite, the loss after the
   last step (on step 1's batch) below step 1's, no restart, and the
   kernels' launches per step as the remat policy makes them (a kernel in a
   rematerialised group runs twice, in the forward and in the recompute; the
   RG-LRU backward runs the kernel once more), and the last step's own
   peak bytes (its arguments plus ``max_memory_allocated`` over the step
   above its start; phase 18 predicts qwen's). qwen's trained state is
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
   release ignores the budget gate"); then (unit 10f) the paper's Fig. 3 at
   its horizons through ``launch.netsim``: Fig. 3b's 7 distances x 6
   message sizes = 42 cells of 4 flows at 220 ms (44,000 steps, one [B=42]
   batch a scheme), Fig. 3c/d's 4 distances at 100 ms and Fig. 3e's 3
   message sizes at 200 ms, with each scheme's wall time, cell-steps per
   second, device ms per step (CUDA events), for Fig. 3b kernels per step
   (100 eager steps under the profiler) and the device's idle share (a
   profiled graph replay); every row, the derived ones (max speedup vs
   DCQCN, buffer and pause reduction, FCT improvement) included, held
   against the JAX package's row for the same cell
   (tests/torch_figure_reference.json): inside JAX's envelope over its base
   run and eight runs with link_gbps moved by 1-4 f32 ulps, widened by the
   port's row limits and one printed digit, or named in ``FIGURE_PARTS``;
   printed per figure: rows held, inside, ``FIGURE_PARTS`` rows and the
   largest reading against its limit. Two controls must fall outside:
   "MatchRDMA's source-OTN release ignores the budget gate" on Fig. 3c/d's
   matchrdma batch and "ring wraps at delay_pad instead of each scenario's
   d_steps" on Fig. 3b's dcqcn batch.
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
   step for each scheme, every row held against JAX's as in phase 10.
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
   kernels per step for each scheme, every row held against JAX's as in
   phase 10.
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
   the "repairs Nx faster" lines, and every row held against JAX's as in
   phase 10.
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

15. serve the seven other archs through ``repro_torch.launch.serve`` at
   their published widths and default workloads (batch, prompt, new tokens):
   internlm2-1.8b, internvl2-2b and granite-moe-1b-a400m (4, 2048, 32),
   musicgen-large (4, 1500, 32; 30 s of EnCodec frames, a masked tail of the
   flash kernel), phi3.5-moe-42b-a6.6b (4, 2048, 32) at 8 of its 32 layers,
   deepseek-67b (1, 4096, 16) at 8 of 95 and nemotron-4-340b (1, 4096, 16)
   at 2 of 96 (depth cut to fit 80 GB in bf16); internvl2 and musicgen take
   bf16 embeddings (a stubbed ViT / EnCodec frontend) and are fed the
   prompt's last one at each decode step. One flash launch per attention
   layer, tokens in range, finite logits; the card's bf16 prefill (B=1,
   S=128) and one decode step against the same weights' f32 on the CPU
   (``CHECK_DEPTH``: phi3.5 at 2 layers, deepseek at 1, nemotron one block
   alone on a [1, 128, 18432] input), and its first attention op replayed
   in bf16 on the CPU (``CARD_VS_BF16_TOL``); for granite and phi3.5 the routing
   check of the first MoE layer on one bf16 input on both sides (``MOE_TOL``:
   top-k sets, drop fractions, the output of the tokens routed alike) at the
   config's capacity factor, which drops slots there, and against its bf16
   copy (``MOE_BF16_TOL``, the router's probabilities as the layer's
   forward computes them), which "router logits in bf16" must fail. Planted
   faults that must fail: "causal mask dropped" (every arch, both checks; deepseek's check reads its
   one layer's hidden states at every position), "gates not renormalised
   over the top-k" and "tokens over capacity kept" (granite, on the routing
   check, whose drop fraction is printed), "unembed read in the tied
   table's layout" and "embeds not cast to act_dtype" (internvl2, fed f32
   embeddings: the assertion on the first layer's input dtype, made in
   every checked prefill, must refuse them);
16. train internlm2-1.8b, internvl2-2b, granite-moe-1b-a400m (4 x 2048
   each) and musicgen-large (4 x 1536) at full width through
   ``repro_torch.launch.train``, 3 steps each, with phases 7-9's checks: the
   losses, the launches per step, and the card's loss (with the MoE aux
   losses) and grads at B=1, S=128 against the CPU's f32.
17. the parallel layer on the card: (a) qwen1.5-0.5b's default training
   workload (8 x 2048, bf16) 3 steps through ``make_train_step`` on a
   one-rank NCCL ``DeviceMesh`` (the model's own parameters, DTensor
   moments) and 3 steps of the plain ``train_step`` from the same seed:
   losses and grad norms within 1e-6 relative per step, the flash launches
   per step as phase 7 counts them, both step times printed; (b) int8
   error-feedback compression of that model's whole gradient, as it is,
   card against CPU: payloads equal but at rounding ties, scales within 1
   ulp; the average of 50 error-feedback rounds within ``EF_SCALED_TOL`` of
   each chunk's scale from the gradient, which the planted fault "residual
   not carried" must fail; (c) ``hierarchical_grad_reduce``
   with ``compress=True`` on a one-rank (pod, data, model) mesh bit-equal to
   compress-then-dequantize over two rounds; (d) granite-moe-1b-a400m's
   grouped MoE layer under a one-rank (pod, data) mesh against the no-mesh
   grouped path: bit-equal at B=1 and the config's capacity factor, within
   ``MOE_TOL``'s layer limit at B=4 with room for every slot, in under 90 s;
   (e) the model split over two ranks of "model" on the one card (two
   processes of this script, gloo over CUDA tensors, since NCCL refuses two
   ranks on one GPU; any collective that gloo refuses on a CUDA tensor would
   be named and staged through host memory in these processes only, and on
   the H100 gloo took them all): qwen1.5-0.5b, mamba2-370m and
   recurrentgemma-2b at full width. Layer by layer, in f32 with TF32 off:
   each layer their blocks and embedding hold (the MLP, the vocab-parallel
   embedding and CE, attention in the arch's case, the SSD with its gated
   norm, the RG-LRU; ``tests/torch_mesh_harness.py`` ``tp_layer_cases``),
   split against itself whole on the same weights, input [2, 512] and output
   gradient at seeds 2 and 3: the output, the input's gradient and every
   parameter's gradient (``readings.split_vs_whole``) each at most half of
   ``TP_LAYER_CARD_TOL`` (``tp_layer_tol``: set from the CPU's f32
   reordering at other seeds, scaled by the contraction width), and the
   planted faults "wo all-reduce dropped", "MLP row-parallel all-reduce
   dropped", "vocab-parallel CE sums not reduced over model", "gated-norm
   sum not reduced over model", "SSD out_proj all-reduce dropped" and
   "RG-LRU gates read the local width only" each at least
   ``TP_FAULT_FACTOR`` times the limit of the layer it breaks. Then the whole
   step (8 x 2048, 4 x 2048, 1 x 4096, bf16) of the tensor-parallel
   ``make_train_step`` on a (1, 1, 2) ("pod", "data", "model") mesh, two
   steps for each of seeds 1 and 2 (the second on the split's own weights
   after its update): its loss and grad norm against the one-rank step's on
   the same batch and weights within ``TP_TOL`` (set from the depth and one
   bf16 rounding a layer), equal on both ranks, each rank holding only its
   shards, the flash kernel on each rank's heads (8 of qwen's 16, 5 of
   recurrentgemma's 10), the kernels' launches a step as phase 7 counts
   them, each rank's step peak (phase 18 predicts qwen's), and a dropped
   row-parallel all-reduce per arch (``TP_STEP_FAULTS``), which must fail
   it; (f) serving split
   over two ranks of "model" on the one card (two processes again, gloo):
   qwen1.5-0.5b (its kv heads split), mamba2-370m (its SSD heads; the states
   kept whole over "model") and recurrentgemma-2b (its RG-LRU width; its
   ring of 2048 slots split 1024 a rank) at full width each serve a request
   of 2 x 1020 tokens through ``make_serve_step`` on a (1, 1, 2) mesh: the
   prefill runs the kernels on each rank's shards (flash on 8 of qwen's 16
   q heads and 5 of recurrentgemma's 10, the SSD scan on 16 of 32 heads, the
   RG-LRU scan on 1280 of 2560), with the launches counted, the caches of
   ``cache_spec``'s local shapes, then 8 eager decode steps
   (``ServeStep.eager``; positions 1020-1027 cross the ring's slot 1024,
   rank 1's first), each fed the one-rank captured serve's token, in bf16
   and with the same weights in f32: against that serve on the same
   weights and prompt, logits within ``TP_SERVE_TOL`` and greedy tokens
   equal but at near ties, equal on both ranks; the planted faults
   "combine dropped (rank-local softmax)" and "wrong sequence offset (every
   rank at 0)" (recurrentgemma) must fail the f32 check. In bf16 each
   decode step's first attention op is also replayed on the CPU on the
   card's inputs (the split's collectives over the same group), within
   ``TP_SERVE_BF16_REF_TOL``, which the control "the combine rounds the
   normalised p" (recurrentgemma) must fail; and the bf16 split prefill of
   a B=1 prompt layer by layer on each rank (``split_layer_replays``): each
   block's parts replayed on the CPU on that rank's inputs as phases 4-6
   read them, each row-parallel sum replayed on the card's own two partials
   (``TP_REDUCE_TOL``: bit-equal) and mamba2's gathered SSD state and conv
   window (``TP_STATE_TOL``); the controls "row-parallel sum truncated
   toward zero" and, for mamba2, "state gathered from rank 0 only" must
   read over.

18. the dry run (``repro_torch.launch.dryrun``: each cell's step on meta
   tensors as rank 0 of a fake process group of the production mesh, with
   its per-rank memory, FLOPs, HBM and collective bytes and roofline):
   qwen1.5-0.5b at train_4k, prefill_32k and decode_32k and mamba2-370m at
   long_500k on both meshes, qwen1.5-0.5b at long_500k (which must read
   ``SKIP(full-attention)``) and granite-moe-1b-a400m at train_4k on
   2 x 16 x 16, each ``OK`` with positive, finite counts; then the card
   check: the dry run of phase 7's workload on a 1 x 1 mesh predicts the
   step's peak bytes (its arguments plus phase 7's ``max_memory_allocated``
   over one step above its start) within ``DRYRUN_PEAK_TOL``, and its
   flash calls a step equal phase 7's launches; the prediction under remat
   "none" (the planted control) must fail that comparison; and the dry run
   of phase 17(e)'s qwen step on a fake (1, 1, 2) group predicts each of the
   two ranks' step peak within ``DRYRUN_PEAK_TOL``, with the ranks'
   arguments exactly and their flash launches.

Phases 1-9 and then 15-16 run alone. Phases 10-14 (no kernel of the port's
three) and 17 (whose checks are exact or read against limits set with room
for the other lanes' load) then run as units in five child
processes of this script beside one another on the card (``NETSIM_LANES``),
so that their wall and device times are read beside the other lanes' load;
each unit's output is printed in phase order once all have ended. Their card-vs-CPU checks run the CPU side in three spawned worker
processes while the card runs (``cpu_pool``). Phase 18's dry run, host
work on meta tensors, runs in a child process of its own (its fake process
group is global to its process) from the start, beside phases 2-17; its
checks are read at the end.

Each serving and training path runs with every kernel's launch count set to
0 just before it and read just after. The last lines are the serving,
training, netsim, multi-link, channel netsim, observability,
differentiable-engine, parallel-layer and dry-run JSON records, the card's
``name, power.limit``, the kernels' JSON record, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
INTERNLM, INTERNVL, MUSICGEN = "internlm2-1.8b", "internvl2-2b", "musicgen-large"
GRANITE, PHI = "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"
DEEPSEEK, NEMOTRON = "deepseek-67b", "nemotron-4-340b"
NEW_ARCHS = (INTERNLM, INTERNVL, MUSICGEN, GRANITE, PHI, DEEPSEEK, NEMOTRON)
NEW_TRAINED = (INTERNLM, INTERNVL, GRANITE, MUSICGEN)
# launch.serve's default workload of each arch: (batch, prompt_len, max_new)
WORKLOADS = {QWEN: (4, 512, 32), MAMBA: (4, 2048, 32), RG: (4, 4096, 32),
             INTERNLM: (4, 2048, 32), INTERNVL: (4, 2048, 32), MUSICGEN: (4, 1500, 32),
             GRANITE: (4, 2048, 32), PHI: (4, 2048, 32), DEEPSEEK: (1, 4096, 16),
             NEMOTRON: (1, 4096, 16)}
# the depth launch.serve cuts a workload to, to fit 80 GB in bf16 (83.7,
# 134.9 and 682.1 GB at full depth); the widths stay the published ones
SERVE_LAYERS = {PHI: 8, DEEPSEEK: 8, NEMOTRON: 2}
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
# The bf16 kernels against the plain versions of their own roundings, in
# bf16 steps (how many representable bf16 values apart): flash attention
# against ``attention_tiled_ref`` (each 64-key tile's unnormalised p rounded
# to bf16), the SSD scan against ``ssd_scan_plain(round_to=bf16)`` with y in
# bf16. Readings: the share of outputs not bit-equal ("differ") and the
# share more than one step apart ("over 1"). A sound kernel parts from its
# plain version where its f32 summation order (and ex2.approx, the SSD
# state's hi/lo split) flips a rounding; the other roundings must read
# over: P in f32 or normalised before rounding (0.37-0.40 and 0.47-0.50 of
# the outputs differ, 0.10-0.12 and 0.16-0.18 over 1 step, on an H100),
# and the SSD's f32 arithmetic. Set before their first card run (PERF.md
# §6), but flash's "over 1", first 1e-3: at S=4096, D=192 the kernel
# read 1.033e-3. The scores' summation order flips the bf16 rounding of a
# few p of a row, and each flipped p moves every output of its row by one
# step of that p's share, many steps of an output that cancellation made
# small; a sound change of the scores' order moves the plain version
# itself so, more at longer S and wider D
# (tests/test_torch_bf16_reference.py).
FLASH_TILED_TOL = {"differ": 2e-2, "over 1": 1e-2}
SSD_ROUNDED_ULP_TOL = {"over 1": 2e-2}
# RG-LRU scan, max abs error against the step-by-step oracle in f32 on the
# same input values (tests/test_kernels.py holds the Pallas kernel to 1e-5).
RGLRU_TOL = 1e-5
# (b, s, hq, hk, d, window) of windowed flash attention at recurrentgemma-2b's
# serving shape, and (b, s, w) of its RG-LRU scan
WINDOWED_SERVING = (4, 4096, 10, 1, 256, 2048)
RGLRU_SERVING = (4, 4096, 2560)
# (b, s, hq, hk, d) of causal flash attention timed at internlm2-1.8b's and
# internvl2-2b's serving prefill (GQA 16:8, D=128) and nemotron-4-340b's
# (GQA 96:8, D=192)
GQA_TIMED = ((4, 2048, 16, 8, 128), (1, 4096, 96, 8, 192))
# (b, s, h, p, g, n, chunk) of the SSD scan at the mamba2-370m serving shape
SSD_SERVING = (4, 2048, 32, 64, 1, 128, 128)
# Card (bf16 activations, kernels) vs CPU (f32, plain path) prefill of the
# same weights (see PERF.md), each reading relative to the largest value of
# its reference: bf16 rounds the residual stream at every layer, so these
# limits sit above bf16's own rounding and cannot see a fault of that size
# (the plain roundings of P read 1.5e-2 here against qwen's sound 1.65e-2);
# CARD_VS_BF16_TOL's check against the bf16 reference is the one that does.
# qwen, the last position's logits: sound runs read 1.6e-2 to 1.7e-2; a
# dropped causal mask must read above the limit.
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
# The seven archs of phases 15-16. Their card-vs-CPU check
# (the same weights' f32 prefill on the CPU, B=1, NEW_REF_LEN tokens, then one
# decode step) reads the whole served model, except where its f32 copy would
# not fit the host beside the card's run: phi3.5-moe at its first 2 layers
# (42 GB in f32 at 8), deepseek-67b at its first layer (the card model's
# embedding, first layers, final norm and unembedding), and nemotron-4-340b
# as its first block alone on the embeddings of NEW_REF_LEN random tokens
# (its embedding and unembedding alone are 75 GB in f32), read on the
# block's own contribution (output less input).
CHECK_DEPTH = {PHI: 2, DEEPSEEK: 1, NEMOTRON: 0}
NEW_REF_LEN = 128
# Each reading relative to the largest value of its reference; the limits
# sit at two to three times the sound readings of an H100 (PERF.md:
# logits and decode logits 1.68e-2 / 1.68e-2 internlm2, 1.78e-2 / 1.65e-2
# internvl2, 1.23e-2 / 1.29e-2 musicgen, 2.26e-2 / 3.18e-2 granite, whose
# routing may flip at near-ties across 24 layers, 4.90e-2 / 3.87e-2 phi3.5,
# 9.9e-3 / 1.07e-2 deepseek; the nemotron block 8.4e-3). Planted faults
# read against them (``new_arch_faults``): a causal mask dropped (GQA 16:8,
# MHA 32:32, 16:8 at D=64, 32:8, deepseek's 64:8 at D=128 and the nemotron
# block's 96:8 at D=192; deepseek's check reads its one layer's hidden
# states at every position, as the last position attends to every key with
# or without the mask), internvl2's unembedding read in a tied table's
# layout, and its embeds left uncast, which the assertion on the first
# layer's input dtype refuses.
CARD_VS_CPU_TOL.update({
    INTERNLM: {"logits": 4e-2, "decode logits": 4e-2},
    INTERNVL: {"logits": 4e-2, "decode logits": 4e-2},
    MUSICGEN: {"logits": 3e-2, "decode logits": 3e-2},
    GRANITE: {"logits": 8e-2, "decode logits": 8e-2},
    PHI: {"logits": 1e-1, "decode logits": 1e-1},
    DEEPSEEK: {"logits": 3e-2, "decode logits": 3e-2, "hidden, every position": 3e-2},
    NEMOTRON: {"block out": 2e-2},
})
SHARE = ", share not bit-equal"   # a reading key's suffix: see ``reading``
# The faults each of whose readings must go over a CARD_VS_CPU_TOL limit
# (phases 4-6 and 15; default: every planted fault of the arch).
MUST_FAIL = {QWEN: ("causal mask dropped",), MAMBA: ("state not carried across chunks",),
             RG: ("recurrence restarted every 256 steps",)}
# Card (bf16) vs the bf16 reference, whose ops' plain versions round as the
# kernels do (the flash op each key tile's unnormalised p, the SSD scan
# x * dt and C B^T L, the RG-LRU its 256-step carry fold): the model's first
# call of each kernel op (attention, SSD scan, RG-LRU scan) in the card's
# check run, replayed on the CPU in bf16 on the card's own inputs of that
# call. Readings: the share of outputs not bit-equal (the RG-LRU's f32 h:
# max abs err / max|ref|). The replay reads the op's rounding alone, in the
# served model, where a bf16-size fault flips a third or more of the
# outputs. The whole model is not read against a CPU bf16 copy: the card's
# bf16 GEMMs depart from one rounding of the f32 sum on 5.8e-4 to 9.9e-3 of
# their outputs, 5 to 33 times as often as a sound change of summation
# order on the host, and the random-weight models carry those flips to the
# logits at the size of bf16's whole rounding, where the f32 check already
# reads (PERF.md §6). Limits as phase 3's on the same inputs
# (FLASH_TILED_TOL's differ; the SSD's; the RG-LRU kernel is its plain
# version bit for bit), set before their first card reading.
REPLAYED = ", replayed"
_FA = "first attention op" + REPLAYED + SHARE
_SSD = "first SSD scan" + REPLAYED + SHARE
_RGLRU = "first RG-LRU scan" + REPLAYED
REPLAY_TOL = {_FA: FLASH_TILED_TOL["differ"], _SSD: 2e-2, _RGLRU: 1e-6}
CARD_VS_BF16_TOL = {
    QWEN: {_FA: REPLAY_TOL[_FA]},
    MAMBA: {_SSD: REPLAY_TOL[_SSD]},
    RG: {_RGLRU: REPLAY_TOL[_RGLRU], _FA: REPLAY_TOL[_FA]},
    **{arch: {_FA: REPLAY_TOL[_FA]} for arch in NEW_ARCHS},
}
# The planted faults each of which must read over a CARD_VS_BF16_TOL limit:
# the plain roundings of P that are not the bf16 flash kernel's; the JAX
# model path's SSD roundings, which the kernel does not make in its state
# path; the RG-LRU's carry rounded to bf16; and each arch's fault in an op
# ("router logits in bf16" on the MoE check, MOE_BF16_TOL).
BF16_MUST_FAIL = {
    QWEN: ("P kept in f32", "P normalised before rounding", "causal mask dropped"),
    MAMBA: ("xdt and C B^T L rounded to bf16", "state not carried across chunks"),
    RG: ("the 256-step carry rounded to bf16", "recurrence restarted every 256 steps"),
    **{arch: ("causal mask dropped",) for arch in NEW_ARCHS},
}
# The served bf16 model layer by layer (phases 4-6; qwen, mamba2 and
# recurrentgemma): in the card's bf16 prefill of the check's prompt (B=1,
# REF_LEN), every block is kept and read in three parts, each replayed on
# the CPU in bf16 (the bf16 reference) on the card's own input to that part,
# so that nothing compounds from one part or layer to the next
# (``repro_torch.readings``): its kernel op (every call, not only the
# first: the share not bit-equal, the RG-LRU's h max-relative; REPLAY_TOL),
# its mixer from the block's input (the norm, the projections, the op and
# its output projection) and its MLP from the block's input plus the card's
# mixer output (OP_FACTOR's comment for the op's limit); these two read the
# share of outputs more than one bf16 step from the replay (a step of the
# larger of the output and the tensor's RMS). A part's limit is fixed from
# earlier measurements of the card's bf16 arithmetic (PERF.md §6: the bf16
# GEMM departs from one rounding of the f32 sum on 5.798e-4 of its outputs
# at K = 1024, 2.325e-3 at 4096 and 9.917e-3 at 18432, linear in K:
# DEPARTURE_PER_K; the kernel ops from their plain versions on the card's
# inputs, the first-call replays' readings: OP_DEPARTURE) and the
# part's contraction widths, read from its parameters: twice the sum of the
# departure shares of its matmuls (each weight [K, N]) and of its kernel op.
# A changed rounding takes an output over one step only where it meets
# another, so the sum bounds the share that can go over; the factor 2 is
# room for the elementwise roundings between them (the gate's product, the
# norm's cast), which were not measured. qwen's parts: mixer 6.84e-3,
# MLP 5.52e-3; mamba2's mixer 8.24e-3; recurrentgemma's RG-LRU mixer
# 1.45e-2, attention mixer 1.38e-2, MLP 1.45e-2. Set before the first judged
# card run, from no reading of it; the judged prompt is REF_LEN's seed-2
# prompt, which no limit was set from. A host emulation (the CPU model with
# each bf16 matmul's rounding flipped at the card's share, on the CPU)
# read the sound mixers at up to 3e-5 (qwen), 1.13e-3 (mamba2) and 1.85e-3
# (recurrentgemma), the MLPs at 0 to 1.3e-6. Every sound layer must read at
# most half each limit; each control, planted in one middle layer
# (LAYER_REPLAY_FAULTS), at least LAYER_REPLAY_FACTOR times the limit of
# the part it breaks there.
DEPARTURE_PER_K = 5.67e-7
OP_DEPARTURE = {_FA: 1.0986e-3, _SSD: 6.41e-4, _RGLRU: 0.0}
# The kernel op of every layer, replayed on its own inputs, is held to
# OP_FACTOR times the largest share that the op's first call read before
# over every arch (OP_DEPARTURE: flash 8.79e-3, the SSD 5.13e-3), tighter
# than the first call's REPLAY_TOL (2e-2), since in the middle layers the
# controls read less (the host emulation read P kept in f32 at 0.106 of
# qwen's layer 12, against 0.351 of its first op on the card); the
# factor leaves the deeper layers' inputs four times the room the first
# call's read had to half the limit (phase 3 read the flash kernel's share
# at 5.2e-5 to 7.8e-3, more at longer S and wider D than this check's). The
# RG-LRU kernel is its plain version bit for bit (REPLAY_TOL's 1e-6).
OP_FACTOR = 8.0
LAYER_REPLAY_FACTOR = 5.0
# arch -> (fault, the part it must fail, the mixer of its layer): the planted
# faults of ``layer_faults``, each in the middle one of the layers of that
# mixer (qwen's layer 12, mamba2's 24, recurrentgemma's 13)
LAYER_REPLAY_FAULTS = {
    QWEN: (("P kept in f32", "op", "attn"), ("P normalised before rounding", "op", "attn"),
           ("the MLP's norm in bf16", "mlp", "attn")),
    MAMBA: (("xdt and C B^T L rounded to bf16", "op", "ssd"),
            ("the mixer's norm in bf16", "mixer", "ssd")),
    RG: (("the 256-step carry rounded to bf16", "op", "rglru"),
         ("the mixer's norm in bf16", "mixer", "rglru")),
}
# The MoE routing check: the first MoE layer on the card (bf16) and its f32
# copy on the CPU, on the same bf16 input (that layer's input in the card's
# prefill of the workload's first row, T = prompt_len tokens), at the
# config's capacity factor, where that input drops slots (a fifth of them
# for granite and phi3.5 with random weights). Readings: the share of
# tokens whose top-k set differs, the drop fractions' difference, and the
# layer output (max abs error / max |ref|) over the tokens routed alike
# (the same top-k set and the same kept slots). Both sides route in f32
# (TF32 off), so a top-k set differs only at a tie within f32 rounding;
# the output differs by the card's bf16 expert products (sound: 5.5e-3
# granite, 7.1e-3 phi3.5). A fault in the gates or the capacity must read
# above a limit (granite's controls).
MOE_TOL = {"topk_set_differs": 1e-3, "drop_frac_diff": 1e-3, "layer_out": 2e-2}
# The same readings against the layer's bf16 copy on the CPU, which routes
# in f32 from the same bf16 input: a top-k set differs only at an f32 tie,
# the router's probabilities as the layer's forward computes them (max abs
# err / max|ref|) by f32 summation order, and the output over tokens routed
# alike by the order of the bf16 expert products. The last two limits are
# four times the larger reading of the layer's bf16 copy against itself
# under a sound change of its matmuls' summation order (K summed in 2 and
# in 4 parts) on the card machine's host, set before the first card
# reading (PERF.md §6). "router logits in bf16" must read over (its top-k
# sets need not differ: phi3.5's 16 experts kept every top-2 set on the
# host).
MOE_BF16_TOL = {GRANITE: {"topk_set_differs": 1e-3, "drop_frac_diff": 1e-3, "layer_out": 9.4e-3,
                          "router_probs": 4e-5},
                PHI: {"topk_set_differs": 1e-3, "drop_frac_diff": 1e-3, "layer_out": 1.4e-2,
                      "router_probs": 4e-5}}
# Phases 4-6 and 15: the captured decode graph against the eager steps from
# a copy of the same prefill's caches. The graph replays the eager step's
# kernels, so the tokens must be equal and the last step's logits bit-equal;
# a difference (max abs / max |eager logit|) is printed with its cause and
# may not pass this limit.
GRAPH_VS_EAGER_TOL = 1e-5
# Phase 17(b): the average of EF_ROUNDS error-feedback rounds is g - e_R / R,
# e_R the last residual, at most half a quantization step of its chunk: so
# each chunk's largest error is at most 1 / (2 R) = 0.01 of its scale
# (amax / 127; the scale of g + e is g's within 1/254). The limit is that
# bound with a quarter's room for f32 sums (0.01001 on a heavy-tailed CPU
# draw); without the residual (the planted fault) the average is one
# rounding of g, up to half a step: ~0.5.
EF_ROUNDS = 50
EF_SCALED_TOL = 0.0125
TRAIN_READ.update({
    INTERNLM: ("embed.tok", "backbone.layers.0.attn.wq", "backbone.layers.23.mlp.w_down"),
    INTERNVL: ("embed.unembed", "backbone.layers.0.attn.wq", "backbone.layers.23.mlp.w_down"),
    MUSICGEN: ("embed.unembed", "backbone.layers.0.attn.wq", "backbone.layers.47.mlp.w_down"),
    GRANITE: ("embed.tok", "backbone.layers.0.attn.wq", "backbone.layers.0.moe.router",
              "backbone.layers.23.moe.w_down"),
})
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
# Unit 10f: the paper's Fig. 3 at its horizons (benchmarks/figures.py), name ->
# (full grid, horizon us, cells a scheme): 3b 7 distances x 6 message sizes at
# 220 ms, 3c/d 4 distances at 100 ms, 3e 3 message sizes at 200 ms; each
# scheme's grid one batch. Every row of these and of phases 11g, 12g and 13's
# figures is held against the JAX package's rows for the same cells, recorded
# with JAX's spread over one-ulp moves of link_gbps
# (tests/torch_figure_reference.py, its .json; the card machine has no JAX).
NETSIM_FIG3 = {"fig3b": (True, 220_000.0, 42), "fig3cd": (True, 100_000.0, 4),
               "fig3e": (False, 200_000.0, 3)}
# eager steps profiled a scheme there (kernels a step, idle share): Fig. 3b's
NETSIM_FIG3_PROFILE_STEPS = {"fig3b": 100, "fig3cd": 0, "fig3e": 0}
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
# and 15-16 have run alone, they run as units in child processes of this script, one
# lane a process, the lanes beside one another on the one card (each lane's
# units one after another): the netsim is host-bound (eager steps, graph
# capture, the CPU side of its checks) and leaves the card idle most of the
# time; one after another the five phases took 857 s, the script 1,081 s
# (NVIDIA H100 80GB HBM3 at 700 W), beside one another 579 s. Their wall
# and device times are therefore read beside the other lanes' load. A unit
# is a phase or a part of one: (phase, title, function).
NETSIM_UNITS = {
    "10": (10, "netsim Fig. 3 path", "phase_netsim"),
    "10f": (10, "", "phase_netsim_figures"),
    "11": (11, "netsim: seven schemes over the multi-link and multi-site long haul",
           "phase_netsim_links"),
    "11g": (11, "", "phase_netsim_links_grids"),
    "12": (12, "netsim: the impaired, replayed and failing long haul",
           "phase_netsim_channel"),
    "12g": (12, "", "phase_netsim_channel_grids"),
    "13": (13, "observability and training traffic", "phase_obs"),
    "14": (14, "the differentiable engine and the gradient tuner", "phase_netsim_grad"),
    "17": (17, "the parallel layer on the card", "phase_parallel"),
    "17t": (17, "", "phase_tensor_parallel"),
    "17s": (17, "", "phase_tensor_parallel_serve"),
}
# the lanes, balanced on the units' times alone (s, same card; NVIDIA H100
# 80GB HBM3, 700 W): 17 23 + 17t ~215 (each split layer against
# itself whole, two seeds of two steps) + 17s ~100; 14 222 + 10 ~45; 12g 229
# + 11g 145; 13 147 + 12 111; 11 75 after 10, where lane 1 ended ~175 s
# before the last lane; 10f 226 (Fig. 3 at the paper's horizons, GPU-bound
# graph replays) in a lane of its own (under the lanes' load a unit takes
# 1.3-1.8x its time alone). 17t and 17s share a lane: the two hold whole
# models on the one card, and beside one another they do not fit in its
# 80 GB (17t's rank 0 steps recurrentgemma unsplit, ~46 GB, while 17s's two
# ranks each build it in bf16 and again in f32). Phase 17's checks are
# exact or read against limits that load does not move.
NETSIM_LANES = (("17", "17t", "17s"), ("14", "10", "11"), ("12g", "11g"), ("13", "12"),
                ("10f",))
# the lanes are stopped, and the run fails, this many seconds after the
# script's start
NETSIM_DEADLINE_S = 1_140.0
# Phase 18, the dry run's cells: (arch, shape, multi_pod) and the status
# each must read
DRYRUN_CELLS = tuple((QWEN, shape, mp, "OK") for shape in ("train_4k", "prefill_32k",
                                                           "decode_32k") for mp in (False, True)) + (
    (MAMBA, "long_500k", False, "OK"), (MAMBA, "long_500k", True, "OK"),
    (QWEN, "long_500k", False, "SKIP(full-attention)"), (GRANITE, "train_4k", True, "OK"))
# The card check: the dry run's peak bytes of phase 7's step (qwen, 8 x
# 2048, remat "block", a 1 x 1 mesh) relative to the card's (the step's
# arguments plus max_memory_allocated over one step above its start). Both
# count the same tensors of the same program (the meta branch allocates the
# kernel's output, as the kernel does); the card adds cuBLAS and allocator
# rounding (512 B a block) and whatever the kernels allocate beside their
# outputs. The control, remat "none", keeps every layer's activations: it
# predicts about twice the bytes (38.9 GB against 19.4 GB on the CPU) and
# must read over the limit.
DRYRUN_PEAK_TOL = 0.05


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


def bf16_steps(torch, a, b):
    """How many bf16 values apart each element of ``a`` is from ``b`` (bf16)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def step_readings(torch, a, b) -> dict:
    """FLASH_TILED_TOL's readings of ``a`` against ``b`` (bf16, same shape)."""
    u = bf16_steps(torch, a, b)
    return {"differ": float((u > 0).float().mean()), "over 1": float((u > 1).float().mean())}


def tiled_check(torch, name: str, out, q, k, v, softcap: float, window: int, p_f32) -> dict:
    """The bf16 flash kernel's output ``out`` against the plain version of its
    roundings, under FLASH_TILED_TOL; P kept in f32 (``p_f32``,
    attention_ref's output in bf16) and P normalised before rounding must
    read over the limits, but with a window of 1."""
    from repro_torch.kernels.ref import attention_ref, attention_tiled_ref
    tiled = attention_tiled_ref(q, k, v, softcap=softcap, window=window)
    r = {"kernel": step_readings(torch, out, tiled),
         "P kept in f32": step_readings(torch, p_f32, tiled),
         "P normalised before rounding": step_readings(torch, attention_ref(
             q, k, v, softcap=softcap, window=window, p_dtype=torch.bfloat16), tiled)}
    ok = all(r["kernel"][key] <= lim for key, lim in FLASH_TILED_TOL.items())
    caught = [c for c in ("P kept in f32", "P normalised before rounding")
              if any(r[c][key] > lim for key, lim in FLASH_TILED_TOL.items())]
    # (with W = 1 a row's one p is exactly 1 however it is rounded)
    told = len(caught) == 2 or window == 1
    print("    against its roundings (attention_tiled_ref), share of outputs: " + "; ".join(
        f"{c} differ {x['differ']:.3e}, over 1 step {x['over 1']:.3e}" for c, x in r.items())
          + f" (tolerance {FLASH_TILED_TOL}) {'ok' if ok and told else 'FAIL'}", flush=True)
    check(ok, f"bf16 flash_attention parts from the plain version of its roundings at {name}")
    check(told, f"the tiled check at {name} does not tell the kernel's rounding of P from "
                f"{caught}")
    return r


def phase_flash(torch, card: str) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.cost import attention_bound_ms
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
        # the prefill shapes of the seven archs of phase 15, at their
        # workloads' batch
        ("internlm2 16/8 d128", 4, 2048, 16, 8, 128, "bfloat16", 0.0),
        ("phi3.5 32/8 d128", 4, 2048, 32, 8, 128, "bfloat16", 0.0),
        ("deepseek 64/8 d128", 1, 4096, 64, 8, 128, "bfloat16", 0.0),
        ("musicgen 32/32 d64", 4, 1500, 32, 32, 64, "bfloat16", 0.0),
        ("granite 16/8 d64", 4, 2048, 16, 8, 64, "bfloat16", 0.0),
        ("nemotron 96/8 d192", 1, 4096, 96, 8, 192, "bfloat16", 0.0),
        ("nemotron 96/8 d192", 1, 1500, 96, 8, 192, "float32", 0.0),
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
        if dtype == "bfloat16":
            del diff
            checks[-1]["tiled"] = tiled_check(torch, name, out, q, k, v, softcap, 0,
                                              ref.to(q.dtype))

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
            p_f32 = ref.to(q.dtype)
            del ref, diff
            print(f"  flash_attention {name:16s} B={b} S={s} Hq={hq} Hk={hk} D={d} W={w} "
                  f"{dtype:8s}: max_abs_err={err:.3e} (tolerance |err| <= {atol:g} + "
                  f"{rtol:g}|ref|) {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"windowed flash_attention disagrees with attention_ref at {name} {dtype}")
            checks.append({"case": f"{name} {dtype} window={w}", "max_abs_err": err,
                           "atol": atol, "rtol": rtol})
            if dtype == "bfloat16":
                checks[-1]["tiled"] = tiled_check(torch, name, out, q, k, v, 0.0, w, p_f32)
            del p_f32

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

    for b, s, hq, hk, d in GQA_TIMED:
        q, k, v = inputs(b, s, hq, hk, d, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = time_ms(torch, lambda: flash_attention_fwd(q, k, v), 10)
        plain_ms = time_ms(torch, lambda: attention_ref(q, k, v), 2)
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        bound_ms, bound_by = attention_bound_ms(b, s, hq, hk, d, 2)
        timings[f"B={b} S={s} Hq={hq} Hk={hk} D={d}"] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"  flash_attention B={b} S={s} Hq={hq} Hk={hk} D={d} bf16: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa (enable_gqa) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
        del q, k, v, qt, kt, vt

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
    from repro_torch.kernels.cost import ssd_bound_ms
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
                # in bf16 steps from it (y rounded once to bf16), the kernel
                # and the f32 arithmetic (no rounding before the products)
                y_rnd, y_f32 = y_rnd.to(x.dtype), ops.ssd_scan_plain(x, dt, A, B, C,
                                                                      chunk=chunk)[0]
                steps = {"kernel": step_readings(torch, y, y_rnd),
                         "f32 arithmetic": step_readings(torch, y_f32, y_rnd)}
                ok = ok and steps["kernel"]["over 1"] <= SSD_ROUNDED_ULP_TOL["over 1"]
                told = steps["f32 arithmetic"]["over 1"] > SSD_ROUNDED_ULP_TOL["over 1"]
                rounded = (f", y vs rounded plain rel={err_rnd:.3e} (tolerance "
                           f"{SSD_ROUNDED_TOL:g}); in bf16 steps from it, share of outputs: "
                           + "; ".join(f"{c} differ {r['differ']:.3e}, over 1 step "
                                       f"{r['over 1']:.3e}" for c, r in steps.items())
                           + f" (tolerance {SSD_ROUNDED_ULP_TOL}; the f32 arithmetic told "
                             f"apart: {told})")
                check(told, f"the SSD step reading at {name} cannot tell the f32 arithmetic")
                del y_rnd, y_f32
            print(f"  ssd_scan {name:15s} b={b} s={s} h={h} p={p} g={g} n={n} L={chunk} "
                  f"{dtype:8s}: y max_abs_err={abs_err:.3e} rel={err_y:.3e} (tolerance "
                  f"{SSD_TOL[dtype]:g}), state rel={err_state:.3e} (tolerance "
                  f"{STATE_TOL:g}){rounded} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"ssd_scan disagrees with its plain versions at {name} {dtype}")
            checks.append({"case": f"{name} {dtype}", "max_abs_err": abs_err,
                           "rel_err": err_y, "state_rel_err": err_state,
                           "rel_tol": SSD_TOL[dtype], "state_rel_tol": STATE_TOL,
                           **({"rounded_rel_err": err_rnd, "rounded_rel_tol": SSD_ROUNDED_TOL,
                               "rounded_steps": steps} if rounded else {})})

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
    from repro_torch.kernels.cost import rglru_bound_ms
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


def attention_layers(cfg) -> int:
    from repro_torch.config.base import ATTN, LOCAL_ATTN
    return sum(mixer in (ATTN, LOCAL_ATTN) for mixer, _ in cfg.layer_blocks())


def expected_launches(cfg) -> dict:
    """Each kernel's launches in one prefill: one per layer of its mixer."""
    from repro_torch.config.base import RGLRU, SSD
    mixers = [mixer for mixer, _ in cfg.layer_blocks()]
    return {"flash_attention": attention_layers(cfg),
            "ssd_scan": mixers.count(SSD), "rglru_scan": mixers.count(RGLRU)}


def check_widths(cfg, arch: str, layers=None) -> None:
    """``cfg`` is the arch's published config, cut to ``layers`` of depth if given."""
    from repro_torch.config import get_model_config
    published = get_model_config(arch)
    check(dataclasses.replace(cfg, num_layers=published.num_layers) == published
          and cfg.num_layers == (layers or published.num_layers),
          f"{arch} is not at its published widths and {layers or 'full'} depth: {cfg}")


def serve_workload(torch, card: str, arch: str):
    """Serves ``arch``'s launch.serve default workload on the card with every
    launch count set to 0 before and read after; checks the launches (one per
    layer of each kernel's mixer), the tokens and the logits. Returns
    (model, result, launches, expected launches, prompt)."""
    from repro_torch.config.base import ParallelConfig
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.decode import make_serve_step

    batch, prompt_len, max_new = WORKLOADS[arch]
    layers = SERVE_LAYERS.get(arch)
    check(tuple(launch_serve.WORKLOADS[arch]) == (batch, prompt_len, max_new, layers),
          f"chip_smoke's {arch} workload is not launch.serve's default workload")
    model = launch_serve.build(arch, device="cuda", layers=layers)
    cfg = model.cfg
    check_widths(cfg, arch, layers)
    expected = expected_launches(cfg)
    prompt = launch_serve.random_prompt(model, batch, prompt_len)
    # the first request through a new step captures its graph (and warms up
    # cuBLAS handles and the allocator's blocks at the run's cache size); a
    # prefill after it finds the blocks that the capture took (nemotron's f32
    # table is 18.9 GB, once on the capture's side stream and once in the
    # graph's pool) released; the measured request is the next one, which
    # copies its prefill's caches into the graph's
    step, _, _ = make_serve_step(model, ParallelConfig(data=1, model=1), None, batch,
                                 prompt_len + max_new)
    first = launch_serve.serve(model, prompt, max_new, step=step)
    caches, logits = model.prefill(prompt, max_len=prompt_len + max_new)
    del caches, logits

    reset_counts()
    res = launch_serve.serve(model, prompt, max_new, step=step, keep_prefill=True)
    launches = read_counts()
    depth = f", {cfg.num_layers} of its layers" if layers else ""
    print(f"  serve {arch}{depth} B={batch} prompt={prompt_len} new={max_new}: prefill "
          f"{res.prefill_ms:.2f} ms, decode (captured graph) {res.decode_tok_s:.1f} tok/s "
          f"({res.decode_tokens} tokens in {res.decode_ms:.2f} ms; cache copy "
          f"{res.load_ms:.2f} ms), request {res.request_ms:.2f} ms; the first request "
          f"{first.request_ms:.2f} ms (prefill {first.prefill_ms:.2f}, capture "
          f"{first.load_ms:.2f}, decode {first.decode_ms:.2f}); launches {launches} "
          f"[{card}]", flush=True)
    check(first.captured and not res.captured and step.captures == 1,
          f"the decode step was captured {step.captures} times for one (batch, cache length)")
    check(launches == expected, f"kernel launches {launches} in one prefill, expected "
          f"{expected} (one per layer of the kernel's mixer; the captured decode step "
          f"launches none of the three kernels)")
    res.eager = graph_vs_eager(torch, model, res, prompt, prompt_len, max_new)
    res.eager.update(first_request_ms=first.request_ms, first_capture_ms=first.load_ms)
    del step
    check(tuple(res.tokens.shape) == (batch, max_new), f"tokens {tuple(res.tokens.shape)}")
    check(bool(((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()), "token out of range")
    for name, t in (("prefill", res.prefill_logits), ("last decode", res.logits)):
        check(tuple(t.shape) == (batch, cfg.vocab_size) and t.dtype == torch.float32,
              f"{name} logits {tuple(t.shape)} {t.dtype}")
        check(bool(torch.isfinite(t).all()), f"{name} logits are not finite")
    return model, res, launches, expected, prompt


def graph_vs_eager(torch, model, res, prompt, prompt_len: int, max_new: int) -> dict:
    """Decodes again from the copy of the prefill's caches through the eager
    steps: the tokens must equal the captured graph's, and the last step's
    logits be bit-equal, or else within GRAPH_VS_EAGER_TOL of each other
    (max abs difference / max |eager logit|, printed with its cause)."""
    from repro_torch.serve.decode import greedy_decode

    last = None if model.cfg.embed_inputs else prompt[:, -1:]
    token = res.tokens[:, 0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rest, logits = greedy_decode(model, res.prefill_caches, token, prompt_len, max_new - 1,
                                 last, graph=False)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3
    res.prefill_caches = None
    same_tokens = bool(torch.equal(rest, res.tokens[:, 1:]))
    diff = float((logits - res.logits).abs().max()) / float(logits.abs().max())
    eager_tok_s = res.decode_tokens / (eager_ms / 1e3)
    eager_request_ms = res.prefill_ms + eager_ms
    cause = ("bit-equal" if diff == 0.0 else
             "the graph's kernels are the eager step's; a difference is a kernel that "
             "chose another algorithm or reduction order at capture")
    print(f"  decode through the eager steps from a copy of the prefill's caches: "
          f"{eager_tok_s:.1f} tok/s ({eager_ms:.2f} ms) against the graph's "
          f"{res.decode_tok_s:.1f} tok/s ({res.decode_tok_s / eager_tok_s:.2f}x); request "
          f"with eager decode {eager_request_ms:.2f} ms against {res.request_ms:.2f} ms; "
          f"tokens equal: {same_tokens}; last logits {diff:.3e} ({cause}; limit "
          f"{GRAPH_VS_EAGER_TOL:g})", flush=True)
    check(same_tokens, "the captured decode's tokens differ from the eager steps'")
    check(diff <= GRAPH_VS_EAGER_TOL, f"the captured decode's logits differ from the eager "
                                      f"steps' by {diff:.3e}")
    return {"eager_ms": eager_ms, "eager_tok_s": eager_tok_s, "graph_ms": res.decode_ms,
            "graph_tok_s": res.decode_tok_s, "cache_copy_ms": res.load_ms,
            "request_ms": res.request_ms, "eager_request_ms": eager_request_ms,
            "tokens_equal": same_tokens, "last_logits_diff": diff}


def check_setup(torch, model, arch: str):
    """The pieces of ``arch``'s card-vs-CPU check on ``model`` (the card's in
    ``phase_serve``): (view, run, counted, what, copy). ``view`` is what the
    check reads of the model (CHECK_DEPTH of its layers, or its first block
    alone); ``run(m)`` maps each reading
    key of the arch to its value on ``m`` (``view`` or a copy of it) at B=1
    (REF_LEN, else NEW_REF_LEN tokens), with one decode step where the
    limits read "decode logits"; a model of embedding inputs is fed f32
    embeddings, which it casts; ``counted`` is one run's kernel launches on
    the card, ``what`` says what it reads and ``copy()`` makes an f32 copy
    of ``view`` on the CPU."""
    from repro_torch.device import dtype_of
    from repro_torch.launch import serve as launch_serve

    cfg, limits = model.cfg, CARD_VS_CPU_TOL[arch]
    n, depth = REF_LEN.get(arch, NEW_REF_LEN), CHECK_DEPTH.get(arch)
    if depth == 0:
        # the first block alone on the embeddings of n random tokens, read on
        # its own contribution (output less input)
        view = model.backbone.layers[0]
        dev = model.device
        toks = torch.randint(0, cfg.vocab_size, (1, n), device=dev,
                             generator=torch.Generator(device=dev).manual_seed(2))
        with torch.no_grad():
            x = model.embed(toks)
        counted = expected_launches(dataclasses.replace(cfg, num_layers=1))

        def run(m):
            xd = x if m is view else x.float().cpu()
            with torch.no_grad(), first_op_calls() as calls:
                y = m(xd, mode="prefill", cache=None, pos=None, max_len=n)[0]
            return {"block out": y - xd, "layers": [y], **replayed(torch, calls)}

        def copy():
            return f32_block(torch, view, cfg)
    else:
        view = first_layers(torch, model, depth) if depth else model
        decode = int("decode logits" in limits)
        small = launch_serve.random_prompt(view, 1, n + decode, seed=2)
        if not cfg.embed_inputs:
            small = small.float()        # a frontend's f32 output, which the model casts
        inputs, step = small[:, :n], small[:, n:]     # the decode step's input, if any
        if small.dim() == 2:
            step = step[:, 0] if decode else None
        counted = expected_launches(view.cfg)

        def run(m):
            # the first layer's input must be in the model's act dtype; the
            # final norm's output is every position's hidden state; each
            # layer's output is kept ("layers")
            seen, layers = [], []
            hooks = [m.backbone.layers[0].register_forward_pre_hook(
                lambda mod, args, want=dtype_of(m.cfg.act_dtype): first_layer_dtype(args[0],
                                                                                     want)),
                m.backbone.final_norm.register_forward_hook(
                    lambda mod, args, y: seen.append(y))]
            hooks += [layer.register_forward_hook(lambda mod, args, y: layers.append(y[0]))
                      for layer in m.backbone.layers]
            try:
                with first_op_calls() as calls:
                    caches, logits = m.prefill(inputs.to(m.device), max_len=n + decode)
            finally:
                for hook in hooks:
                    hook.remove()
            got = {"logits": logits, "layers": layers, **replayed(torch, calls)}
            if "hidden, every position" in limits:
                got["hidden, every position"] = seen[0]
            if "layer-0 state" in limits:
                got["layer-0 state"] = caches[0][STATE_KEY[arch]]
            if decode:
                got["decode logits"] = m.decode_step(caches, step.to(m.device), n)[1]
            return got

        def copy():
            return f32_copy(torch, view)
    what = ("block 0 alone" if depth == 0 else
            f"first {depth} layers" if depth else f"all {cfg.num_layers} layers")
    then = ", then a decode step" if "decode logits" in limits else ""
    return view, run, counted, f"{what}; B=1, S={n}{then}", copy


@contextlib.contextmanager
def first_op_calls(every: bool = False):
    """Inside the context the model's first call of each kernel op (its
    attention, global or local; its SSD scan; its RG-LRU scan) is kept:
    yields a dict of (the sound op, its arguments, its output) under the
    replayed key's name; with ``every``, a list of every call's in call order
    (one a layer of the op's mixer). The ops are wrapped as the model's
    modules hold them when the context opens, a planted fault included; the
    sound op is the port's own."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import attention, rglru, ssm, transformer
    calls = {}
    sites = {(transformer, "flash_attention"): (_FA, ops.flash_attention),
             (transformer, "local_attention"): (_FA, attention.local_attention),
             (ssm, "ssd_scan"): (_SSD, ops.ssd_scan),
             (rglru, "rglru_recurrence"): (_RGLRU, ops.rglru_recurrence)}
    kept = {site: getattr(*site) for site in sites}

    def wrap(site):
        key, sound = sites[site]
        key = key.removesuffix(SHARE)

        def op(*args, **kwargs):
            out = kept[site](*args, **kwargs)
            if every or key not in calls:
                call = (sound, [a.detach().to("cpu", copy=True)
                                if torch.is_tensor(a) else a for a in args],
                        kwargs, (out[0] if isinstance(out, tuple) else out).detach())
                if every:
                    calls.setdefault(key, []).append(call)
                else:
                    calls[key] = call
            return out
        return op

    for site in sites:
        setattr(*site, wrap(site))
    try:
        yield calls
    finally:
        for site, fn in kept.items():
            setattr(*site, fn)


def replayed(torch, calls: dict) -> dict:
    """Each kept call's (output on the CPU, the sound op's output on the same
    inputs on the CPU)."""
    return {key: replay_call(torch, call) for key, call in calls.items()}


def replay_call(torch, call) -> tuple:
    """A kept op call's (output on the CPU, the sound op's on its inputs)."""
    sound, args, kwargs, got = call
    with torch.no_grad():
        again = sound(*args, **kwargs)
    return got.cpu(), again[0] if isinstance(again, tuple) else again


def reading(key: str, got: dict, ref: dict) -> float:
    """A reading of ``got`` against ``ref`` (``run``'s values). A replayed
    key reads ``got``'s kept op call against its replay (``ref`` unused).
    For a key "X, share not bit-equal" the share of X's elements (bf16) that
    differ, else max_abs_err / max|ref| of the key."""
    if REPLAYED in key:
        a, b = got[key.removesuffix(SHARE)]
    else:
        a, b = got[key.removesuffix(SHARE)], ref[key.removesuffix(SHARE)]
    if key.endswith(SHARE):
        return float((a.cpu() != b.cpu()).float().mean())
    return rel_err(a, b.float().cpu())


def readings_of(got, refs, keys) -> dict:
    return {k: reading(k, got, refs) for k in keys}


@contextlib.contextmanager
def planted_fault(module, attr: str, fn):
    """``module.attr`` replaced by ``fn`` inside the context."""
    kept = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, kept)


def run_refused(run, m):
    """``run(m)``, or {"refused": ...} where the bf16 path refuses its input
    for a dtype mismatch (no other error counts)."""
    try:
        return run(m)
    except RuntimeError as err:
        if "dtype" not in str(err):
            raise
        return {"refused": f"{type(err).__name__}: {str(err)[:160]}"}


def control_readings(got, refs, keys) -> dict:
    return dict(got) if "refused" in got else readings_of(got, refs, keys)


def over_bf16(readings: dict, limits: dict) -> list:
    """The reading keys over their limits; a refusal counts as over."""
    if "refused" in readings:
        return ["refused"]
    return [k for k in readings if readings[k] > limits[k]]


def phase_serve(torch, card: str, arch: str, planted: dict, must_fail=None,
                moe_planted=None) -> dict:
    """Serves ``arch`` through launch.serve at its default workload and checks
    it: launches, tokens, logits (``serve_workload``); then the card's bf16
    prefill at B=1 (``check_setup``) against the same weights' f32 on the
    CPU (plain path), at CHECK_DEPTH where the whole model's f32 copy would
    not fit, under CARD_VS_CPU_TOL; and each kernel op's first call of that
    run replayed on the CPU in bf16 (the bf16 reference: the plain versions
    with the kernels' roundings) under CARD_VS_BF16_TOL, with cuBLAS's bf16
    reduced-precision reductions as the serve path runs them (printed); for
    an MoE arch the routing check of its first MoE layer (``moe_check``,
    against its f32 and bf16 copies).

    ``planted`` maps a fault's name to (module, attribute, replacement): the
    card's check is read again with each in place. Each fault named in
    ``must_fail`` (default: every one) must read above a CARD_VS_CPU_TOL
    limit, and each of BF16_MUST_FAIL[arch] above a CARD_VS_BF16_TOL one;
    or make the card's bf16 path refuse its input for a dtype mismatch (no
    other error counts)."""
    batch, prompt_len, max_new = WORKLOADS[arch]
    model, res, launches, _, prompt = serve_workload(torch, card, arch)
    cfg, limits, limits16 = model.cfg, CARD_VS_CPU_TOL[arch], CARD_VS_BF16_TOL[arch]
    n, depth = REF_LEN.get(arch, NEW_REF_LEN), CHECK_DEPTH.get(arch)
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    out = {"arch": arch, "layers": cfg.num_layers, "batch": batch, "prompt_len": prompt_len,
           "max_new": max_new, "launches": launches, "prefill_ms": res.prefill_ms,
           "decode_ms": res.decode_ms, "decode_tok_s": res.decode_tok_s,
           "decode_graph_vs_eager": res.eager, "card_vs_cpu_tol": limits,
           "card_vs_bf16_tol": limits16, "ref_len": n, "check_depth": depth,
           "bf16_reduced_precision_reduction": reduced}
    t0 = time.perf_counter()
    view, run, counted, what, copy = check_setup(torch, model, arch)
    reset_counts()
    card_out = run(view)
    check(read_counts() == counted, f"the card-vs-CPU check's launches {read_counts()}, "
                                    f"expected {counted}")
    cpu_model = copy()
    refs = run(cpu_model)
    cpu_moe = next((m for m in cpu_model.modules() if type(m).__name__ == "MoE"), None)
    del cpu_model

    sound = readings_of(card_out, refs, limits)
    same = ""
    if "logits" in refs:
        out["same_argmax"] = bool((card_out["logits"].argmax(-1).cpu()
                                   == refs["logits"].argmax(-1)).all())
        same = f"; same argmax={out['same_argmax']}"
    print(f"  card bf16 vs CPU f32 ({what}; {time.perf_counter() - t0:.1f} s), "
          f"max_abs_err / max|ref|: "
          + ", ".join(f"{k} {v:.3e} (tolerance {limits[k]:g})" for k, v in sound.items())
          + same, flush=True)
    check(all(v <= limits[k] for k, v in sound.items()),
          f"{arch}: the card disagrees with the CPU f32 path")
    out["card_vs_cpu"] = sound

    sound16 = readings_of(card_out, None, limits16)
    print(f"  card bf16 vs the CPU bf16 reference (each kernel op's first call replayed on "
          f"the card's inputs; cuBLAS bf16 reduced-precision reductions {reduced}, as "
          f"served): " + ", ".join(f"{k} {v:.3e} (tolerance {limits16[k]:g})"
                                   for k, v in sound16.items()), flush=True)
    check(all(v <= limits16[k] for k, v in sound16.items()),
          f"{arch}: the card disagrees with the CPU bf16 reference")
    out["card_vs_bf16"] = sound16

    # Controls: the same readings with a fault planted in place of the path.
    controls, controls16 = {}, {}
    for fault, (module, attr, fn) in planted.items():
        with planted_fault(module, attr, fn):
            got = run_refused(run, view)
        controls[fault], controls16[fault] = (control_readings(got, refs, limits),
                                              control_readings(got, None, limits16))
        shown = {ref: ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k}, {v}"
                                for k, v in r[fault].items())
                 for ref, r in (("f32", controls), ("bf16", controls16))}
        print(f"  control, {fault}: vs CPU f32 {shown['f32']}; vs the CPU bf16 reference "
              f"{shown['bf16']}; over the bf16 limits: {over_bf16(controls16[fault], limits16)}",
              flush=True)
    for fault in planted if must_fail is None else must_fail:
        check("refused" in controls[fault] or any(
            v > limits[k] for k, v in controls[fault].items()),
            f"the card-vs-CPU check does not catch: {fault}")
    for fault in BF16_MUST_FAIL[arch]:
        check(bool(over_bf16(controls16[fault], limits16)),
              f"the card-vs-bf16 check does not catch: {fault}")
    out["planted"], out["planted_vs_bf16"] = controls, controls16
    if arch in LAYER_REPLAY_FAULTS:
        out["layer_replays"] = layer_replays(torch, model, arch, card)
    if cfg.num_experts:
        out["moe"] = moe_check(torch, model, cpu_moe, prompt, moe_planted or {},
                               MOE_BF16_TOL[arch])
    return out


def op_key(mixer: str) -> str:
    """The replayed key of a mixer's kernel op."""
    from repro_torch.config.base import ATTN, LOCAL_ATTN, SSD
    return _FA if mixer in (ATTN, LOCAL_ATTN) else _SSD if mixer == SSD else _RGLRU


def part_limits(block, mixer: str) -> dict:
    """LAYER_REPLAY's limits of one block's parts: {"op", "mixer", "mlp"}."""
    def matmuls(module):
        return sum(DEPARTURE_PER_K * p.shape[0] for n, p in module.named_parameters()
                   if p.dim() == 2 and not n.startswith("conv"))
    from repro_torch.readings import mixer_of
    key = op_key(mixer)
    mix = mixer_of(block)
    op = OP_FACTOR * OP_DEPARTURE[key] if OP_DEPARTURE[key] else REPLAY_TOL[key]
    out = {"op": op, "mixer": 2.0 * (matmuls(mix) + OP_DEPARTURE[key])}
    if block.mlp is not None:
        out["mlp"] = 2.0 * matmuls(block.mlp)
    return out


@contextlib.contextmanager
def in_layer(model, layer: int, owner, attr: str, fn):
    """``owner.attr`` replaced by ``fn`` while block ``layer`` of ``model``
    runs, and only then."""
    kept = getattr(owner, attr)
    on = [False]
    block = model.backbone.layers[layer]
    hooks = [block.register_forward_pre_hook(lambda *a: on.__setitem__(0, True)),
             block.register_forward_hook(lambda *a: on.__setitem__(0, False))]
    setattr(owner, attr, lambda *a, **k: (fn if on[0] else kept)(*a, **k))
    try:
        yield
    finally:
        setattr(owner, attr, kept)
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def norm_in_bf16(norm):
    """``norm`` (an RMSNorm of bf16 activations) computed in bf16: its mean
    of squares, rsqrt and products rounded to bf16, where the path computes
    in f32 and rounds once."""
    def forward(x):
        var = x.square().mean(dim=-1, keepdim=True)
        return x * (var + norm.eps).rsqrt() * norm.scale.to(x.dtype)
    norm.forward = forward
    try:
        yield
    finally:
        del norm.forward


def layer_faults(torch, model, arch: str) -> dict:
    """LAYER_REPLAY_FAULTS as contexts: fault -> (layer, part, context)."""
    sites = {**qwen_faults(torch), **mamba_faults(torch), **rglru_faults(torch)}
    mixers = [m for m, _ in model.cfg.layer_blocks()]
    out = {}
    for fault, part, mixer in LAYER_REPLAY_FAULTS[arch]:
        at = [i for i, m in enumerate(mixers) if m == mixer]
        layer = at[len(at) // 2]
        block = model.backbone.layers[layer]
        if fault == "the MLP's norm in bf16":
            ctx = norm_in_bf16(block.norm2)
        elif fault == "the mixer's norm in bf16":
            ctx = norm_in_bf16(block.norm1)
        else:
            owner, attr, fn = sites[fault]
            ctx = in_layer(model, layer, owner, attr, fn)
        out[fault] = (layer, part, ctx)
    return out


def layer_replays(torch, model, arch: str, card: str) -> dict:
    """The served bf16 model layer by layer against the bf16 reference
    (LAYER_REPLAY_FAULTS' comment): the sound prefill of the check's prompt
    with every block kept and every kernel op call, each part of every
    block replayed on the CPU on the card's input to it; then each control
    planted in its layer, that layer read the same way. Every sound layer
    at most half of each limit; each control at least LAYER_REPLAY_FACTOR
    times the limit of its part on its layer."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.readings import keep_blocks, replay_blocks

    t0 = time.perf_counter()
    cfg, n = model.cfg, REF_LEN[arch]
    mixers = [m for m, _ in cfg.layer_blocks()]
    prompt = launch_serve.random_prompt(model, 1, n, seed=2)
    limits = [part_limits(model.backbone.layers[i], m) for i, m in enumerate(mixers)]

    def read(layers=None, planted=None) -> dict:
        with planted or contextlib.nullcontext(), torch.no_grad(), \
                first_op_calls(every=True) as calls, keep_blocks(model, layers) as kept:
            model.prefill(prompt, max_len=n)
        parts = replay_blocks(model, kept)
        for key, lst in calls.items():
            at = [i for i, m in enumerate(mixers) if op_key(m).removesuffix(SHARE) == key]
            for i, call in zip(at, lst):
                if i in parts:
                    a, b = replay_call(torch, call)
                    parts[i]["op"] = (float((a != b).float().mean())
                                      if op_key(mixers[i]).endswith(SHARE) else rel_err(a, b))
        return parts

    sound = read()
    worst = {part: max(range(len(mixers)), key=lambda i: sound[i].get(part, 0.0)
                       / limits[i].get(part, 1.0)) for part in ("op", "mixer", "mlp")
             if part in sound[0]}
    controls = {}
    for fault, (layer, part, ctx) in layer_faults(torch, model, arch).items():
        controls[fault] = (layer, part, read([layer], ctx)[layer])
    print(f"  layer by layer, card bf16 vs the CPU bf16 reference ({len(mixers)} layers, B=1, "
          f"S={n}; each part replayed on the card's input to it; "
          f"{time.perf_counter() - t0:.1f} s): " + "; ".join(
              f"largest {part} {sound[i][part]:.3e} at layer {i} (limit {limits[i][part]:.3e})"
              for part, i in worst.items())
          + "".join(f"; control, {f} (layer {layer}): {part} {r[part]:.3e} "
                    f"({r[part] / limits[layer][part]:.3g} x its limit)"
                    for f, (layer, part, r) in controls.items()) + f" [{card}]", flush=True)
    for i, r in sound.items():
        for part, v in r.items():
            check(v <= limits[i][part] / 2, f"{arch}: layer {i}'s {part} reads {v:.3e} against "
                  f"the CPU bf16 reference, over half its limit {limits[i][part]:.3e}")
    for f, (layer, part, r) in controls.items():
        check(r[part] >= LAYER_REPLAY_FACTOR * limits[layer][part],
              f"{arch}: the layer replay reads {f} at {r[part]:.3e} on layer {layer}'s {part}, "
              f"under {LAYER_REPLAY_FACTOR:g} x its limit {limits[layer][part]:.3e}")
    return {"limits": limits, "sound": sound, "worst": worst,
            "planted": {f: {"layer": layer, "part": part, "readings": r}
                        for f, (layer, part, r) in controls.items()},
            "seconds": time.perf_counter() - t0}


def first_layer_dtype(x, want) -> None:
    """The assertion on the first layer's input in a prefill: ``want`` (the
    model's act dtype), or a RuntimeError naming the dtype (a refusal)."""
    if x.dtype != want:
        raise RuntimeError(f"the first layer's input dtype is {x.dtype}, not the act dtype "
                           f"{want}")


def causal_mask_dropped(torch) -> dict:
    """The plain path in place of the flash kernel with the causal mask
    dropped: each position attends to every key (q head h to kv head
    h // (Hq / Hk), as the kernel groups them)."""
    from repro_torch.models import transformer

    def mask_dropped(q, k, v):
        g = q.shape[2] // k.shape[2]
        k, v = (t.repeat_interleave(g, dim=2).float() for t in (k, v))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * q.shape[-1] ** -0.5
        return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v).to(q.dtype)

    return {"causal mask dropped": (transformer, "flash_attention", mask_dropped)}


def qwen_faults(torch) -> dict:
    """qwen's controls: the two plain roundings of P that are not the bf16
    kernel's (each key tile's unnormalised p rounded), and a dropped causal
    mask."""
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.models import transformer

    def p_f32(q, k, v):
        return attention_ref(q, k, v)

    def p_normalised(q, k, v):
        return attention_ref(q, k, v, p_dtype=torch.bfloat16)

    return {"P kept in f32": (transformer, "flash_attention", p_f32),
            "P normalised before rounding": (transformer, "flash_attention", p_normalised),
            **causal_mask_dropped(torch)}


def mamba_faults(torch) -> dict:
    from repro_torch.kernels.ops import ssd_scan_plain
    from repro_torch.models import ssm

    def state_not_carried(x, dt, A, B, C, *, chunk):
        """Each chunk scanned from a zero state: y_off dropped (each chunk
        with the roundings of x's dtype's kernel, as the sound path)."""
        s = x.shape[1]
        step = min(chunk, s)
        rnd = torch.bfloat16 if x.dtype == torch.bfloat16 else None
        parts = [ssd_scan_plain(x[:, i:i + step], dt[:, i:i + step], A, B[:, i:i + step],
                                C[:, i:i + step], chunk=step, round_to=rnd)
                 for i in range(0, s, step)]
        return torch.cat([y for y, _ in parts], dim=1), parts[-1][1]

    def model_path_rounding(x, dt, A, B, C, *, chunk):
        """ssd_chunked in x's dtype, as the JAX model path runs it: dt and
        x * dt rounded to bf16, and the states read the rounded x * dt."""
        return ssm.ssd_chunked(x, dt, A, B, C, chunk=chunk)

    return {"state not carried across chunks": (ssm, "ssd_scan", state_not_carried),
            "xdt and C B^T L rounded to bf16": (ssm, "ssd_scan", model_path_rounding)}


def rglru_faults(torch) -> dict:
    from repro_torch.kernels.ops import rglru_recurrence
    from repro_torch.kernels.rglru_scan import CHUNK
    from repro_torch.models import rglru

    def restarted(a, b):
        """The recurrence from a zero state at every 256th step: the TPU
        kernel's carry across sequence blocks dropped."""
        return torch.cat([rglru_recurrence(a[:, i:i + 256], b[:, i:i + 256])
                          for i in range(0, a.shape[1], 256)], dim=1)

    def carry_bf16(a, b):
        """The kernel's association (``rglru_chunked_ref``) with the carry
        into each CHUNK-step chunk rounded to bf16."""
        af, bf = a.float(), b.float()
        carry = af.new_zeros((a.shape[0], a.shape[2]))
        hs = []
        for c0 in range(0, a.shape[1], CHUNK):
            h, prod, h_end = carry, torch.ones_like(carry), torch.zeros_like(carry)
            for t in range(c0, min(c0 + CHUNK, a.shape[1])):
                h = af[:, t] * h + bf[:, t]
                hs.append(h)
                prod = prod * af[:, t]
                h_end = af[:, t] * h_end + bf[:, t]
            carry = (prod * carry + h_end).bfloat16().float()
        return torch.stack(hs, dim=1)

    return {"recurrence restarted every 256 steps": (rglru, "rglru_recurrence", restarted),
            "the 256-step carry rounded to bf16": (rglru, "rglru_recurrence", carry_bf16)}


def moe_bf16_faults(torch) -> dict:
    """The router's logits rounded to bf16 (a bf16 router product) where the
    path routes in f32."""
    from repro_torch.models import moe
    route = moe.route

    def bf16_logits(logits, k):
        return route(logits.bfloat16().float(), k)

    return {"router logits in bf16": (moe, "route", bf16_logits)}


def first_layers(torch, model, n: int):
    """A Model of the card model's first ``n`` layers with its embedding,
    final norm and unembedding: the same parameters, nothing copied."""
    from repro_torch.models.model import Model
    view = Model(dataclasses.replace(model.cfg, num_layers=n), device="meta")
    view.embed, view.backbone.final_norm = model.embed, model.backbone.final_norm
    view.backbone.layers = torch.nn.ModuleList(list(model.backbone.layers[:n]))
    return view.eval()


def f32_block(torch, block, cfg):
    """An f32 copy of one Block on the CPU."""
    from repro_torch.models.transformer import Block
    cfg32 = dataclasses.replace(cfg, act_dtype="float32", param_dtype="float32")
    mixer, mlp = cfg.layer_blocks()[0]
    copy = Block(cfg32, mixer, mlp, device="meta").to_empty(device="cpu")
    copy.load_state_dict(block.state_dict())
    return copy.eval()


def rel_err(got, ref) -> float:
    return float((got.float().cpu() - ref).abs().max()) / float(ref.abs().max())


def moe_routing(torch, moe_layer, x, factor: float):
    """The layer's output on x at capacity factor ``factor``, with its routing:
    (y, aux, top-k sets [T, k] sorted, kept sets [T, k]: the expert where the
    slot is kept, -1 where dropped, sorted, the router's probabilities [T, E]
    as the layer's forward passed them to ``moe.route``)."""
    from repro_torch.models import moe
    cfg = dataclasses.replace(moe_layer.cfg, moe_capacity_factor=factor)
    kept_cfg, moe_layer.cfg = moe_layer.cfg, cfg
    route, routed = moe.route, []

    def kept_route(logits, k):
        out = route(logits, k)
        routed.append(out)
        return out

    moe.route = kept_route
    try:
        with torch.no_grad():
            y, aux = moe_layer(x)
    finally:
        moe_layer.cfg, moe.route = kept_cfg, route
    probs, _, idx = (torch.cat(t) for t in zip(*routed))
    _, keep = moe.slots(idx.reshape(-1), cfg.num_experts, moe.capacity(cfg, idx.shape[0]))
    kept = torch.where(keep.reshape(idx.shape), idx, -1)
    return (y, {k: float(v) for k, v in aux.items()}, idx.sort(-1).values.cpu(),
            kept.sort(-1).values.cpu(), probs.cpu())


def moe_readings(torch, card_run, cpu_run) -> dict:
    """MOE_TOL's readings of a card run against a CPU run (``moe_routing``)."""
    y, aux, sets, kept, probs = card_run
    y_ref, aux_ref, sets_ref, kept_ref, probs_ref = cpu_run
    alike = (sets == sets_ref).all(-1) & (kept == kept_ref).all(-1)
    d = y.shape[-1]
    yc, yr = y.reshape(-1, d).float().cpu()[alike], y_ref.reshape(-1, d)[alike]
    return {"topk_set_differs": 1.0 - float((sets == sets_ref).all(-1).float().mean()),
            "drop_frac_diff": abs(aux["moe_drop_frac"] - aux_ref["moe_drop_frac"]),
            "layer_out": rel_err(yc, yr) if bool(alike.any()) else math.inf,
            "router_probs": rel_err(probs, probs_ref),
            "alike_share": float(alike.float().mean()),
            "drop_frac_card": aux["moe_drop_frac"], "drop_frac_cpu": aux_ref["moe_drop_frac"]}


def over_moe(r: dict, tol: dict) -> list:
    return [k for k, lim in tol.items() if r[k] > lim]


def cpu_moe_copy(torch, layer):
    """A copy of the MoE layer ``layer`` on the CPU, its parameters in their
    dtypes (the card's bf16 experts, the f32 router)."""
    from repro_torch.models.moe import MoE
    copy = MoE(layer.cfg, device="meta").to_empty(device="cpu")
    copy.load_state_dict(layer.state_dict())
    return copy.eval()


def moe_check(torch, model, cpu_moe, prompt, planted: dict, tol16: dict) -> dict:
    """The routing check of MOE_TOL on the first MoE layer (see above) against
    its f32 copy ``cpu_moe``, and the same readings against its bf16 copy on
    the CPU under ``tol16`` (the arch's MOE_BF16_TOL); each fault of
    ``planted`` must read above a MOE_TOL limit but those of
    ``moe_bf16_faults``, and every one above a ``tol16`` limit."""
    layer = next(m for m in model.modules() if type(m).__name__ == "MoE")
    seen = []
    hook = layer.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    try:
        model.prefill(prompt[:1], max_len=prompt.shape[1])
    finally:
        hook.remove()
    x = seen[0]                                 # [1, S, d] bf16, that layer's input
    factor = layer.cfg.moe_capacity_factor
    cpu_runs = {"f32": moe_routing(torch, cpu_moe, x.float().cpu(), factor),
                "bf16": moe_routing(torch, cpu_moe_copy(torch, layer), x.cpu(), factor)}
    tols = {"f32": MOE_TOL, "bf16": tol16}
    card_run = moe_routing(torch, layer, x, factor)
    r = {ref: moe_readings(torch, card_run, run) for ref, run in cpu_runs.items()}
    for ref, tol in tols.items():
        print(f"  MoE layer 0 card bf16 vs CPU {ref}, T={x.shape[1]}, capacity factor "
              f"{factor:g}: " + ", ".join(f"{k} {v:.3e}" for k, v in r[ref].items())
              + f" (tolerance {tol})", flush=True)
        check(not over_moe(r[ref], tol),
              f"the MoE layer disagrees with the CPU {ref} copy: {over_moe(r[ref], tol)}")
    check(not planted or r["f32"]["drop_frac_cpu"] > 0,
          f"no slot dropped at capacity factor {factor:g}: the capacity control cannot show")
    out = {"tokens": x.shape[1], "capacity_factor": factor, "readings": r["f32"],
           "readings_vs_bf16": r["bf16"], "planted": {}, "planted_vs_bf16": {}}
    for fault, (module, attr, fn) in planted.items():
        with planted_fault(module, attr, fn):
            card_f = moe_routing(torch, layer, x, factor)
        rf = {ref: moe_readings(torch, card_f, run) for ref, run in cpu_runs.items()}
        out["planted"][fault], out["planted_vs_bf16"][fault] = rf["f32"], rf["bf16"]
        print(f"  control, {fault}: vs CPU f32 " + ", ".join(
            f"{k} {v:.3e}" for k, v in rf["f32"].items())
            + f"; over the limits: {over_moe(rf['f32'], MOE_TOL)}; over the bf16 limits: "
            f"{over_moe(rf['bf16'], tol16)} (vs CPU bf16 " + ", ".join(
                f"{k} {rf['bf16'][k]:.3e}" for k in tol16) + ")", flush=True)
        if fault not in moe_bf16_faults(torch):
            check(bool(over_moe(rf["f32"], MOE_TOL)),
                  f"the MoE routing check does not catch: {fault}")
        check(bool(over_moe(rf["bf16"], tol16)),
              f"the MoE routing check against the bf16 copy does not catch: {fault}")
    return out


def embed_faults(torch) -> dict:
    from repro_torch.models import layers

    def not_cast(self, inputs):
        return self.tok[inputs].to(self.tok.dtype) if self.tok is not None else inputs

    def tied_layout(self):
        """The [d, V] unembedding read as a tied table [V, d] transposed."""
        return self.unembed.reshape(self.unembed.shape[::-1]).T

    return {"embeds not cast to act_dtype": (layers.Embed, "forward", not_cast),
            "unembed read in the tied table's layout": (layers.Embed, "weight", tied_layout)}


def new_arch_faults(torch) -> dict:
    """Phase 15's planted faults per arch, each of which must fail the
    card-vs-CPU check (deepseek's on its one layer's hidden states at every
    position)."""
    mask = causal_mask_dropped(torch)
    return {INTERNLM: mask, INTERNVL: {**mask, **embed_faults(torch)}, MUSICGEN: mask,
            GRANITE: mask, PHI: mask, DEEPSEEK: mask, NEMOTRON: mask}


def moe_faults(torch) -> dict:
    from repro_torch.models import moe

    def not_renormalised(logits, k):
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, k, dim=-1)
        return probs, gates, idx

    def over_capacity_kept(cfg, tokens):
        return tokens * cfg.num_experts_per_tok     # room for every slot

    return {"gates not renormalised over the top-k": (moe, "route", not_renormalised),
            "tokens over capacity kept": (moe, "capacity", over_capacity_kept)}


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
    from repro_torch.kernels.cost import PEAK_FLOPS_BF16
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
    check_widths(cfg, arch)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    per_step = {k: v / steps for k, v in launches.items()}
    expected = expected_train_launches(cfg)
    params, active = sum(p.numel() for p in model.parameters()), model.active_param_count()
    tokens = batch * seq
    for r in hist:
        r["model_flops_share"] = 6.0 * active * tokens / (r["ms"] / 1e3) / PEAK_FLOPS_BF16
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
           "active_params": active, "history": hist, "loss_after_on_step1_batch": after,
           "step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
           "model_flops_share": 6.0 * active * tokens / (step_ms / 1e3) / PEAK_FLOPS_BF16,
           "launches_per_step": per_step, "restarts": res.restarts, "peak_memory_gb": peak_gb}
    # the last step's own peak, which phase 18's dry run predicts: its
    # arguments (parameters, moments, one batch) and the most it allocated
    # above the bytes allocated at its start
    args_bytes = sum(t.numel() * t.element_size() for t in (
        *model.parameters(), *res.opt_state.m.values(), *res.opt_state.v.values(),
        *data.batch_at(0).values()))
    grow = hist[-1]["peak_over_start_bytes"]
    out["step_memory"] = {"args_bytes": args_bytes, "peak_over_start_bytes": grow,
                          "peak_bytes": args_bytes + grow,
                          "flash_launches": per_step["flash_attention"]}
    if arch == QWEN:
        out["checkpoint"] = check_checkpoint(torch, model, res.opt_state)
    del res
    torch.cuda.empty_cache()

    # The same weights' loss and grads in f32 on the CPU (plain path).
    names, ref_len = TRAIN_READ[arch], REF_LEN.get(arch, NEW_REF_LEN)
    gen = torch.Generator(device=dev).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, ref_len + 1), generator=gen, device=dev)
    small = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if not cfg.embed_inputs:    # f32 embeddings, which each side casts to its act dtype
        small = {"embeds": torch.randn((1, ref_len, cfg.d_model), generator=gen, device=dev),
                 "labels": toks[:, 1:]}
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


def ulps_apart(torch, a, b):
    """How many f32 ulps each element of ``a`` is from ``b`` (same shape)."""
    ia, ib = _bits(torch, a.float().contiguous()), _bits(torch, b.float().contiguous())
    return (ia.long() - ib.long()).abs()


def ef_average_error(torch, g, scale, rounds: int, carried: bool = True) -> tuple:
    """(max over the quantization chunks of max |mean of ``rounds``
    error-feedback dequantizations - g| over the chunk's ``scale`` (g's
    scales), the same unscaled); with ``carried`` False the residual is
    reset to 0 each round (a planted fault)."""
    from repro_torch.parallel import compress_with_feedback, dequantize_int8
    from repro_torch.parallel.compression import CHUNK
    err, total = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(rounds):
        q, s, new_err = compress_with_feedback(g, err)
        err = new_err if carried else torch.zeros_like(g)
        total += dequantize_int8(q, s, g.shape, torch.float32)
        del q, s, new_err
    d = (total / rounds - g).abs()
    d = torch.nn.functional.pad(d, (0, (-d.numel()) % CHUNK)).reshape(-1, CHUNK).amax(dim=1)
    return float((d / scale).max()), float(d.max())


def phase_parallel(torch, card: str) -> dict:
    """Phase 17, the parallel layer on the card: (a) qwen's train step through
    ``make_train_step`` on a one-rank NCCL mesh against the plain
    ``train_step``; (b) int8 error-feedback compression of qwen's whole
    gradient, card against CPU, and its long-run average; (c) the
    hierarchical reduce on a one-rank (pod, data, model) mesh against
    compress-then-dequantize; (d) granite's grouped MoE under a one-rank mesh
    against the no-mesh grouped path."""
    from repro_torch.config import get_model_config
    from repro_torch.config.base import ParallelConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models.moe import MoE
    from repro_torch.parallel import (
        dequantize_int8, hierarchical_grad_reduce, quantize_int8, use_mesh,
    )
    from repro_torch.parallel.compression import CHUNK as CHUNK_INT8
    from repro_torch.train import SyntheticDataset, init_adam, train_step
    from repro_torch.train.train_step import make_train_step, value_and_grad

    dev = torch.device("cuda", 0)
    out = {}
    # (a) the mesh step against the plain step, 3 steps each from the same seed
    steps = 3
    runs = {}
    for how in ("mesh", "plain"):
        model, train_cfg, par = launch_train.setup(QWEN, device=dev, steps=steps)
        data = SyntheticDataset(model.cfg, train_cfg, device=dev)
        opt = init_adam(dict(model.named_parameters()), par.opt_state_dtype)
        if how == "mesh":
            mesh = make_mesh_for(par, dev)
            _, _, jit_step, rules = make_train_step(model, par, train_cfg, mesh)
            sstep = jit_step(dict(model.named_parameters()))
            params, opt = sstep.place(dict(model.named_parameters()), opt)
            kinds = {"params": sorted({type(p).__name__ for p in params.values()}),
                     "moments": sorted({type(t).__name__ for t in opt.m.values()})}
            own = all(params[k] is p for k, p in model.named_parameters())
        hist = []
        for i in range(steps):
            batch = data.batch_at(i)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            if how == "mesh":
                params, opt, m = sstep(params, opt, batch)
            else:
                opt, m = train_step(model, opt, batch, par, train_cfg)
            row = {k: float(v) for k, v in m.items()}
            torch.cuda.synchronize()
            row.update(ms=(time.perf_counter() - t0) * 1e3, launches=read_counts())
            hist.append(row)
        runs[how] = hist
        if how == "plain":
            # (b)'s gradient: the trained model's on step 1's batch, flat, f32
            _, grads = value_and_grad(model, data.batch_at(0))
            g = torch.cat([t.float().reshape(-1) for t in grads.values()])
            del grads
        del model, opt, data
        if how == "mesh":
            del params, sstep
        torch.cuda.empty_cache()
    expected = expected_train_launches(get_model_config(QWEN))
    rel = [{k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
           for a, b in zip(runs["mesh"], runs["plain"])]
    for i, (a, b, r) in enumerate(zip(runs["mesh"], runs["plain"], rel), start=1):
        print(f"  (a) qwen step {i} (8 x 2048, bf16): mesh loss {a['loss']:.6f} grad norm "
              f"{a['grad_norm']:.6f} {a['ms']:.2f} ms; plain {b['loss']:.6f} "
              f"{b['grad_norm']:.6f} {b['ms']:.2f} ms; relative {r['loss']:.3e} / "
              f"{r['grad_norm']:.3e}; flash launches {a['launches']['flash_attention']} / "
              f"{b['launches']['flash_attention']} [{card}]", flush=True)
    print(f"  (a) on the mesh: parameters {kinds['params']} (the model's own: {own}), "
          f"moments {kinds['moments']}", flush=True)
    check(own and kinds == {"params": ["Parameter"], "moments": ["DTensor"]},
          f"the mesh step's parameters and moments are {kinds} (the model's own: {own})")
    check(all(v <= 1e-6 for r in rel for v in r.values()),
          f"the mesh step parts from the plain step: {rel}")
    check(all(r["launches"] == expected for r in runs["mesh"] + runs["plain"]),
          f"kernel launches per step {[r['launches'] for r in runs['mesh']]}, expected "
          f"{expected} (phase 7's count)")
    out["train_step"] = {"mesh": runs["mesh"], "plain": runs["plain"], "relative": rel,
                         "placements": kinds}

    # (b) int8 error feedback on the whole gradient as it is
    t0 = time.perf_counter()
    n = g.numel()
    q, scale = quantize_int8(g)
    g_cpu = g.cpu()
    q_cpu, scale_cpu = quantize_int8(g_cpu)
    differ = q.cpu() != q_cpu
    n_diff = int(differ.sum())
    flat = torch.nn.functional.pad(g_cpu, (0, (-n) % CHUNK_INT8))
    ratio = (flat.reshape(q_cpu.shape) / scale_cpu[:, None])[differ].abs()
    # at a tie: within 4 f32 ulps (relative) of a .5, where a scale an ulp
    # apart may round the other way
    ties = int(((ratio - ratio.floor() - 0.5).abs() <= ratio * 2.0 ** -21).sum())
    scale_ulps = int(ulps_apart(torch, scale.cpu(), scale_cpu).max())
    del q, flat, ratio, differ, q_cpu
    ef, ef_abs = ef_average_error(torch, g, scale, EF_ROUNDS)
    no_residual, _ = ef_average_error(torch, g, scale, EF_ROUNDS, carried=False)
    print(f"  (b) int8 payloads of qwen's gradient ({g.numel()} values, {scale.numel()} "
          f"chunks): card vs CPU {n_diff} differ, {ties} of them at a rounding tie; scales "
          f"at most {scale_ulps} ulp apart; error-feedback average over {EF_ROUNDS} rounds "
          f"within {ef:.4e} of its chunk's scale from the gradient (limit {EF_SCALED_TOL:g}; "
          f"{ef_abs:.3e} absolute); control, residual not carried: {no_residual:.4e} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    check(n_diff == ties, f"{n_diff - ties} int8 payload values differ off a rounding tie")
    check(scale_ulps <= 1, f"scales {scale_ulps} ulps apart")
    check(ef <= EF_SCALED_TOL, f"the error-feedback average is {ef:.3e} scales from the "
                               f"gradient")
    check(no_residual > EF_SCALED_TOL,
          "the long-run check does not catch: residual not carried")
    out["compression"] = {"values": g.numel(), "chunks": scale.numel(),
                          "payloads_differ": n_diff, "at_ties": ties,
                          "scale_ulps": scale_ulps, "ef_average_scaled_error": ef,
                          "ef_average_abs_error": ef_abs, "limit": EF_SCALED_TOL,
                          "planted": {"residual not carried": no_residual}}
    del g_cpu, scale, scale_cpu

    # (c) the hierarchical reduce on a one-rank (pod, data, model) mesh
    mesh3 = make_mesh_for(ParallelConfig(multi_pod=True, pods=1, data=1, model=1), dev)
    err = torch.zeros_like(g)
    same = []
    for _ in range(2):   # the second round with the first's residual
        got, new_err = hierarchical_grad_reduce(g, mesh3, compress=True, err=err)
        corrected = g + err
        qq, ss = quantize_int8(corrected)
        want = dequantize_int8(qq, ss, g.shape, g.dtype)
        same.append(bool(torch.equal(got, want))
                    and bool(torch.equal(new_err, corrected - want)))
        err = new_err
        del got, corrected, qq, ss, want
    print(f"  (c) hierarchical_grad_reduce(compress=True) on a one-rank (pod, data, model) "
          f"mesh, two rounds: equal to compress-then-dequantize bit for bit {same}",
          flush=True)
    check(all(same), "the hierarchical reduce differs from compress-then-dequantize")
    out["hierarchical_reduce"] = {"rounds_bit_equal": same}
    del g, err, new_err
    torch.cuda.empty_cache()

    # (d) granite's grouped dispatch under a one-rank (pod, data) mesh
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_model_config(GRANITE), moe_group_by_batch=True)
    layer = MoE(cfg, device=dev)
    layer.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    mesh_pd = make_mesh_for(ParallelConfig(multi_pod=True, pods=1, data=1, model=1), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((4, 2048, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    cases = {}
    for name, xin, factor in (("B=1, the config's capacity factor", x[:1],
                               cfg.moe_capacity_factor),
                              ("B=4, capacity for every slot", x, cfg.num_experts)):
        layer.cfg = dataclasses.replace(cfg, moe_capacity_factor=float(factor))
        with torch.no_grad():
            y0, aux0 = layer(xin)
            with use_mesh(mesh_pd):
                y1, aux1 = layer(xin)
        torch.cuda.synchronize()
        d = float((y1 - y0).abs().max()) / float(y0.abs().max())
        cases[name] = {"y_diff": d, "bit_equal": bool(torch.equal(y0, y1)),
                       "aux_no_mesh": {k: float(v) for k, v in aux0.items()},
                       "aux_mesh": {k: float(v) for k, v in aux1.items()}}
        print(f"  (d) granite MoE layer, {name}: mesh vs no mesh {d:.3e} (bit-equal "
              f"{cases[name]['bit_equal']}); drop fraction {float(aux1['moe_drop_frac']):.4f}"
              f" / {float(aux0['moe_drop_frac']):.4f}; z-loss {float(aux1['moe_z_loss']):.6f}"
              f" / {float(aux0['moe_z_loss']):.6f}; lb-loss {float(aux1['moe_lb_loss']):.6f}"
              f" / {float(aux0['moe_lb_loss']):.6f} (one rank's flat tokens / the mean of "
              f"per-row values)", flush=True)
    one, four = cases.values()
    check(one["bit_equal"] and one["aux_mesh"] == one["aux_no_mesh"],
          "the grouped MoE under a one-rank mesh differs from the no-mesh path at B=1")
    check(four["y_diff"] <= MOE_TOL["layer_out"] and four["aux_mesh"]["moe_drop_frac"] == 0.0
          and four["aux_no_mesh"]["moe_drop_frac"] == 0.0,
          "the grouped MoE under a one-rank mesh differs from the no-mesh path at B=4")
    d_s = time.perf_counter() - t0
    check(d_s < 90.0, f"(d) took {d_s:.1f} s")
    out["grouped_moe"] = dict(cases, seconds=d_s)
    del layer, x
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 17(e): the two-rank model split on the one card
# ---------------------------------------------------------------------------

# Phase 17(e), layer by layer: each layer that qwen's, mamba2's and
# recurrentgemma's blocks and embedding hold (tests/torch_mesh_harness.py
# ``tp_layer_cases(arch, smoke=False)``: the MLP, the vocab-parallel
# embedding and CE, attention in the case the arch takes, the SSD with its
# gated norm, the RG-LRU), at its published widths in f32 (TF32 off), split
# over the two ranks against the same layer whole on the same card, weights,
# input [TP_LAYER_SHAPE, d] and output gradient (``readings.split_vs_whole``):
# the output, the input's gradient and each parameter's gradient (this rank's
# shard against the same slice of the whole gradient), each max abs err /
# max |whole|, the largest over the ranks. The split sums the same f32
# products in another order and nothing else, so each limit is the f32
# reordering of that layer's sums: 4 x the largest of the three readings of
# the same layer at its smoke config on the CPU (TP_LAYER_CPU; a CPU run
# before the first judged card run, seeds 1 and 5, 2 ranks of gloo, shape
# 2 x 48), scaled by the ratio of the contraction that the split reorders
# (TP_LAYER_K: d_ff, the vocab, q heads x head dim, the SSD's inner width,
# the RG-LRU width) at the published width to the smoke one: a sum's
# rounding error grows at most linearly with its terms. (At the published
# widths on the CPU, seeds 1 and 5, 2 x 256, the layers read 1.4e-7 to
# 4.9e-6, at most 4 times their smoke readings; at smoke, seeds 2 and 3 read
# mamba2's SSD at 4.7e-6, 3.8 times seeds 1 and 5: the parameter gradients
# of A_log and dt_bias sum over every position.) The judged card run
# draws the weights and inputs from TP_LAYER_SEEDS, which no limit was set
# from. Every sound reading must be at most half its limit; each planted
# fault (torch_mesh_harness.TP_PLANTED_KIND: the attention's wo all-reduce
# dropped, the MLP's row-parallel all-reduce dropped, the vocab-parallel
# CE's sums (of the exponentials and the label's logit) not reduced over
# "model", the gated-norm sum not reduced, the SSD out_proj all-reduce
# dropped, the RG-LRU gates reading the local width only) must read at
# least TP_FAULT_FACTOR times the limit of the layer it breaks (the largest
# of its three readings there).
TP_LAYER_SEEDS = (2, 3)
TP_LAYER_SHAPE = (2, 512)
TP_LAYER_CPU = {QWEN: {"mlp": 5.50e-7, "embed": 6.58e-7, "attn": 2.43e-7},
                MAMBA: {"embed": 6.58e-7, "ssd": 1.24e-6},
                RG: {"mlp": 3.39e-7, "embed": 8.55e-7, "local attn": 2.99e-7,
                     "rglru": 4.15e-7}}


def tp_layer_k(cfg, kind: str) -> int:
    """The contraction of ``kind``'s layer that the split over "model" sums
    in parts (TP_LAYER_CPU's comment)."""
    hd = cfg.head_dim or cfg.d_model // max(cfg.num_heads, 1)
    return {"mlp": cfg.d_ff, "embed": cfg.vocab_size, "attn": cfg.num_heads * hd,
            "local attn": cfg.num_heads * hd, "ssd": cfg.ssm_expand * cfg.d_model,
            "rglru": cfg.rglru_width or cfg.d_model}[kind]


def tp_layer_tol() -> dict:
    """TP_LAYER_CARD_TOL: arch -> layer kind -> its limit."""
    from repro_torch.config import get_model_config
    out = {}
    for arch, cpu in TP_LAYER_CPU.items():
        full, smoke = get_model_config(arch), get_model_config(arch, smoke=True)
        out[arch] = {kind: 4.0 * r * tp_layer_k(full, kind) / tp_layer_k(smoke, kind)
                     for kind, r in cpu.items()}
    return out


TP_FAULT_FACTOR = 10.0
# The whole step, split over the two ranks, against the one-rank step on the
# same weights and batch (bf16, the arch's training workload): the loss and
# the grad norm, relative, at each of two steps (the second on the split's
# own weights after its first update, gathered whole for the one-rank
# reading) and for each of TP_STEP_SEEDS (the weights' and the batches'
# seed; the earlier one-step readings, PERF.md §6, were at seed 0). Set from the per-layer
# limits and the depth, before its first judged run: the per-layer check
# holds each split layer to its whole self up to the order of its sums, and
# in bf16 that order moves each row-parallel output by at most one more
# rounding, 2^-9 of it; L layers' roundings, independent, add in quadrature
# to sqrt(L) x 2^-9 of the hidden state, and the loss (a mean) and the grad
# norm (a norm) move by no more than their elements do: qwen 9.6e-3 (24
# layers), mamba2 1.35e-2 (48), recurrentgemma 9.96e-3 (26). (The seed-0
# readings, up to 4.7e-4, are 20 times under.) Faults of a rounding's size
# (the gated-norm sum, the RG-LRU gates' width, the CE's max) are the
# per-layer check's to catch; this one must be failed by a dropped
# row-parallel all-reduce on each arch (TP_STEP_FAULTS).
TP_STEP_SEEDS = (1, 2)
TP_DEPTH = {QWEN: 24, MAMBA: 48, RG: 26}
TP_TOL = {arch: {k: math.sqrt(depth) * 2.0 ** -9 for k in ("loss", "grad_norm")}
          for arch, depth in TP_DEPTH.items()}
TP_STEP_FAULTS = {QWEN: "wo all-reduce dropped", MAMBA: "SSD out_proj all-reduce dropped",
                  RG: "MLP row-parallel all-reduce dropped"}
TP_TIMEOUT_S = 600.0


def harness():
    """tests/torch_mesh_harness.py: the table of split layer cases and the
    planted faults, which the CPU tests share."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import torch_mesh_harness
    return torch_mesh_harness


def tp_stage_refused(torch, dist) -> dict:
    """Tries each collective that the split step calls on a CUDA tensor over
    gloo; each one gloo refuses is staged through host memory from here on,
    in this process only (copied to the CPU, run there, copied back).
    Returns {collective: gloo's error} of the staged ones."""
    x = torch.ones(4, device="cuda")
    trials = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce max": lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * dist.get_world_size(), device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // dist.get_world_size(), device="cuda"), x),
    }
    refused = {}
    for name, fn in trials.items():
        try:
            fn()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - the refusal is the reading
            refused[name] = f"{type(e).__name__}: {e}"[:300]
    for name in {n.split()[0] for n in refused}:
        orig = getattr(dist, name)

        def staged(*args, _orig=orig, **kwargs):
            host = [a.cpu() if torch.is_tensor(a) else a for a in args]
            work = _orig(*host, **kwargs)
            for a, h in zip(args, host):
                if torch.is_tensor(a):
                    a.copy_(h)
            return work
        setattr(dist, name, staged)
    return refused


def tp_layers(torch, mesh, arch: str) -> dict:
    """One rank's per-layer readings of ``arch`` (phase 17(e)): each layer
    case of ``harness().tp_layer_cases(arch, smoke=False)`` split against
    whole on the card for each of TP_LAYER_SEEDS, then each fault of
    TP_PLANTED_KIND on its layer (the first seed): {"sound": {kind: {seed:
    readings}}, "planted": {fault: (kind, readings)}, "s"}."""
    from repro_torch.config.base import ParallelConfig
    from repro_torch.readings import split_vs_whole

    h = harness()
    t0 = time.perf_counter()
    par = ParallelConfig(multi_pod=True, pods=1, data=1, model=2)
    cases = h.tp_layer_cases(arch, smoke=False)

    def read(kind, seed, fault=None):
        print(f"{arch} {kind} seed {seed} {fault or ''}", flush=True)
        r = split_vs_whole(*cases[kind], mesh, par, device="cuda", shape=TP_LAYER_SHAPE,
                           seed=seed, fault=fault and (lambda: h.plant(fault)))
        torch.cuda.empty_cache()
        return r

    out = {"sound": {kind: {seed: read(kind, seed) for seed in TP_LAYER_SEEDS}
                     for kind in cases},
           "planted": {f: (kind, read(kind, TP_LAYER_SEEDS[0], f))
                       for f, kind in h.TP_PLANTED_KIND.items() if kind in cases}}
    out["s"] = time.perf_counter() - t0
    return out


def tp_steps(torch, dist, mesh, arch: str, rank: int, seed: int, fault=None) -> dict:
    """One rank's readings of ``arch``'s step split over two ranks against
    the one-rank step (phase 17(e)), with the weights and batches of
    ``seed``: two steps of the split step, each beside the one-rank loss and
    grad norm on the same weights and batch (rank 0; the second on the
    split's weights after its first update, put back whole); with ``fault``,
    first step 1 with it planted from the same weights."""
    from repro_torch.config.base import ParallelConfig, TrainConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.parallel.tensor import _gather_dim, shard_model, unshard_model
    from repro_torch.train import SyntheticDataset
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import accumulated_grads, make_train_step

    dev = torch.device("cuda", 0)
    b, s, _ = launch_train.TRAIN_WORKLOADS[arch]
    par = ParallelConfig(multi_pod=True, pods=1, data=1, model=2)
    model = launch_train.build(arch, device=dev, par=par, seed=seed)
    train_cfg = TrainConfig(global_batch=b, seq_len=s, total_steps=3, warmup_steps=1, seed=seed)
    data = SyntheticDataset(model.cfg, train_cfg, device=dev)
    batches = [data.batch_at(0), data.batch_at(1)]
    out = {"batch": b, "seq": s, "seed": seed, "one_rank": []}

    def one_rank(batch):
        """The one-rank step's loss and grad norm (before its update), on
        rank 0, on the model put whole."""
        if rank == 0:
            t0 = time.perf_counter()
            metrics, grads = accumulated_grads(model, batch, 1)
            out["one_rank"].append({"loss": float(metrics["loss"]),
                                    "grad_norm": float(global_norm(grads)),
                                    "ms": (time.perf_counter() - t0) * 1e3})
            del grads
        torch.cuda.empty_cache()
        dist.barrier()

    one_rank(batches[0])
    _, _, jit_step, rules = make_train_step(model, par, train_cfg, mesh)
    step = jit_step(dict(model.named_parameters()))
    params, opt = step.place(dict(model.named_parameters()))
    torch.cuda.empty_cache()
    out["shards"] = {"parameters": sum(p.numel() for p in params.values()),
                     "whole": sum(math.prod(sh) for sh in step.shapes.values())}
    kept = {k: p.detach().clone() for k, p in params.items()} if fault else None
    heads, fwd = [], ops.flash_attention_fwd

    def counted(q, k, v, **kw):
        heads.append(int(q.shape[2]))
        return fwd(q, k, v, **kw)

    def run(opt, batch, planted=None):
        torch.cuda.synchronize()
        args_bytes = sum(t.numel() * t.element_size() for t in (
            *params.values(), *(t.to_local() for t in opt.m.values()),
            *(t.to_local() for t in opt.v.values()), *batch.values()))
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        heads.clear()
        reset_counts()
        ops.flash_attention_fwd = counted
        t0 = time.perf_counter()
        try:
            with planted or contextlib.nullcontext():
                _, opt, m = step(params, opt, batch)
            r = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
            torch.cuda.synchronize()
        finally:
            ops.flash_attention_fwd = fwd
        r.update(ms=(time.perf_counter() - t0) * 1e3, launches=read_counts(),
                 flash_heads=sorted(set(heads)), args_bytes=args_bytes,
                 peak_over_start_bytes=torch.cuda.max_memory_allocated(dev) - start)
        r["peak_bytes"] = args_bytes + r["peak_over_start_bytes"]
        return r, opt

    if fault is not None:       # from the same weights as the sound step, then reset
        out["planted"] = {fault: run(opt, batches[0], harness().plant(fault))[0]}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(kept[k])
            for t in (*opt.m.values(), *opt.v.values()):
                t.to_local().zero_()
    del kept
    first, opt = run(opt, batches[0])
    # the split's own weights put whole (gathered over "model" by the c10d
    # all-gather that the split layers use: DTensor's functional collectives
    # crash over gloo on CUDA tensors); the moments wait in host memory
    moments = [t.to_local() for t in (*opt.m.values(), *opt.v.values())]
    host = [t.cpu() for t in moments]
    for t in moments:
        t.untyped_storage().resize_(0)
    whole = {}
    for k in (k for k in params if step.split[k]):
        whole[k] = params[k].detach()
        for m in step.split[k]:
            whole[k] = _gather_dim(whole[k], step.param_pl[k][m].dim, mesh.get_group(m))
    unshard_model(model, whole)
    del whole
    torch.cuda.empty_cache()
    one_rank(batches[1])
    shard_model(model, mesh, rules)
    params = dict(model.named_parameters())
    for t, h in zip(moments, host):
        t.untyped_storage().resize_(h.numel() * h.element_size())
        t.copy_(h)
    del host, moments
    second, _ = run(opt, batches[1])
    out["steps"] = [first, second]
    del model, params, opt, step
    torch.cuda.empty_cache()
    return out


def tp_arch(torch, dist, mesh, arch: str, rank: int) -> dict:
    """One rank's readings of ``arch`` in phase 17(e): its layers
    (``tp_layers``), then its step for each of TP_STEP_SEEDS (``tp_steps``;
    the planted fault TP_STEP_FAULTS[arch] with the first)."""
    out = {"layers": tp_layers(torch, mesh, arch)}
    out["seeds"] = [tp_steps(torch, dist, mesh, arch, rank, seed,
                             TP_STEP_FAULTS[arch] if i == 0 else None)
                    for i, seed in enumerate(TP_STEP_SEEDS)]
    out["split"] = out["seeds"][0]["steps"][0]      # phase 18 reads its peak
    out["shards"] = out["seeds"][0]["shards"]
    return out


def tp_rank_main(rank: int, port: int, out_dir: Path, job: str = "train") -> None:
    """A rank of phase 17(e) or, with ``job`` "serve", 17(f) (``chip_smoke.py
    --tp-rank RANK PORT DIR [serve]``): gloo over CUDA tensors, a (1, 1, 2)
    ("pod", "data", "model") mesh, the readings of each arch into
    ``DIR/rankRANK.json``."""
    import faulthandler
    faulthandler.enable()               # a crash in a rank prints its stack to its log
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    try:
        res = {"staged": tp_stage_refused(torch, dist)}
        mesh = init_device_mesh("cuda", (1, 1, 2), mesh_dim_names=("pod", "data", "model"))
        res["archs"] = {}
        run, archs = (tp_arch, TP_STEP_FAULTS) if job == "train" else (tp_serve_arch,
                                                                        TP_SERVE_FAULTS)
        for arch in archs:
            t0 = time.perf_counter()
            res["archs"][arch] = run(torch, dist, mesh, arch, rank)
            res["archs"][arch]["s"] = time.perf_counter() - t0
        (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_tp_ranks(out_dir: Path, job: str, what: str) -> list:
    """Runs the two ranks of ``job`` (``tp_rank_main``) as processes of this
    script on the one card, each in a session of its own, within
    TP_TIMEOUT_S; fails the run (naming ``what``) unless both end well.
    Returns each rank's readings."""
    import os
    import shutil
    import signal
    import socket

    t0 = time.perf_counter()
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for rank in range(2):
            with open(out_dir / f"rank{rank}.out", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank", str(rank),
                     str(port), str(out_dir), job], stdout=log, stderr=subprocess.STDOUT,
                    cwd=ROOT, start_new_session=True))
        for proc in procs:
            proc.wait(timeout=max(TP_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    if any(p.returncode != 0 for p in procs):
        for rank in range(2):
            print((out_dir / f"rank{rank}.out").read_text()[-3000:], file=sys.stderr)
        fail(f"{what}: the ranks exited with {[p.returncode for p in procs]}")
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2)]


def phase_tensor_parallel(torch, card: str) -> dict:
    """Phase 17(e): qwen, mamba2 and recurrentgemma at full width split over
    two ranks of "model" on the one card (two processes, gloo over CUDA
    tensors: NCCL refuses two ranks on one GPU). Layer by layer in f32: each
    split layer against itself whole (TP_LAYER_CARD_TOL; every sound reading
    at most half its limit, each planted fault at least TP_FAULT_FACTOR
    times its layer's limit). The whole step in bf16 on the phase 7-9
    workloads, two steps for each of TP_STEP_SEEDS: the loss and grad norm
    against the one-rank step's on the same weights and batch (TP_TOL,
    failed by TP_STEP_FAULTS), the flash kernel on each rank's heads, the
    kernels' launches a step on each rank, each rank's step peak (phase 18
    predicts qwen's)."""
    from repro_torch.config import get_model_config

    t0 = time.perf_counter()
    ranks = run_tp_ranks(ROOT / "build" / "chip_smoke_tp", "train", "phase 17(e)")
    staged = ranks[0]["staged"]
    print("  (e) two ranks of \"model\" on the one card, gloo over CUDA tensors; "
          + (f"gloo refused {sorted(staged)}, staged through host memory in this phase "
             f"only: {staged}" if staged else "gloo took every collective of the split step "
             "(all_reduce sum and max, all_gather_into_tensor, reduce_scatter_tensor)"),
          flush=True)
    layer_tol = tp_layer_tol()
    out = {"staged": staged, "tol": TP_TOL, "layer_tol": layer_tol, "archs": {}}
    for arch, fault in TP_STEP_FAULTS.items():
        cfg = get_model_config(arch)
        r0, r1 = ranks[0]["archs"][arch], ranks[1]["archs"][arch]
        tol, lt = TP_TOL[arch], layer_tol[arch]

        # layer by layer
        lay = r0["layers"]
        sound = {kind: max(r[k] for r in by_seed.values()
                           for k in ("out", "x_grad", "param_grad"))
                 for kind, by_seed in lay["sound"].items()}
        planted = {f: (kind, max(r[k] for k in ("out", "x_grad", "param_grad")))
                   for f, (kind, r) in lay["planted"].items()}
        top = max(sound, key=lambda k: sound[k] / lt[k])
        print(f"  (e) {arch} layer by layer (f32, TF32 off, {TP_LAYER_SHAPE[0]} x "
              f"{TP_LAYER_SHAPE[1]}, seeds {TP_LAYER_SEEDS}; {lay['s']:.1f} s): largest "
              f"{top} {sound[top]:.3e} of limit {lt[top]:.3e}; "
              + ", ".join(f"{k} {v:.3e} / {lt[k]:.3e}" for k, v in sound.items())
              + "".join(f"; control, {f}: {kind} {v:.3e} ({v / lt[kind]:.3g} x its limit)"
                        for f, (kind, v) in planted.items()) + f" [{card}]", flush=True)
        for kind, by_seed in lay["sound"].items():
            for seed, r in by_seed.items():
                check(max(r["out"], r["x_grad"], r["param_grad"]) <= lt[kind] / 2,
                      f"{arch}: the split {kind} parts from itself whole (seed {seed}): "
                      f"{r['out']:.3e} / {r['x_grad']:.3e} / {r['param_grad']:.3e}, more "
                      f"than half its limit {lt[kind]:.3e}")
        for f, (kind, v) in planted.items():
            check(v >= TP_FAULT_FACTOR * lt[kind],
                  f"{arch}: the per-layer check reads {f} at {v:.3e}, under "
                  f"{TP_FAULT_FACTOR:g} x its {kind} limit {lt[kind]:.3e}")

        # the whole step, two steps a seed
        expected = expected_train_launches(cfg)
        heads = cfg.num_heads // 2 if cfg.num_heads % 2 == 0 else cfg.num_heads
        steps_rel = []
        for s0, s1 in zip(r0["seeds"], r1["seeds"]):
            for i, (st, one) in enumerate(zip(s0["steps"], s0["one_rank"])):
                rel = {k: abs(st[k] - one[k]) / abs(one[k]) for k in ("loss", "grad_norm")}
                steps_rel.append(rel)
                for rank, r in enumerate((st, s1["steps"][i])):
                    print(f"  (e) {arch} ({s0['batch']} x {s0['seq']}, bf16) seed {s0['seed']} "
                          f"step {i + 1} rank {rank}: loss {r['loss']:.6f} grad norm "
                          f"{r['grad_norm']:.6f} {r['ms']:.1f} ms; shards "
                          f"{s0['shards']['parameters']} of {s0['shards']['whole']} parameters; "
                          f"flash heads {r['flash_heads']}; launches {r['launches']}; step peak "
                          f"{r['peak_bytes']} B (arguments {r['args_bytes']}) [{card}]",
                          flush=True)
                print(f"  (e) {arch} seed {s0['seed']} step {i + 1}: one rank loss "
                      f"{one['loss']:.6f} grad norm {one['grad_norm']:.6f} ({one['ms']:.1f} ms); "
                      f"two ranks relative {rel['loss']:.3e} / {rel['grad_norm']:.3e} (limits "
                      f"{tol['loss']:.3e} / {tol['grad_norm']:.3e}) [{card}]", flush=True)
                check(st["loss"] == s1["steps"][i]["loss"]
                      and st["grad_norm"] == s1["steps"][i]["grad_norm"],
                      f"{arch}: the two ranks' losses or grad norms differ")
                check(all(rel[k] <= tol[k] for k in tol),
                      f"{arch}: the two-rank step parts from the one-rank step: {rel}")
                for r in (st, s1["steps"][i]):
                    check(r["launches"] == expected,
                          f"{arch}: launches a step {r['launches']}, expected {expected}")
                    if expected["flash_attention"]:
                        check(r["flash_heads"] == [heads],
                              f"{arch}: flash ran on {r['flash_heads']} heads a rank, "
                              f"expected {heads}")
            for r in (s0, s1):
                check(r["shards"]["parameters"] < r["shards"]["whole"],
                      f"{arch}: a rank holds every parameter whole")
        first = r0["seeds"][0]
        step_planted = {k: abs(first["planted"][fault][k] - first["one_rank"][0][k])
                        / abs(first["one_rank"][0][k]) for k in ("loss", "grad_norm")}
        print(f"  (e) {arch} whole step: largest relative {max(r['loss'] for r in steps_rel):.3e}"
              f" / {max(r['grad_norm'] for r in steps_rel):.3e} over {len(steps_rel)} steps "
              f"(limits {tol['loss']:.3e} / {tol['grad_norm']:.3e}); control, {fault}: "
              f"{step_planted['loss']:.3e} / {step_planted['grad_norm']:.3e} ({r0['s']:.1f} s) "
              f"[{card}]", flush=True)
        check(any(step_planted[k] > tol[k] for k in tol),
              f"{arch}: the two-rank step check does not catch: {fault} ({step_planted})")
        out["archs"][arch] = {"layers": {"sound": sound, "planted": planted, "tol": lt,
                                         "readings": lay},
                              "steps": steps_rel, "ranks": [r0, r1],
                              "planted": {fault: step_planted}}
    out["seconds"] = time.perf_counter() - t0
    print(f"  (e) {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 17(f): serving split over two ranks of "model" on the one card
# ---------------------------------------------------------------------------

# (batch, prompt, decode steps) of each arch's request: recurrentgemma's
# decode (positions 1020-1027) crosses slot 1024 of its 2048-slot ring, the
# first slot of rank 1's half
TP_SERVE_SHAPE = (2, 1020, 8)
# arch -> the planted faults that must fail its check (the sequence split
# exists for recurrentgemma's ring only: qwen's kv heads divide over 2, and
# mamba2 has no attention)
TP_SERVE_FAULTS = {QWEN: (), MAMBA: (),
                   RG: ("combine dropped (rank-local softmax)",
                        "wrong sequence offset (every rank at 0)")}
# The two-rank serve against the one-rank captured serve on the same weights
# and prompt, each decode step of the split fed the one-rank serve's token:
# the largest logit difference over the prefill and every step within the
# limit of the dtype, and the greedy tokens equal but where the one-rank's
# top-2 margin is within twice it (a near tie, which a difference within the
# limit can flip; free-running greedy decodes part at the first near tie:
# qwen's least top-2 margin read 0.004, mamba2's 0.0007). In bf16 the split
# rounds each row-parallel output as two bf16 partials and their bf16 sum
# where one GEMM rounds once: on an NVIDIA H100 80GB HBM3 at 700 W the
# prefill's logits moved by 6.0e-2 (qwen) and 1.4e-1 (mamba2), the decode's
# by up to 6.9e-2 and 1.6e-1, over the 2 x 151,936 / 50,280 logits a step
# (PERF.md §6, the first runs; the bf16 limit was set from those). The
# same weights in f32 (cast up; TF32 off) are where the split is held
# tight, and where the planted faults must fail: set before their first
# run, for a split that sums the same f32 products in another order.
TP_SERVE_TOL = {"bfloat16": 3e-1, "float32": 2e-3}
# The bf16 split on the card against the bf16 reference: where the model
# attends (qwen, recurrentgemma), each decode step's first attention op
# call (each rank's partial softmax over its kv heads or slots, and their
# combine) replayed on the CPU in bf16 on the card's inputs, the split's
# collectives over the same gloo group. Reading: the share of its outputs
# not bit-equal, over the steps. The control "the combine rounds the
# normalised p" (the whole decode's rounding in place of each rank's
# exp(s - m)) must read over, on recurrentgemma, whose ring is split along
# its slots. Set before its first run (PERF.md §6): phase 3's
# kernel-vs-plain shares (up to 8e-3 differ) with room for the replayed
# op's own exp and score order.
TP_REPLAYED = "decode attention op, replayed" + SHARE
TP_SERVE_BF16_REF_TOL = {TP_REPLAYED: 5e-2}
TP_SERVE_BF16_FAULTS = {QWEN: (), MAMBA: (), RG: ("the combine rounds the normalised p",)}


# The bf16 split prefill layer by layer (17(f), each rank): a prompt of
# TP_LAYER_LEN tokens (B=1, seed 2; shorter than the served check's, to keep
# the CPU replays of both ranks near 10 s an arch) prefilled on the split
# model with every block kept, and each block's parts replayed on the CPU
# in bf16 on this rank's own inputs to them, the split's collectives over
# the same gloo group (``layer_replays``' readings and limits, from this
# rank's shards' contraction widths; a row-parallel part read on this
# rank's partial, before its sum); each row-parallel sum (the all-reduce over "model"
# of the partial products of wo, the MLP's w_down, the SSD's and the
# RG-LRU's out projections) replayed on the card's own two bf16 partials
# ("row-parallel sums", the share not bit-equal: a sum of two bf16 values
# rounds once on either side, so the limit is TP_REDUCE_TOL, none); and for
# mamba2 the states that the prefill gathers whole over "model" from each
# rank's heads and channels: the SSD state (f32, max abs err / max |replay|,
# limit TP_STATE_TOL: one bf16 step of the scan's inputs, 2^-8, carried
# into a state term through each of the four factors x, dt, B and the
# decay) and the conv window (bf16, the share more than one step off, the
# mixer's limit). Set before the first judged run. The controls: "row-parallel
# sum truncated toward zero" (the partials summed in f32 and cut to bf16,
# where the split rounds to nearest; one step on half the outputs), which
# must read over TP_REDUCE_TOL, and for mamba2 "state gathered from rank 0
# only" (every rank's part of the gathered states taken from rank 0), over
# TP_STATE_TOL.
TP_REDUCE_TOL = 1e-6
TP_STATE_TOL = 2.0 ** -6
TP_LAYER_LEN = 128
TP_LAYER_FAULTS = {QWEN: ("row-parallel sum truncated toward zero",),
                   MAMBA: ("row-parallel sum truncated toward zero",
                           "state gathered from rank 0 only"),
                   RG: ("row-parallel sum truncated toward zero",)}
TP_CACHE_KEYS = {MAMBA: ("ssm", "conv_x")}
TP_LAYER_FAULT_READS = {"row-parallel sum truncated toward zero": "row-parallel sums",
                        "state gathered from rank 0 only": "cache ssm"}


@contextlib.contextmanager
def row_sums(torch, model=None):
    """Inside the context each row-parallel all-reduce (``reduce_from_model``
    of the transformer, the MLP, the SSD and the RG-LRU modules) is kept:
    yields a list of (where, this rank's partial, the sum, the split) on the
    CPU in call order; ``where`` is (layer, "mixer" or "mlp") for a call
    inside ``model``'s blocks, else None."""
    from repro_torch.models import layers, rglru, ssm, transformer
    from repro_torch.readings import mixer_of
    kept, sums, where, hooks = [], [], [None], []
    mods = (transformer, layers, ssm, rglru)

    def wrap(fn):
        def reduce(x, tp):
            out = fn(x, tp)
            if tp is not None:
                sums.append((where[0], x.detach().to("cpu", copy=True),
                             out.detach().to("cpu", copy=True), tp))
            return out
        return reduce

    for i, block in enumerate(model.backbone.layers if model is not None else ()):
        for part, m in (("mixer", mixer_of(block)), ("mlp", block.mlp)):
            if m is not None:
                hooks += [m.register_forward_pre_hook(
                              lambda *a, at=(i, part): where.__setitem__(0, at)),
                          m.register_forward_hook(lambda *a: where.__setitem__(0, None))]
    for m in mods:
        kept.append(m.reduce_from_model)
        m.reduce_from_model = wrap(m.reduce_from_model)
    try:
        yield sums
    finally:
        for m, fn in zip(mods, kept):
            m.reduce_from_model = fn
        for h in hooks:
            h.remove()


def tp_layer_plant(torch, fault: str):
    """A context that plants a TP_LAYER_FAULTS fault."""
    from repro_torch.models import layers, rglru, ssm, transformer
    from repro_torch.parallel import tensor

    def truncated(x, tp):
        if tp is None:
            return x
        t = tensor.reduce_from_model(x.float(), tp)
        return (t.view(torch.int32) & -65536).view(torch.float32).to(x.dtype)

    def rank0_only(x, dim, tp):
        g = tensor.gather_from_model(x, dim, tp)
        if tp is None:
            return g
        part = g.narrow(dim, 0, x.shape[dim])
        return torch.cat([part] * tp.size, dim=dim)

    if fault == "state gathered from rank 0 only":
        return harness().patched(ssm, "gather_from_model", rank0_only)
    stack = contextlib.ExitStack()
    for m in (transformer, layers, ssm, rglru):
        stack.enter_context(harness().patched(m, "reduce_from_model", truncated))
    return stack


def split_layer_replays(torch, model, mesh, arch: str) -> dict:
    """17(f)'s bf16 split prefill layer by layer on this rank (the comment of
    TP_LAYER_FAULTS): the sound prefill, then each of TP_LAYER_FAULTS[arch]
    planted; every rank replays the same calls in the same order."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.parallel import use_mesh
    from repro_torch.parallel.tensor import reduce_from_model
    from repro_torch.readings import keep_blocks, over_one_step, replay_blocks

    t0 = time.perf_counter()
    cfg, n = model.cfg, TP_LAYER_LEN
    mixers = [m for m, _ in cfg.layer_blocks()]
    prompt = launch_serve.random_prompt(model, 1, n, seed=2)
    limits = [part_limits(model.backbone.layers[i], m) for i, m in enumerate(mixers)]
    keys = TP_CACHE_KEYS.get(arch, ())

    def read(planted=None) -> dict:
        with planted or contextlib.nullcontext(), torch.no_grad(), use_mesh(mesh), \
                first_op_calls(every=True) as calls, row_sums(torch, model) as sums, \
                keep_blocks(model) as kept:
            model.prefill(prompt, max_len=n)
        with use_mesh(mesh), row_sums(torch) as again:
            parts = replay_blocks(model, kept, keys)
        # a split part's output on this rank is its partial, before the sum
        # over "model" (read apart, on the card's own partials): the sum of
        # two rounded partials turns a difference under one step of each into
        # a whole step of the sum where the partials cancel
        for (where, x, _, _), (_, y, _, _) in zip([c for c in sums if c[0] is not None], again):
            parts[where[0]][where[1]] = over_one_step(x, y)
        same = []
        with torch.no_grad():
            for _, x, got, tp in sums:
                same.append((got != reduce_from_model(x, tp)).float().mean())
        out = {"layers": parts, "row-parallel sums": float(torch.stack(same).max())}
        for key, lst in calls.items():
            at = [i for i, m in enumerate(mixers) if op_key(m).removesuffix(SHARE) == key]
            for i, call in zip(at, lst):
                a, b = replay_call(torch, call)
                parts[i]["op"] = (float((a != b).float().mean())
                                  if op_key(mixers[i]).endswith(SHARE) else rel_err(a, b))
        return out

    def largest(r) -> dict:
        """Each reading's largest over the layers, relative to its limit:
        (value, layer, limit)."""
        out = {"row-parallel sums": (r["row-parallel sums"], None, TP_REDUCE_TOL)}
        for i, parts in r["layers"].items():
            for part, v in parts.items():
                lim = (TP_STATE_TOL if part == "cache ssm" else limits[i]["mixer"]
                       if part.startswith("cache") else limits[i][part])
                if part not in out or v / lim > out[part][0] / out[part][2]:
                    out[part] = (v, i, lim)
        return out

    sound = largest(read())
    planted = {f: largest(read(tp_layer_plant(torch, f))) for f in TP_LAYER_FAULTS[arch]}
    return {"sound": sound, "planted": planted, "s": time.perf_counter() - t0}


def tp_serve_plant(fault: str):
    """A context that plants ``fault`` (TP_SERVE_FAULTS, TP_SERVE_BF16_FAULTS)
    in the decode path."""
    import torch as torch_mod

    from repro_torch.models import attention

    attend_one = attention._attend_one

    def normalised(q, k_cache, v_cache, valid, softcap, split=None, time_minor=False):
        """Under a sequence split: the softmax normalised over every rank's
        rows before p is rounded to V's dtype (the whole decode's rounding),
        then each rank's P.V summed over "model"."""
        if split is None:
            return attend_one(q, k_cache, v_cache, valid, softcap, split, time_minor)
        b, _, hk, dh = v_cache.shape
        hq = q.shape[1]
        qg = q.reshape(b, hk, hq // hk, dh)
        eq = "bhgd,bhds->bhgs" if time_minor else "bhgd,bshd->bhgs"
        sc = torch_mod.einsum(eq, qg.float(), k_cache.float()) * dh ** -0.5
        if softcap > 0:
            sc = softcap * torch_mod.tanh(sc / softcap)
        sc = sc.masked_fill(~valid, attention.NEG_INF)
        m = attention.max_over_model(sc.amax(dim=-1, keepdim=True), split)
        e = torch_mod.exp(sc - m).masked_fill(~valid, 0.0)
        p = e / attention.reduce_from_model(e.sum(dim=-1, keepdim=True), split)
        o = torch_mod.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
        return attention.reduce_from_model(o, split).reshape(b, hq, dh).to(q.dtype)

    name, fn = {
        "combine dropped (rank-local softmax)": (
            "combine_partials", lambda m, l, acc, split: acc / l.clamp_min(1e-30)),
        "wrong sequence offset (every rank at 0)": ("seq_part", lambda split, rows: (0, rows)),
        "the combine rounds the normalised p": ("_attend_one", normalised),
    }[fault]

    @contextlib.contextmanager
    def ctx():
        old = getattr(attention, name)
        setattr(attention, name, fn)
        try:
            yield
        finally:
            setattr(attention, name, old)
    return ctx()


def tp_serve_arch(torch, dist, mesh, arch: str, rank: int) -> dict:
    """One rank's readings of ``arch``'s serve split over two ranks of
    "model" (phase 17(f)), in bf16 (also each decode step's first attention
    op replayed on the CPU) and with the same weights in f32; rank 0 first
    serves the same request on the whole model through the captured step."""
    from repro_torch.launch import serve as launch_serve

    dev = torch.device("cuda", 0)
    model = launch_serve.build(arch, device=dev, seed=0)
    prompt = launch_serve.random_prompt(model, TP_SERVE_SHAPE[0], TP_SERVE_SHAPE[1], seed=1)
    out = {"bfloat16": tp_serve_dtype(torch, dist, mesh, model, prompt, rank, (),
                                      TP_SERVE_BF16_FAULTS[arch])}
    out["bfloat16"]["layers"] = split_layer_replays(torch, model, mesh, arch)
    del model                                  # it holds its shards now: build it again
    torch.cuda.empty_cache()
    model = f32_copy(torch, launch_serve.build(arch, device=dev, seed=0), dev)
    torch.cuda.empty_cache()
    out["float32"] = tp_serve_dtype(torch, dist, mesh, model, prompt, rank,
                                    TP_SERVE_FAULTS[arch])
    del model
    torch.cuda.empty_cache()
    return out


def tp_serve_dtype(torch, dist, mesh, model, prompt, rank: int, faults,
                   replay_faults=None) -> dict:
    """The request ``prompt`` through the one-rank captured serve (rank 0),
    then through the model split over the mesh's "model" (it stays split),
    sound and with each of ``faults`` planted. With ``replay_faults`` (bf16:
    TP_SERVE_BF16_FAULTS), each decode step's first attention op call is
    replayed on the CPU on the card's inputs, sound and with each of those
    faults planted."""
    from repro_torch.config.base import ParallelConfig
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.parallel import use_mesh
    from repro_torch.serve.decode import make_serve_step

    dev = model.device
    b, s, steps = TP_SERVE_SHAPE
    max_len = s + steps + 1
    par = ParallelConfig(multi_pod=True, pods=1, data=1, model=2)
    attend_one = attention._attend_one       # the sound op, for the CPU replay
    out = {"batch": b, "prompt": s, "steps": steps}
    ref = torch.zeros((steps + 1, b), dtype=torch.int64)
    if rank == 0:
        step, _, _ = make_serve_step(model, ParallelConfig(), None, b, max_len)
        t0 = time.perf_counter()
        caches, logits = model.prefill(prompt, max_len)
        token = torch.argmax(logits, -1)
        toks, logs = [token], [logits]
        for t in range(steps):
            caches, token = step(caches, token, s + t)
            toks.append(token)
            logs.append(step.logits.clone())
        torch.cuda.synchronize()
        top2 = torch.stack(logs).topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]                     # [steps + 1, B]
        ref_logits, ref = torch.stack(logs), torch.stack(toks).cpu()
        out["one_rank"] = {"tokens": ref.tolist(), "captures": step.captures,
                           "ms": (time.perf_counter() - t0) * 1e3,
                           "top2_margin": margin.tolist()}
        del step, caches
    torch.cuda.empty_cache()
    dist.broadcast(ref, 0)          # the one-rank serve's tokens, fed to both ranks
    ref = ref.to(dev)
    step, _, _ = make_serve_step(model, par, mesh, b, max_len)
    torch.cuda.empty_cache()
    out["shards"] = {"parameters": sum(p.numel() for p in model.parameters()),
                     "whole": sum(math.prod(sh) for sh in model.whole_shapes.values())}
    fwd = {k: getattr(ops, k) for k in ("flash_attention_fwd", "ssd_scan_fwd",
                                         "rglru_scan_fwd")}
    dims = {"flash_attention_fwd": lambda q, *a: int(q.shape[2]),        # q heads
            "ssd_scan_fwd": lambda x, *a: int(x.shape[2]),               # SSD heads
            "rglru_scan_fwd": lambda a, *r: int(a.shape[-1])}            # RG-LRU width
    seen = {k: [] for k in fwd}

    def counted(k):
        def fn(*args, **kw):
            seen[k].append(dims[k](*args))
            return fwd[k](*args, **kw)
        return fn

    def decode(caches, planted):
        """The steps on ``caches``, each fed the one-rank serve's token:
        (logits [steps, B, V], with ``replay_faults`` each step's first
        attention op call (its inputs and output, on the CPU))."""
        calls, logs = [], []
        with planted:
            attend = attention._attend_one

            def first_call(*args):
                out = attend(*args)
                if len(calls) < len(logs) + 1:
                    calls.append(([a.to("cpu", copy=True) if torch.is_tensor(a) else a
                                   for a in args], out.cpu()))
                return out

            if replay_faults is not None:
                attention._attend_one = first_call
            try:
                for t in range(steps):
                    caches, _, lg = step.eager(caches, ref[t], s + t)
                    logs.append(lg)
            finally:
                attention._attend_one = attend
        return torch.stack(logs), calls

    def serve_split(fault=None) -> dict:
        """The request on the split model, each decode step fed the one-rank
        serve's token of the step before (so both sides read the same
        inputs): each step's argmax and logits, and each decode step's first
        attention op call (under "_calls")."""
        planted = tp_serve_plant(fault) if fault else contextlib.nullcontext()
        for v in seen.values():
            v.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_counts()
        for k in fwd:
            setattr(ops, k, counted(k))
        try:
            with use_mesh(mesh):
                caches, logits = model.prefill(prompt, max_len)
        finally:
            for k, f in fwd.items():
                setattr(ops, k, f)
        launches = read_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec_logits, dec_calls = decode(caches, planted)
        torch.cuda.synchronize()
        toks = torch.cat([torch.argmax(logits, -1)[None], torch.argmax(dec_logits, -1)])
        logs = torch.cat([logits[None], dec_logits])
        r = {"tokens": toks.tolist(), "launches": launches,
             "dims": {k: sorted(set(v)) for k, v in seen.items()},
             "prefill_ms": (t1 - t0) * 1e3, "decode_ms": (time.perf_counter() - t1) * 1e3,
             "logits_sum": float(logs.double().sum()),
             "caches": sorted({(k, tuple(t.shape)) for c in caches for k, t in c.items()}),
             "_calls": dec_calls}
        if rank == 0:
            err = (logs - ref_logits).abs().amax(dim=-1)                # [steps + 1, B]
            r["logits_err_by_step"] = err.amax(dim=-1).tolist()
            r["logits_err"] = float(err.max())
            r["tokens_equal"] = bool(torch.equal(toks, ref))
            r["tokens_differ_at"] = [[int(i), int(j), float(margin[i, j])]
                                     for i, j in (toks != ref).nonzero().tolist()]
        return r

    def public(r: dict) -> dict:
        return {k: v for k, v in r.items() if not k.startswith("_")}

    sound = serve_split()
    out["split"] = public(sound)
    out["captures"] = step.captures
    out["planted"] = {f: public(serve_split(f)) for f in faults}
    if replay_faults is not None and sound["_calls"]:

        def replayed_share(r) -> dict:
            """The share of the outputs of each decode step's first
            attention op call not bit-equal to the sound op replayed on the
            CPU on the card's inputs (the split's collectives over the same
            gloo group)."""
            same = [(out == attend_one(*args)).float().mean() for args, out in r["_calls"]]
            return {TP_REPLAYED: 1.0 - float(torch.stack(same).mean())}

        t0 = time.perf_counter()
        out["vs_cpu_bf16"] = {"split": replayed_share(sound),
                              "planted": {f: replayed_share(serve_split(f))
                                          for f in replay_faults}}
        out["vs_cpu_bf16"]["s"] = time.perf_counter() - t0
    return out


def phase_tensor_parallel_serve(torch, card: str) -> dict:
    """Phase 17(f): qwen, mamba2 and recurrentgemma at full width each
    serve a request of TP_SERVE_SHAPE split over two ranks of "model" on the
    one card (two processes, gloo over CUDA tensors), in bf16 and with the
    same weights in f32: the prefill runs the kernels on each rank's shards
    (flash on its q heads, the SSD scan on its heads, the RG-LRU scan on its
    width), the caches take ``cache_spec``'s layout, and the decode steps
    eagerly (``ServeStep.eager``; the step does not capture). Against the
    one-rank captured serve: logits within TP_SERVE_TOL and greedy tokens
    equal but at near ties; recurrentgemma's planted faults must fail the
    f32 check."""
    from repro_torch.config import get_model_config
    from repro_torch.config.base import ParallelConfig
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.serve.kvcache import cache_shape_specs

    t0 = time.perf_counter()
    ranks = run_tp_ranks(ROOT / "build" / "chip_smoke_tp_serve", "serve", "phase 17(f)")
    b, s, steps = TP_SERVE_SHAPE
    out = {"shape": {"batch": b, "prompt": s, "steps": steps}, "tol": TP_SERVE_TOL,
           "bf16_ref_tol": TP_SERVE_BF16_REF_TOL,
           "staged": ranks[0]["staged"], "archs": {}}

    def parts(r, tol) -> bool:
        """Whether a split serve parts from the one-rank serve: logits over
        ``tol``, or a token that differs where the one-rank's top-2 margin
        is over twice it."""
        return (not r["logits_err"] <= tol
                or any(m > 2 * tol for *_, m in r["tokens_differ_at"]))

    for arch in TP_SERVE_FAULTS:
        cfg = get_model_config(arch)
        rules = ShardingRules(cfg, ParallelConfig(multi_pod=True, pods=1, data=1, model=2))
        want = sorted({(k, tuple(t.shape)) for c in cache_shape_specs(
            cfg, b, s + steps + 1, rules=rules) for k, t in c.items()})
        expected = expected_launches(cfg)
        # each rank's half: of the q heads, the SSD heads, the RG-LRU width
        dims = {"flash_attention_fwd": cfg.num_heads // 2,
                "ssd_scan_fwd": cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim // 2,
                "rglru_scan_fwd": (cfg.rglru_width or cfg.d_model) // 2}
        out["archs"][arch] = {}
        for dtype, tol in TP_SERVE_TOL.items():
            r0, r1 = (ranks[i]["archs"][arch][dtype] for i in range(2))
            one, split = r0["one_rank"], r0["split"]
            for rank, r in enumerate((r0, r1)):
                sp = r["split"]
                print(f"  (f) {arch} ({b} x {s} + {steps}, {dtype}) rank {rank}: prefill "
                      f"{sp['prefill_ms']:.1f} ms, {steps} eager steps {sp['decode_ms']:.1f} ms; "
                      f"shards {r['shards']['parameters']} of {r['shards']['whole']} "
                      f"parameters; launches {sp['launches']}, on {sp['dims']} (q heads / SSD "
                      f"heads / RG-LRU width); caches {sp['caches']} [{card}]", flush=True)
            least = min(min(m) for m in one["top2_margin"])
            print(f"  (f) {arch} {dtype}: one rank captured ({one['ms']:.1f} ms, least top-2 "
                  f"logit margin {least:.4g}); two ranks, each step fed the one-rank token: "
                  f"logits {split['logits_err']:.4e} (limit {tol:g}; by step "
                  f"{', '.join(f'{e:.3e}' for e in split['logits_err_by_step'])}), tokens "
                  f"equal {split['tokens_equal']} (differ at [step, row, one-rank top-2 "
                  f"margin] {split['tokens_differ_at']})"
                  + "".join(f"; control, {f}: logits {p['logits_err']:.4e}, tokens differ at "
                            f"{len(p['tokens_differ_at'])} of {(steps + 1) * b}"
                            for f, p in r0["planted"].items()), flush=True)
            check(r0["split"]["tokens"] == r1["split"]["tokens"]
                  and r0["split"]["logits_sum"] == r1["split"]["logits_sum"],
                  f"{arch} {dtype}: the two ranks' tokens or logits differ")
            check(not parts(split, tol), f"{arch} {dtype}: the two-rank serve parts from the "
                  f"one-rank serve: logits {split['logits_err']}, tokens differ at "
                  f"{split['tokens_differ_at']}")
            for f, p in r0["planted"].items():
                check(parts(p, tol), f"{arch} {dtype}: the two-rank check does not catch: {f}")
            if "vs_cpu_bf16" in r0:
                vs, lim = r0["vs_cpu_bf16"], TP_SERVE_BF16_REF_TOL
                print(f"  (f) {arch} bf16: the split against the CPU bf16 reference, {steps} "
                      f"decode steps ({vs['s']:.1f} s): " + ", ".join(
                          f"{k} {v:.4e} (limit {lim[k]:g})" for k, v in vs["split"].items())
                      + "".join(f"; control, {f}: " + ", ".join(
                          f"{k} {v:.4e}" for k, v in c.items())
                          for f, c in vs["planted"].items()), flush=True)
                check(all(v <= lim[k] for k, v in vs["split"].items()),
                      f"{arch}: the bf16 split parts from the CPU bf16 reference: "
                      f"{vs['split']}")
                for f, c in vs["planted"].items():
                    check(any(v > lim[k] for k, v in c.items()),
                          f"{arch}: the bf16 split's check against the CPU does not catch: {f}")
            if "layers" in r0:
                sound = {k: max((r["layers"]["sound"][k] for r in (r0, r1)),
                                key=lambda x: x[0] / x[2]) for k in r0["layers"]["sound"]}
                planted = {f: {k: max((r["layers"]["planted"][f][k] for r in (r0, r1)),
                                      key=lambda x: x[0] / x[2])
                               for k in r0["layers"]["planted"][f]}
                           for f in r0["layers"]["planted"]}
                print(f"  (f) {arch} bf16 split prefill layer by layer (B=1, S={TP_LAYER_LEN}, "
                      f"each rank's parts replayed on the CPU on its inputs, the collectives over "
                      f"gloo; {r0['layers']['s']:.1f} s): " + ", ".join(
                          f"{k} {v:.3e}" + (f" at layer {i}" if i is not None else "")
                          + f" (limit {lim:.3e})" for k, (v, i, lim) in sound.items())
                      + "".join(f"; control, {f}: {TP_LAYER_FAULT_READS[f]} "
                                f"{c[TP_LAYER_FAULT_READS[f]][0]:.3e}"
                                for f, c in planted.items()) + f" [{card}]", flush=True)
                for k, (v, i, lim) in sound.items():
                    check(v <= lim / 2, f"{arch}: the bf16 split prefill's {k} reads {v:.3e} "
                          f"at layer {i} against the CPU bf16 reference, over half its limit "
                          f"{lim:.3e}")
                for f, c in planted.items():
                    v, _, lim = c[TP_LAYER_FAULT_READS[f]]
                    check(v > lim, f"{arch}: the split prefill's layer replay does not catch: "
                                   f"{f} ({v:.3e}, limit {lim:.3e})")
                out["archs"][arch]["layers"] = {"sound": sound, "planted": planted}
            for r in (r0, r1):
                sp = r["split"]
                check(sp["launches"] == expected,
                      f"{arch}: split prefill launches {sp['launches']}, expected {expected}")
                check(r["captures"] == 0, f"{arch}: the split step captured a graph")
                check(r["shards"]["parameters"] < r["shards"]["whole"],
                      f"{arch}: a rank holds every parameter whole")
                check(sorted((k, tuple(sh)) for k, sh in sp["caches"]) == want,
                      f"{arch}: caches {sp['caches']}, expected cache_spec's {want}")
                for k, n in dims.items():
                    check(sp["dims"][k] in ([], [n]),
                          f"{arch}: {k} ran on {sp['dims'][k]} a rank, expected {n}")
            out["archs"][arch][dtype] = {"one_rank": one, "ranks": [r0, r1]}
        print(f"  (f) {arch}: {ranks[0]['archs'][arch]['s']:.1f} s", flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(f"  (f) {out['seconds']:.1f} s", flush=True)
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
    golden scenarios, graph vs eager bit for bit and two planted faults; the
    figures at the paper's horizons are unit 10f (``phase_netsim_figures``)."""
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
    out["planted"] = netsim_planted(torch, (
        ("ring wraps at delay_pad instead of each scenario's d_steps",
         "batch/dcqcn", (fluid, "ring_row", wrap_at_pad)),
        ("MatchRDMA's source-OTN release ignores the budget gate",
         "seq/matchrdma", (MatchRdmaScheme, "src_otn_release",
                           Scheme.src_otn_release))), cpu, dev)
    print(f"  peak buffer (seq, card), MB: " + ", ".join(
        f"{s} {cards['seq/' + s]['peak_buffer'][0] / 1e6:.3f}" for s in NETSIM_SCHEMES),
        flush=True)
    return out


def wrap_at_pad(t, d_steps, delay_pad):
    """Planted in ``fluid.ring_row``: the delay ring wraps at the batch's
    delay_pad instead of each scenario's d_steps."""
    return t % d_steps.new_full(d_steps.shape, delay_pad)


def figure_reference():
    """tests/torch_figure_reference.py (the holding rule; it imports no JAX)
    and the JAX package's rows it recorded."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import torch_figure_reference as ref
    global _FIGURE_DOC
    if _FIGURE_DOC is None:
        _FIGURE_DOC = ref.load()
    return ref, _FIGURE_DOC


_FIGURE_DOC = None


def record_line(name: str, r: dict, card: str) -> str:
    """One scheme's batch of a figure: wall, capture, cell-steps/s, device ms
    a step and, where it was profiled, kernels a step and the idle share."""
    from repro_torch.launch.netsim import fmt

    line = (f"  {name} {r['scheme']}: {r['cells']} cells x {r['steps']} steps, wall "
            f"{r['wall_s']:.2f} s (capture {r['capture_s']:.2f} s), "
            f"{r['cell_steps_per_s']:.0f} cell-steps/s, device "
            f"{r['device_ms_per_step']:.4f} ms/step")
    if "idle_share" in r:
        line += (f", {fmt(r['kernels_per_step'], '.0f')} kernels/step; profiled graph "
                 f"of {r['graph_steps']} steps: {fmt(r['graph_kernel_ms_per_step'], '.4f')} "
                 f"ms of kernels in {fmt(r['graph_span_ms_per_step'], '.4f')} ms a step, "
                 f"idle {fmt(r['idle_share'], '.1%')}; empty traces taken again "
                 f"{r['empty_traces']}")
    return line + f" [{card}]"


def held_rows(name: str, values: dict, label: str = "") -> dict:
    """A figure's kept rows (``Figure.values``) held against JAX's recorded
    rows of figure ``name`` (``torch_figure_reference.hold``): prints the
    count line, the ``FIGURE_PARTS`` rows and the first rows outside;
    returns the reading without the per-row readings."""
    ref, doc = figure_reference()
    held = ref.hold(values, doc["figures"][name])
    print(f"  {label}{ref.summary(name, held)}", flush=True)
    for row in held["parts"]:
        print(f"    FIGURE_PARTS {row}: {ref.FIGURE_PARTS.get(row, 'derived from a named row')}",
              flush=True)
    for row in held["outside"][:12]:
        print(f"    outside: {json.dumps(row)}", flush=True)
    return {k: v for k, v in held.items() if k != "readings"}


def phase_netsim_figures(torch, card: str) -> dict:
    """Unit 10f: the paper's Fig. 3b, 3c/d and 3e at its horizons
    (NETSIM_FIG3) through launch.netsim, each scheme's grid one batch, every
    row held against JAX's recorded row for the same cell; then two planted
    faults, each in one scheme's batch (the other schemes' batches kept from
    the sound run), whose rows must fall outside."""
    from repro_torch.launch import netsim as launch_netsim
    from repro_torch.netsim import fluid
    from repro_torch.netsim.schemes.base import Scheme
    from repro_torch.netsim.schemes.matchrdma import MatchRdmaScheme

    dev = torch.device("cuda")
    out, sound = {}, {}
    for name, (full, horizon, n_cells) in NETSIM_FIG3.items():
        t0 = time.perf_counter()
        fig = launch_netsim.Figure(name, dev, horizon,
                                   profile_steps=NETSIM_FIG3_PROFILE_STEPS[name])
        rows = launch_netsim.FIGURES[name](fig, full=full)
        for r in fig.records:
            check(r["cells"] == n_cells and r["launches"] == 1,
                  f"{name} {r['scheme']}: {r['cells']} cells in {r['launches']} launches")
            print(record_line(name, r, card), flush=True)
        for row, _, note in rows:
            print(f"  {row}: {note}")
        out[name] = {"schemes": [{k: v for k, v in r.items() if k != "top_kernels"}
                                 for r in fig.records],
                     "held": held_rows(name, fig.values), "rows": rows,
                     "s": time.perf_counter() - t0}
        print(f"  ({name}: {out[name]['s']:.1f} s)", flush=True)
        sound[name] = fig

    class Replaying(launch_netsim.Figure):
        """Runs ``scheme``'s batch; the others are the sound run's rows."""

        def __init__(self, kept, scheme):
            super().__init__(kept.name, dev, kept.horizon_us, profile_steps=0)
            self.kept, self.scheme = kept, scheme

        def run(self, cfgs, workload, scheme, horizon_us, **kw):
            if scheme != self.scheme:
                return self.kept.batches[scheme], 0.0
            return super().run(cfgs, workload, scheme, horizon_us, **kw)

    controls = {}
    for fault, name, scheme, (owner, attr, repl) in (
            ("MatchRDMA's source-OTN release ignores the budget gate", "fig3cd",
             "matchrdma", (MatchRdmaScheme, "src_otn_release", Scheme.src_otn_release)),
            ("ring wraps at delay_pad instead of each scenario's d_steps", "fig3b",
             "dcqcn", (fluid, "ring_row", wrap_at_pad))):
        t0 = time.perf_counter()
        fig = Replaying(sound[name], scheme)
        kept = owner.__dict__[attr]
        setattr(owner, attr, repl)
        try:
            launch_netsim.FIGURES[name](fig, full=NETSIM_FIG3[name][0])
        finally:
            setattr(owner, attr, kept)
        controls[fault] = {"figure": name, "scheme": scheme,
                           "held": held_rows(name, fig.values, f"control, {fault}: "),
                           "s": time.perf_counter() - t0}
    out["controls"] = controls
    bad = {n: out[n]["held"]["outside"] for n in NETSIM_FIG3 if out[n]["held"]["outside"]}
    check(not bad, f"Fig. 3 rows outside JAX's envelope and not in FIGURE_PARTS: "
                   f"{json.dumps(bad)[:4000]}")
    for fault, c in controls.items():
        check(bool(c["held"]["outside"]), f"the rows held against JAX's do not catch: {fault}")
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
    default); every row held against JAX's (``held_rows``)."""
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
        print(record_line(name, r, card), flush=True)
    for row, _, note in rows:
        if "/summary/" in row:
            print(f"  {row}: {note}", flush=True)
    check(len(rows) == 7 * n_cells + 7, f"{name}: {len(rows)} rows")
    held = held_rows(name, fig.values)
    check(not held["outside"], f"{name}: rows outside JAX's envelope and not in "
                               f"FIGURE_PARTS: {json.dumps(held['outside'])[:4000]}")
    print(f"  ({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
    return {"schemes": [{k: v for k, v in r.items() if k != "top_kernels"}
                        for r in fig.records],
            "rows": rows, "held": held}


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

    from repro_torch.launch import netsim as launch_netsim
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
        n = 0
        for _ in range(launch_netsim.PROFILE_TRIES):   # an empty trace is taken again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                draws()
                torch.cuda.synchronize(dev)
            n = sum(e.device_type == DeviceType.CUDA for e in prof.events())
            if n:
                break
        out[f"L={links}"] = n if n else "not measured"
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
              f"{r['device_ms_per_step']:.4f} ms/step, "
              f"{launch_netsim.fmt(r['kernels_per_step'], '.0f')} "
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
    ref, _ = figure_reference()
    held = held_rows(ref.GEO, ref.geo_values(geo))
    check(not held["outside"], f"geo_training: rows outside JAX's envelope and not in "
                               f"FIGURE_PARTS: {json.dumps(held['outside'])[:4000]}")
    out["geo_training"] = {"runs": geo["runs"], "repair_speedup": geo["lossy"]["repair_speedup"],
                           "held": held, "s": time.perf_counter() - t0}
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


def dryrun_main(out: Path) -> None:
    """Phase 18's child (``chip_smoke.py --dryrun OUT``): the dry run of
    phase 7's workload on a 1 x 1 mesh (remat "block" and the control
    "none"), then DRYRUN_CELLS; the results as JSON into ``OUT``."""
    sys.path.insert(0, str(SRC))
    import torch

    torch.set_num_threads(2)
    from repro_torch.config import ParallelConfig, ShapeSpec, get_model_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.launch.train import TRAIN_WORKLOADS

    t0 = time.perf_counter()
    b, s, _ = TRAIN_WORKLOADS[QWEN]
    mesh = fake_mesh((1, 1), ("data", "model"), "cuda")
    predicted = {}
    for remat in ("block", "none"):
        par = ParallelConfig(multi_pod=False, data=1, model=1, remat=remat)
        r = dryrun.run_train(get_model_config(QWEN), par, ShapeSpec("phase 7", s, b, "train"),
                             mesh)
        rec = r.pop("rec")
        predicted[remat] = dict(r, kernel_ops=rec.kernel_ops)
    # phase 17(e)'s qwen step, split over two ranks of "model": rank 0 of a
    # fake group of two
    mesh = fake_mesh((1, 1, 2), ("pod", "data", "model"), "cuda")
    par = ParallelConfig(multi_pod=True, pods=1, data=1, model=2)
    r = dryrun.run_train(get_model_config(QWEN), par, ShapeSpec("phase 17(e)", s, b, "train"),
                         mesh)
    rec = r.pop("rec")
    predicted["split"] = dict(r, kernel_ops=rec.kernel_ops)
    cells = {}
    for arch, shape, mp, _ in DRYRUN_CELLS:
        cells[dryrun.cell_name(arch, shape, mp)] = dryrun.run_cell(arch, shape, mp)
    out.write_text(json.dumps({"predicted": predicted, "cells": cells,
                               "s": time.perf_counter() - t0}))


def start_dryrun():
    """Starts phase 18's child process (in a session of its own); it is
    stopped when this script exits."""
    import atexit
    import os
    import signal

    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "dryrun.json"
    out.unlink(missing_ok=True)
    with open(out_dir / "dryrun.out", "w") as log:
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun",
                                 str(out)], stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                                start_new_session=True)

    def stop():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    atexit.register(stop)
    return proc, out


def phase_dryrun(torch, card: str, child, trained: dict, split: dict, t_start: float) -> dict:
    """Phase 18's checks (the module docstring) on the child's results;
    ``split`` is phase 17(e)'s record."""
    proc, out = child
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=max(NETSIM_DEADLINE_S - (time.perf_counter() - t_start), 1.0))
    except subprocess.TimeoutExpired:
        fail("the dry run's child was still running at the deadline")
    log = (out.parent / "dryrun.out").read_text()
    if proc.returncode != 0 or not out.exists():
        print(log[-4000:], file=sys.stderr, flush=True)
        fail(f"the dry run's child exited with {proc.returncode}")
    res = json.loads(out.read_text())
    print(f"  child: {res['s']:.1f} s (beside phases 2-17; waited {time.perf_counter() - t0:.1f} s)",
          flush=True)
    for arch, shape, mp, status in DRYRUN_CELLS:
        c = res["cells"][f"{arch}__{shape}__{'multi' if mp else 'single'}"]
        check(c["status"] == status, f"dry run {arch} {shape} {c['mesh']}: {c['status']}")
        if status != "OK":
            print(f"  {arch} {shape} {c['mesh']}: {c['status']}", flush=True)
            continue
        counts = [c[k] for k in ("hlo_dot_flops_per_device", "hlo_hbm_bytes_per_device",
                                 "peak_bytes", "argument_size_in_bytes", "model_flops")]
        check(all(math.isfinite(x) and x > 0 for x in counts),
              f"dry run {arch} {shape} {c['mesh']}: a count is not positive and finite: {counts}")
        check(math.isfinite(c["collective_bytes_per_device"]), "collective bytes not finite")
        rf = c["roofline"]
        print(f"  {arch} {shape} {c['mesh']}: peak {c['peak_bytes'] / 1e9:.3f} GB a rank "
              f"(arguments {c['argument_size_in_bytes'] / 1e9:.3f}, under the rules "
              f"{c['argument_size_in_bytes_under_rules'] / 1e9:.3f}), "
              f"{c['hlo_dot_flops_per_device']:.4e} FLOPs, "
              f"{c['hlo_hbm_bytes_per_device']:.4e} HBM bytes, collectives intra "
              f"{c['intra_pod_bytes_per_device']:.4e} / inter {c['inter_pod_bytes_per_device']:.4e} "
              f"B; roofline {rf['t_compute_s']:.4f} / {rf['t_memory_s']:.4f} / "
              f"{rf['t_collective_s']:.4f} s ({rf['dominant']}); kernel ops "
              f"{ {k: v['calls'] for k, v in c['kernel_ops'].items()} }; "
              f"{c['lower_s']} + {c['compile_s']} s", flush=True)
    mem = trained[QWEN]["step_memory"]
    readings = {}
    split_pred = res["predicted"].pop("split")
    for remat, p in res["predicted"].items():
        readings[remat] = {"peak_bytes": p["peak_bytes"],
                           "argument_size_in_bytes": p["argument_size_in_bytes"],
                           "rel_err": abs(p["peak_bytes"] - mem["peak_bytes"]) / mem["peak_bytes"],
                           "flash_calls": p["kernel_ops"].get("flash_attention", {}).get("calls", 0)}
        print(f"  card check, remat {remat!r}: predicted peak {p['peak_bytes']} B (arguments "
              f"{p['argument_size_in_bytes']}), card {mem['peak_bytes']} B (arguments "
              f"{mem['args_bytes']}, + {mem['peak_over_start_bytes']} over the step's start): "
              f"relative {readings[remat]['rel_err']:.4e} (limit {DRYRUN_PEAK_TOL}); flash calls "
              f"a step {readings[remat]['flash_calls']} against {mem['flash_launches']} "
              f"launches [{card}]", flush=True)
    sound, control = readings["block"], readings["none"]
    check(sound["argument_size_in_bytes"] == mem["args_bytes"],
          f"the dry run's arguments {sound['argument_size_in_bytes']} B are not the card "
          f"step's {mem['args_bytes']} B")
    check(sound["rel_err"] <= DRYRUN_PEAK_TOL,
          f"the dry run's peak is {sound['rel_err']:.3e} from the card's (limit {DRYRUN_PEAK_TOL})")
    check(sound["flash_calls"] == mem["flash_launches"],
          f"the dry run counts {sound['flash_calls']} flash calls a step, the card "
          f"{mem['flash_launches']}")
    check(control["rel_err"] > DRYRUN_PEAK_TOL,
          "the card check does not catch the control: the peak under remat 'none'")
    # phase 17(e)'s qwen step on each of its two ranks
    split_readings = []
    for rank, r in enumerate(split["archs"][QWEN]["ranks"]):
        card_split = r["split"]
        rel = abs(split_pred["peak_bytes"] - card_split["peak_bytes"]) / card_split["peak_bytes"]
        calls = split_pred["kernel_ops"].get("flash_attention", {}).get("calls", 0)
        split_readings.append({"rank": rank, "predicted_peak_bytes": split_pred["peak_bytes"],
                               "card_peak_bytes": card_split["peak_bytes"], "rel_err": rel,
                               "predicted_args": split_pred["argument_size_in_bytes"],
                               "card_args": card_split["args_bytes"], "flash_calls": calls})
        print(f"  card check, qwen split over two ranks of \"model\" (phase 17(e)), rank "
              f"{rank}: predicted peak {split_pred['peak_bytes']} B (arguments "
              f"{split_pred['argument_size_in_bytes']}), card {card_split['peak_bytes']} B "
              f"(arguments {card_split['args_bytes']}): relative {rel:.4e} (limit "
              f"{DRYRUN_PEAK_TOL}); flash calls a step {calls} against "
              f"{card_split['launches']['flash_attention']} launches [{card}]", flush=True)
        check(split_pred["argument_size_in_bytes"] == card_split["args_bytes"],
              f"the dry run's split arguments {split_pred['argument_size_in_bytes']} B are not "
              f"rank {rank}'s {card_split['args_bytes']} B")
        check(rel <= DRYRUN_PEAK_TOL, f"the dry run's split peak is {rel:.3e} from rank "
                                      f"{rank}'s (limit {DRYRUN_PEAK_TOL})")
        check(calls == card_split["launches"]["flash_attention"],
              f"the dry run counts {calls} flash calls a split step, rank {rank} "
              f"{card_split['launches']['flash_attention']}")
    keys = ("status", "peak_bytes", "argument_size_in_bytes", "argument_size_in_bytes_under_rules",
            "hlo_dot_flops_per_device", "hlo_hbm_bytes_per_device", "intra_pod_bytes_per_device",
            "inter_pod_bytes_per_device", "compile_s")
    cells = {name: {k: c[k] for k in keys if k in c} | (
        {"dominant": c["roofline"]["dominant"]} if "roofline" in c else {})
        for name, c in res["cells"].items()}
    return {"cells": cells, "card_check": {"card": mem, "predicted": readings,
                                           "split": split_readings, "tol": DRYRUN_PEAK_TOL},
            "child_s": res["s"]}


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


def run_lanes(torch, t_start: float) -> dict:
    """Phases 10-14 and 17: the NETSIM_LANES as child processes (each in a session
    of its own, so that stopping it stops its CPU workers too), their logs
    printed in phase order once all have ended, with the most card memory
    that all processes held at once while they ran (read each second) and
    the units then running; fails the run if a lane fails or
    NETSIM_DEADLINE_S passes. Returns each unit's record."""
    import os
    import shutil
    import signal

    out_dir = ROOT / "build" / "chip_smoke"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    lanes, ended = [], {}
    free, total = torch.cuda.mem_get_info()
    start_used = peak = (total - free, 0.0, ())
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
            free, _ = torch.cuda.mem_get_info()
            if total - free > peak[0]:
                peak = (total - free, time.perf_counter() - t0, tuple(
                    next((u for u in units if not (out_dir / f"{u}.json").exists()), "")
                    for i, units in enumerate(NETSIM_LANES) if i not in ended))
            if time.perf_counter() - t_start > NETSIM_DEADLINE_S:
                bad = f"the lanes were still running {NETSIM_DEADLINE_S:.0f} s after the start"
    finally:
        for proc in lanes:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for unit, (n, title, _) in NETSIM_UNITS.items():
        if title:
            print(f"[{n}/18] {title}", flush=True)
        lane = next(i for i, u in enumerate(NETSIM_LANES) if unit in u)
        print(f"  unit {unit}, lane {lane} ({', '.join(NETSIM_LANES[lane])}):", flush=True)
        log = out_dir / f"{unit}.log"
        print(log.read_text() if log.exists() else "  (not run)\n", end="", flush=True)
    for i, units in enumerate(NETSIM_LANES):
        print(f"  lane {i} ({', '.join(units)}): "
              + (f"ended after {ended[i]:.1f} s" if i in ended else "stopped"), flush=True)
    print(f"  card memory in use: {start_used[0] / 1e9:.2f} GB at the lanes' start, at most "
          f"{peak[0] / 1e9:.2f} GB of {total / 1e9:.2f} GB ({peak[1]:.0f} s in, units "
          f"{', '.join(u for u in peak[2] if u)} running)", flush=True)
    if bad is not None:
        for i in range(len(lanes)):
            tail = (out_dir / f"lane{i}.out").read_text()[-4000:]
            if tail.strip():
                print(f"--- lane {i} output ---\n{tail}", file=sys.stderr, flush=True)
        fail(bad)
    print(f"  (phases 10-14 and 17: {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_start:.1f} s)", flush=True)
    return {unit: json.loads((out_dir / f"{unit}.json").read_text())
            for unit in NETSIM_UNITS}


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--lane":
        return lane_main(Path(sys.argv[2]), sys.argv[3:])
    if len(sys.argv) > 2 and sys.argv[1] == "--dryrun":
        return dryrun_main(Path(sys.argv[2]))
    if len(sys.argv) > 4 and sys.argv[1] == "--tp-rank":
        return tp_rank_main(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]),
                            *sys.argv[5:6])
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
    print(f"[1/18] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}, compute capability {cap[0]}.{cap[1]}", flush=True)
    check(cap == (9, 0), f"needs compute capability 9.0 (sm_90a), found {cap}")
    dryrun_child = start_dryrun()

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build(build.sources())
    print(f"[2/18] build: {len(logs)} of {len(build.sources())} kernel sources compiled "
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
    print("[3/18] kernels against their plain versions", flush=True)
    flash = phase_flash(torch, card)
    ssd = phase_ssd(torch, card)
    scan = phase_rglru(torch, card)
    grads = phase_grads(torch, card)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)

    served = {}
    for i, (arch, faults) in enumerate(((QWEN, qwen_faults(torch)),
                                        (MAMBA, mamba_faults(torch)),
                                        (RG, rglru_faults(torch))), start=4):
        t0 = time.perf_counter()
        print(f"[{i}/18] serve {arch} at full width", flush=True)
        served[arch] = phase_serve(torch, card, arch, faults, MUST_FAIL[arch])
        print(f"  ({time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
        torch.cuda.empty_cache()

    trained, faults = {}, train_faults(torch)
    for i, arch in enumerate((QWEN, MAMBA, RG), start=7):
        t0 = time.perf_counter()
        print(f"[{i}/18] train {arch} at full width", flush=True)
        trained[arch] = phase_train(torch, card, arch, faults[arch])
        print(f"  ({time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    # Phases 15-16 need the card alone too, so they run before the lanes.
    print("[15/18] serve the seven other archs at their published widths", flush=True)
    for arch in NEW_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        served[arch] = phase_serve(torch, card, arch, new_arch_faults(torch).get(arch, {}),
                                   moe_planted={
                                       **(moe_faults(torch) if arch == GRANITE else {}),
                                       **(moe_bf16_faults(torch) if arch in (GRANITE, PHI)
                                          else {})})
        print(f"  ({arch}: {time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)
    print("[16/18] train four of them at full width", flush=True)
    for arch in NEW_TRAINED:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        trained[arch] = phase_train(torch, card, arch, {})
        print(f"  ({arch}: {time.perf_counter() - t0:.1f} s; total "
              f"{time.perf_counter() - t_start:.1f} s)", flush=True)

    torch.cuda.empty_cache()
    units = run_lanes(torch, t_start)
    netsim = dict(units["10"], figures=units["10f"])
    netsim_links = {**units["11"], **units["11g"]}
    netsim_channel = {**units["12"], **units["12g"]}
    obs, netsim_grad = units["13"], units["14"]
    parallel = dict(units["17"], tensor_parallel=units["17t"], serve_split=units["17s"])
    print("[18/18] the dry run on fake groups of the production mesh", flush=True)
    dry = phase_dryrun(torch, card, dryrun_child, trained, units["17t"], t_start)
    print(f"  (total {time.perf_counter() - t_start:.1f} s)", flush=True)

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
        # phase 17(e): a step split over two ranks of "model", each rank's count
        per_split_step = {arch: r["ranks"][0]["split"]["launches"][kernel]
                          for arch, r in units["17t"]["archs"].items()
                          if r["ranks"][0]["split"]["launches"][kernel]}
        # phase 17(f): a prefill split over two ranks of "model", each rank's count
        per_split_prefill = {arch: r["bfloat16"]["ranks"][0]["split"]["launches"][kernel]
                             for arch, r in units["17s"]["archs"].items()
                             if r["bfloat16"]["ranks"][0]["split"]["launches"][kernel]}
        return {"launches": sum(by_arch.values()), "launches_by_arch": by_arch,
                "launches_per_train_step": per_train_step,
                "launches_per_split_train_step_a_rank": per_split_step,
                "launches_per_split_prefill_a_rank": per_split_prefill}

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
        "gqa": {k: t for k, t in flash["timings"].items() if isinstance(k, str)},
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
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"dryrun": dry}))
    print(smi_line())
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
