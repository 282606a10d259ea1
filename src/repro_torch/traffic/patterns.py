"""Analytic collective-size math for LLM training communication.

Given a ModelConfig + ParallelConfig + TrainConfig, derive the bytes each
parallelism dimension moves per training step — the same quantities the
AICB benchmark measures empirically. These sizes parameterize the
netsim workload (message sizes / concurrency of inter-DC flows). A copy of
the JAX package's ``traffic/patterns.py``: host-side Python over floats,
so the two give the same numbers bit for bit.

Conventions: bf16 gradients/activations (2 bytes), ring-allreduce cost
2·(n-1)/n ≈ 2 per element unless hierarchical.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config.base import ModelConfig, ParallelConfig, TrainConfig

BYTES_GRAD = 2  # bf16


@dataclass(frozen=True)
class StepTraffic:
    """Bytes moved per training step, by class."""
    dp_grad_bytes: float          # data-parallel gradient reduction (per replica)
    inter_pod_bytes: float        # bytes that must cross the pod (inter-DC) axis
    tp_activation_bytes: float    # tensor-parallel all-reduce bytes (per device)
    ep_alltoall_bytes: float      # expert-parallel dispatch bytes (per device)
    compute_flops: float          # model FLOPs per step (6·N_active·D)
    iter_time_estimate_s: float   # compute-bound iteration estimate
    comm_frac: float              # fraction of iter spent in exposed inter-DC comm


def step_traffic(model: ModelConfig, par: ParallelConfig, train: TrainConfig,
                 chip_flops: float = 197e12, mfu: float = 0.4) -> StepTraffic:
    p = model.param_count()
    p_active = model.active_param_count()
    d = model.d_model
    tokens = train.global_batch * train.seq_len

    # --- DP gradient reduction ---
    # ring all-reduce over the data axis: 2·P bytes per replica
    dp_bytes = 2.0 * p * BYTES_GRAD

    # --- inter-pod (inter-DC) bytes ---
    if par.multi_pod:
        if par.hierarchical_allreduce:
            # reduce-scatter intra-pod first: each chip holds P/(data·model)
            # shard; the pod-axis exchange moves 2·P/(data·model) per chip,
            # i.e. 2·P per POD in aggregate across the OTN.
            inter_pod = 2.0 * p * BYTES_GRAD
        else:
            # flat all-reduce across pods: every chip's full gradient crosses
            inter_pod = 2.0 * p * BYTES_GRAD * par.data * par.model
        if par.pod_compression == "int8":
            inter_pod *= 0.5
    else:
        inter_pod = 0.0

    # --- TP activation all-reduces: 2 per block (attn out + mlp out), fwd+bwd
    per_device_tokens = tokens / max(par.data * (par.pods if par.multi_pod else 1), 1)
    tp_bytes = (4.0 * model.num_layers * per_device_tokens * d * BYTES_GRAD
                if par.model > 1 else 0.0)

    # --- EP all-to-all (kept intra-pod by design) ---
    if model.num_experts:
        n_moe = sum(1 for _, m in model.layer_blocks() if m == "moe")
        # dispatch + combine, fwd + bwd: 4 transfers of k·tokens·d
        ep_bytes = (4.0 * n_moe * per_device_tokens
                    * model.num_experts_per_tok * d * BYTES_GRAD)
    else:
        ep_bytes = 0.0

    flops = 6.0 * p_active * tokens
    chips = par.num_devices
    iter_time = flops / (chips * chip_flops * mfu)

    # exposed inter-DC time on 16x100G OTN if not overlapped
    otn_bw = 16 * 100e9 / 8.0
    inter_time = inter_pod / otn_bw
    comm_frac = inter_time / max(iter_time + inter_time, 1e-9)

    return StepTraffic(
        dp_grad_bytes=dp_bytes,
        inter_pod_bytes=inter_pod,
        tp_activation_bytes=tp_bytes,
        ep_alltoall_bytes=ep_bytes,
        compute_flops=flops,
        iter_time_estimate_s=iter_time,
        comm_frac=comm_frac,
    )


def pp_stage_bytes(model: ModelConfig, train: TrainConfig,
                   microbatches: int) -> float:
    """Pipeline-parallel activation transfer per stage boundary per step
    (fwd activation + bwd gradient per microbatch)."""
    micro_tokens = train.global_batch * train.seq_len / max(microbatches, 1)
    return 2.0 * microbatches * micro_tokens * model.d_model * BYTES_GRAD
