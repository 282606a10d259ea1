"""AICB-like iteration traffic model: turn an architecture's training step
into the netsim workload (the alternating computation-communication structure
of LLM training iterations, ref [18]).

The inter-DC traffic of one geo-distributed training step (pod axis = DC
boundary) is the hierarchical gradient exchange: ``inter_pod_bytes`` moved
during a comm phase at the end of each iteration (or overlapped with the
backward pass — ``overlap_frac`` stretches the comm phase accordingly).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config.base import ModelConfig, ParallelConfig, TrainConfig
from repro_torch.config.net import NetConfig
from repro_torch.netsim.workload import FlowSpec, Workload
from repro_torch.traffic.patterns import step_traffic


@dataclass(frozen=True)
class IterationProfile:
    iter_us: float              # full iteration period
    comm_us: float              # inter-DC communication phase duration
    comm_bytes: float           # bytes crossing the OTN per iteration
    num_flows: int              # parallel QPs carrying the exchange
    msg_size: float             # bytes per message (collective chunk)
    concurrency: int            # in-flight messages per flow


def iteration_profile(model: ModelConfig, par: ParallelConfig,
                      train: TrainConfig, *, num_flows: int = 16,
                      msg_size: float = 4 << 20, concurrency: int = 16,
                      overlap_frac: float = 0.0) -> IterationProfile:
    t = step_traffic(model, par, train)
    iter_us = t.iter_time_estimate_s * 1e6
    otn_bw = 16 * 100e9 / 8.0
    comm_us = t.inter_pod_bytes / otn_bw * 1e6
    if overlap_frac > 0:
        # overlapped exchange is spread across the backward pass
        comm_us = max(comm_us, overlap_frac * iter_us)
    return IterationProfile(
        iter_us=iter_us + comm_us * (1.0 - overlap_frac),
        comm_us=comm_us,
        comm_bytes=t.inter_pod_bytes,
        num_flows=num_flows,
        msg_size=msg_size,
        concurrency=concurrency,
    )


def training_workload(model: ModelConfig, par: ParallelConfig,
                      train: TrainConfig, *, num_flows: int = 16,
                      msg_size: float = 4 << 20, concurrency: int = 16,
                      with_intra: int = 8) -> Workload:
    """netsim workload for geo-distributed training of this architecture."""
    prof = iteration_profile(model, par, train, num_flows=num_flows,
                             msg_size=msg_size, concurrency=concurrency)
    duty = min(prof.comm_us / max(prof.iter_us, 1.0), 1.0)
    flows = [FlowSpec(True, msg_size, concurrency,
                      period_us=prof.iter_us, duty=duty)
             for _ in range(num_flows)]
    flows += [FlowSpec(False, 256 << 10, 8) for _ in range(with_intra)]
    return Workload(tuple(flows))


def period_slots(prof: IterationProfile, net: NetConfig) -> int:
    """Iteration period in estimator slots (for the periodic predictor)."""
    return max(int(round(prof.iter_us / net.slot_us)), 1)
