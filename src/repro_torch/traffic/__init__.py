"""AICB-like LLM traffic model: analytic collective sizes + iteration
timeline, the JAX package's ``traffic`` (host-side Python; its users are
``netsim.workload.aicb_workload`` and ``launch.geo_training``)."""
from repro_torch.traffic.aicb import (
    IterationProfile, iteration_profile, period_slots, training_workload,
)
from repro_torch.traffic.patterns import StepTraffic, pp_stage_bytes, step_traffic

__all__ = [
    "IterationProfile", "iteration_profile", "period_slots",
    "training_workload", "StepTraffic", "pp_stage_bytes", "step_traffic",
]
