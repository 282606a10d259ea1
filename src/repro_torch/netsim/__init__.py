"""The fluid long-haul simulator of the dual AI-DC leaf-spine-OTN path, in
PyTorch: the JAX package's ``netsim``.

  * schemes  - the registry, the paper's four schemes (``SCHEMES`` =
               dcqcn / pseudo_ack / themis / matchrdma) and the related-work
               pack (``RELATED_SCHEMES`` = geopipe / sdr_rdma / rdmacell);
               ``ALL_SCHEMES`` is both.
  * channel  - registry-backed long-haul channel models (``ChannelModel``,
               ``register_channel_model``, ``get_channel_model``;
               ``CHANNEL_MODELS`` = ideal / bernoulli_loss / jitter /
               otn_flap / impaired / trace_replay), their draws bit-equal to
               ``jax.random`` (``prng``).
  * failures - hard link and site outage timelines (``FailureSchedule`` and
               its JSON I/O).
  * topology - site graphs (``SiteGraph``, ``SiteEdge``,
               ``compile_site_graph``) compiled onto the ``[L]`` link axis.
  * fluid    - the scheme-agnostic engine (``simulate``, ``simulate_batch``;
               ``TRACE_MODES`` = full / decimate / metrics; CUDA graphs on
               the card).
  * runner   - metric extraction + grid sweeps (``Scenario``, ``sweep``,
               ``sweep_grid``, ``run_experiment_batch``), hardened: strict
               conservation (``ConservationError``), a finite guard,
               per-launch checkpoints with resume, OOM backoff.
  * workload - flow sets (``Workload``) and their batch form
               (``WorkloadParams``).
  * convert  - the JAX package's state, as numpy, into the port's.

``soft_step``, ``window`` mode, run manifests and multi-device sharding
raise ``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from repro_torch.netsim.channel import (
    CHANNEL_MODELS, ChannelModel, available_channel_models,
    get_channel_model, register_channel_model,
)
from repro_torch.netsim.failures import (
    FailureSchedule, load_failure_json, save_failure_json,
)
from repro_torch.netsim.fluid import (
    TRACE_MODES, MetricAcc, SimState, batch_padding, simulate, simulate_batch,
)
from repro_torch.netsim.runner import (
    Scenario, chunk_cells, convergence_horizon_us, run_experiment,
    run_experiment_batch, sweep, sweep_grid,
)
from repro_torch.netsim.schemes import (
    ALL_SCHEMES, RELATED_SCHEMES, SCHEMES, Scheme, available_schemes,
    get_scheme, register_scheme,
)
from repro_torch.netsim.streaming import hist_quantile
from repro_torch.netsim.topology import (
    SiteEdge, SiteGraph, compile_site_graph, validate_site_endpoints,
)
from repro_torch.netsim.workload import (
    BIG, FlowSpec, Workload, WorkloadParams, congestion_workload,
    mixed_fct_workload, stack_workload_params, throughput_workload,
)

__all__ = [
    "ALL_SCHEMES", "BIG", "CHANNEL_MODELS", "ChannelModel",
    "FailureSchedule", "FlowSpec", "MetricAcc", "RELATED_SCHEMES",
    "SCHEMES", "Scenario", "Scheme", "SimState", "SiteEdge", "SiteGraph",
    "TRACE_MODES", "Workload", "WorkloadParams", "compile_site_graph",
    "validate_site_endpoints", "available_channel_models",
    "available_schemes", "batch_padding", "chunk_cells",
    "get_channel_model", "load_failure_json", "register_channel_model",
    "save_failure_json",
    "congestion_workload", "convergence_horizon_us", "get_scheme",
    "hist_quantile", "mixed_fct_workload", "register_scheme",
    "run_experiment", "run_experiment_batch", "simulate", "simulate_batch",
    "stack_workload_params", "sweep", "sweep_grid", "throughput_workload",
]
