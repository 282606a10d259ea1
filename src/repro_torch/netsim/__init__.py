"""The fluid long-haul simulator of the dual AI-DC leaf-spine-OTN path, in
PyTorch: the JAX package's ``netsim`` on the ideal channel.

  * schemes  - the registry, the paper's four schemes (``SCHEMES`` =
               dcqcn / pseudo_ack / themis / matchrdma) and the related-work
               pack (``RELATED_SCHEMES`` = geopipe / sdr_rdma / rdmacell);
               ``ALL_SCHEMES`` is both.
  * topology - site graphs (``SiteGraph``, ``SiteEdge``,
               ``compile_site_graph``) compiled onto the ``[L]`` link axis.
  * fluid    - the scheme-agnostic engine (``simulate``, ``simulate_batch``;
               ``TRACE_MODES`` = full / decimate / metrics; CUDA graphs on
               the card).
  * runner   - metric extraction + grid sweeps (``Scenario``, ``sweep``,
               ``sweep_grid``, ``run_experiment_batch``).
  * workload - flow sets (``Workload``) and their batch form
               (``WorkloadParams``).
  * convert  - the JAX package's state, as numpy, into the port's.

Only the ideal channel (on one link, ``num_paths`` links or a site graph),
no failure schedule and the hard step are ported; the rest raises
``NotImplementedError`` naming the ROADMAP item that brings it.
"""
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
    "ALL_SCHEMES", "BIG", "FlowSpec", "MetricAcc", "RELATED_SCHEMES",
    "SCHEMES", "Scenario", "Scheme", "SimState", "SiteEdge", "SiteGraph",
    "TRACE_MODES", "Workload", "WorkloadParams", "compile_site_graph",
    "validate_site_endpoints",
    "available_schemes", "batch_padding", "chunk_cells",
    "congestion_workload", "convergence_horizon_us", "get_scheme",
    "hist_quantile", "mixed_fct_workload", "register_scheme",
    "run_experiment", "run_experiment_batch", "simulate", "simulate_batch",
    "stack_workload_params", "sweep", "sweep_grid", "throughput_workload",
]
