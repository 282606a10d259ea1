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
               ``TRACE_MODES`` = full / decimate / metrics / window; CUDA
               graphs on the card) and its differentiable mode
               (``soft_step``: ``soft``'s tempered gates, autograd through
               ``run_traced_batch``).
  * grad_tune - Adam through the soft engine (``tune``), scored on the
               hard engine.
  * obs      - observability: event rings (``EVENT_KINDS``, ``EventRing``,
               ``decode_events``, ``unroll_window``), Perfetto timelines
               (``export_timeline``, ``timeline_from_window``,
               ``timeline_from_traces``) and JSONL run manifests
               (``write_manifest``, ``read_manifest``).
  * runner   - metric extraction + grid sweeps (``Scenario``, ``sweep``,
               ``sweep_grid``, ``run_experiment_batch``), hardened: strict
               conservation (``ConservationError``), a finite guard,
               per-launch checkpoints with resume, OOM backoff, and run
               manifests (``manifest_path``).
  * workload - flow sets (``Workload``, ``aicb_workload``) and their batch
               form (``WorkloadParams``).
  * convert  - the JAX package's state, as numpy, into the port's.

Multi-device runs: the runner's ``devices=`` pads each launch to a multiple
of the devices and runs each device's equal share of its cells, one device
after another from the calling thread (``runner._run_launch``); the rows
come back in cell order.
"""
from repro_torch.netsim.channel import (
    CHANNEL_MODELS, ChannelModel, available_channel_models,
    get_channel_model, register_channel_model,
)
from repro_torch.netsim.failures import (
    FailureSchedule, load_failure_json, save_failure_json,
)
from repro_torch.netsim.fluid import (
    TRACE_MODES, MetricAcc, SimState, WindowAux, batch_padding, simulate,
    simulate_batch,
)
from repro_torch.netsim.obs import (
    EVENT_KINDS, EventRing, decode_events, event_count, export_timeline,
    read_manifest, timeline_from_traces, timeline_from_window, unroll_window,
    write_manifest,
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
    BIG, FlowSpec, Workload, WorkloadParams, aicb_workload, congestion_workload,
    mixed_fct_workload, stack_workload_params, throughput_workload,
)

__all__ = [
    "ALL_SCHEMES", "BIG", "CHANNEL_MODELS", "ChannelModel", "EVENT_KINDS",
    "EventRing", "FailureSchedule", "FlowSpec", "MetricAcc", "RELATED_SCHEMES",
    "SCHEMES", "Scenario", "Scheme", "SimState", "SiteEdge", "SiteGraph",
    "TRACE_MODES", "WindowAux", "Workload", "WorkloadParams", "aicb_workload",
    "compile_site_graph", "decode_events", "event_count", "export_timeline",
    "read_manifest", "timeline_from_traces", "timeline_from_window",
    "unroll_window", "write_manifest",
    "validate_site_endpoints", "available_channel_models",
    "available_schemes", "batch_padding", "chunk_cells",
    "get_channel_model", "load_failure_json", "register_channel_model",
    "save_failure_json",
    "congestion_workload", "convergence_horizon_us", "get_scheme",
    "hist_quantile", "mixed_fct_workload", "register_scheme",
    "run_experiment", "run_experiment_batch", "simulate", "simulate_batch",
    "stack_workload_params", "sweep", "sweep_grid", "throughput_workload",
]
