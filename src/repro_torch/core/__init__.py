"""The paper's controller, MatchRDMA's segmented rate-matched control, in
PyTorch (the hard paths of the JAX package's ``core``).

  reservoir.py  - Eq. (1) buffer-requirement model
  slots.py      - destination-OTN slot-level observations
  estimator.py  - slot-weighted rate estimation
  budget.py     - rate-budget generation + inter-OTN control subchannel
  pseudo_ack.py - source-OTN budget-gated pseudo-ACK
  cc_proxy.py   - DCQCN machine (sender / THEMIS variants)
  matchrdma.py  - the composed three-segment controller

Every function is shape-agnostic over leading scenario axes: per-scenario
scalars are 0-d for one scenario and ``[B]`` for a batch; per-flow tensors
``[..., F]``, slot rings ``[..., R]``.

The soft-step helpers these modules use live in ``repro_torch.netsim.soft``,
as the JAX package places them, and the netsim engine imports this package:
importing the netsim package first lets each side load in that order, from
whichever end an import starts.
"""
import repro_torch.netsim  # noqa: F401  (load order; see above)
from repro_torch.core.budget import BudgetState, fair_share, init_budget, update_budget
from repro_torch.core.cc_proxy import (
    DcqcnState, init_dcqcn, step_dcqcn, themis_rtt_scale,
)
from repro_torch.core.estimator import (
    RateEstimate, periodic_estimate, slot_weighted_estimate,
)
from repro_torch.core.matchrdma import (
    MatchRdmaState, accumulate_step, init_matchrdma, maybe_slot_update,
    slot_update, step_channel,
)
from repro_torch.core.pseudo_ack import PseudoAckState, init_pseudo_ack, step_pseudo_ack
from repro_torch.core.reservoir import (
    buffer_bound_e2e_vs_segmented, control_uncertainty_window_us,
    queue_trajectory, rate_mismatch_integral, required_buffer,
)
from repro_torch.core.slots import SlotObs, SlotRing, classify_slot, init_ring, push_slot

__all__ = [
    "BudgetState", "fair_share", "init_budget", "update_budget",
    "DcqcnState", "init_dcqcn", "step_dcqcn", "themis_rtt_scale",
    "RateEstimate", "periodic_estimate", "slot_weighted_estimate",
    "MatchRdmaState", "accumulate_step", "init_matchrdma", "maybe_slot_update",
    "slot_update", "step_channel",
    "PseudoAckState", "init_pseudo_ack", "step_pseudo_ack",
    "buffer_bound_e2e_vs_segmented", "control_uncertainty_window_us",
    "queue_trajectory", "rate_mismatch_integral", "required_buffer",
    "SlotObs", "SlotRing", "classify_slot", "init_ring", "push_slot",
]
