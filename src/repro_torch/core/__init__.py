"""The paper's controller, MatchRDMA's segmented rate-matched control, in
PyTorch (the hard paths of the JAX package's ``core``; ``reservoir.py``, the
Eq. (1) buffer model, is not on the Fig. 3 path and is not ported).

  slots.py      - destination-OTN slot-level observations
  estimator.py  - slot-weighted rate estimation
  budget.py     - rate-budget generation + inter-OTN control subchannel
  pseudo_ack.py - source-OTN budget-gated pseudo-ACK
  cc_proxy.py   - DCQCN machine (sender / THEMIS variants)
  matchrdma.py  - the composed three-segment controller

Every function is shape-agnostic over leading scenario axes: per-scenario
scalars are 0-d for one scenario and ``[B]`` for a batch; per-flow tensors
``[..., F]``, slot rings ``[..., R]``.
"""
