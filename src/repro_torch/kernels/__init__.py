"""Hand-written Hopper kernels of the port, their wrappers and plain versions.

Kernel sources live in ``csrc/`` and are built by ``build`` at first use;
importing this package builds and loads nothing.
"""
from repro_torch.kernels.ops import flash_attention, ssd_scan

__all__ = ["flash_attention", "ssd_scan"]
