"""PyTorch / CUDA port of the repro model substrate, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing of
it. Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
and every kernel wrapper takes its plain PyTorch version only for CPU tensors.
"""
