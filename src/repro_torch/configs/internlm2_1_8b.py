"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.

GQA, SwiGLU, RMSNorm [arXiv:2403.17297; hf].
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="internlm2-1.8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    subquadratic=False,
)

register(FULL, SMOKE)
