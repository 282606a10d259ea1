"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.

Llama-architecture (SwiGLU, RMSNorm, RoPE) [arXiv:2401.02954; hf].
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=172,
    vocab_size=256,
    subquadratic=False,
)

register(FULL, SMOKE, parallel_overrides={"fsdp": True, "microbatches": 8})
