"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.

QKV bias, SwiGLU, RMSNorm, tied embeddings [hf:Qwen/Qwen1.5-0.5B].
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="qwen1.5-0.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=160,
    vocab_size=256,
    qkv_bias=True,
    tie_embeddings=True,
    subquadratic=False,
)

register(FULL, SMOKE)
