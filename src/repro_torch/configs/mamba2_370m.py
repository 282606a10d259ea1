"""mamba2-370m [ssm]: 48L d_model=1024 (attn-free) vocab=50280, ssm_state=128.

SSD (state-space duality) [arXiv:2405.21060]. d_inner = 2*d_model = 2048,
headdim 64 -> 32 SSD heads. O(1) decode state => long_500k eligible.
"""
from repro_torch.config.base import MLP_NONE, SSD, ModelConfig
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    block_pattern=((SSD, MLP_NONE),),
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    block_pattern=((SSD, MLP_NONE),),
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=32,
    ssm_conv=4,
    ssm_chunk=32,
    tie_embeddings=True,
    subquadratic=True,
)

register(FULL, SMOKE)
