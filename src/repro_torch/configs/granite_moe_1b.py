"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from repro_torch.config.base import ModelConfig, MLP_MOE
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    default_mlp=MLP_MOE,
    num_experts=32,
    num_experts_per_tok=8,
    tie_embeddings=True,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=64,
    vocab_size=256,
    default_mlp=MLP_MOE,
    num_experts=8,
    num_experts_per_tok=4,
    tie_embeddings=True,
    subquadratic=False,
)

register(FULL, SMOKE)
