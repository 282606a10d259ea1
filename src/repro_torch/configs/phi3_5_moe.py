"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].
"""
from repro_torch.config.base import ModelConfig, MLP_MOE
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    default_mlp=MLP_MOE,
    norm="layernorm",
    num_experts=16,
    num_experts_per_tok=2,
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    default_mlp=MLP_MOE,
    norm="layernorm",
    num_experts=4,
    num_experts_per_tok=2,
    subquadratic=False,
)

register(FULL, SMOKE, parallel_overrides={"fsdp": True, "microbatches": 4})
