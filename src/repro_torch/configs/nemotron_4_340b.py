"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.

GQA, squared-ReLU MLP [arXiv:2402.16819]. The heaviest assigned cell:
its production layout keeps the optimizer states in bf16 and shards them
with FSDP.
"""
from repro_torch.config.base import ModelConfig, MLP_RELU2
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    default_mlp=MLP_RELU2,
    norm="layernorm",
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="nemotron-4-340b-smoke",
    family="dense",
    num_layers=2,
    d_model=96,
    num_heads=6,
    num_kv_heads=2,
    d_ff=384,
    vocab_size=256,
    default_mlp=MLP_RELU2,
    norm="layernorm",
    subquadratic=False,
)

register(FULL, SMOKE, parallel_overrides={"fsdp": True,
                                          "opt_state_dtype": "bfloat16",
                                          "microbatches": 8})
