"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.

RG-LRU + local attention, pattern (recurrent, recurrent, local_attn) = 1:2
[arXiv:2402.19427; hf]. Griffin architecture: rglru width = 2560, local
window 2048, SwiGLU MLP (the block pattern's, whatever Griffin's GeGLU),
logit softcap. O(1)+window decode state. A copy of the JAX package's
``configs/recurrentgemma_2b.py``.
"""
from repro_torch.config.base import LOCAL_ATTN, MLP_SWIGLU, RGLRU, ModelConfig
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    # Griffin 1:2 pattern — two RG-LRU blocks then one local-attention block
    block_pattern=((RGLRU, MLP_SWIGLU), (RGLRU, MLP_SWIGLU), (LOCAL_ATTN, MLP_SWIGLU)),
    rglru_width=2560,
    rglru_conv=4,
    local_window=2048,
    head_dim=256,
    logit_softcap=30.0,
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    family="hybrid",
    num_layers=3,
    d_model=64,
    num_heads=2,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=256,
    block_pattern=((RGLRU, MLP_SWIGLU), (RGLRU, MLP_SWIGLU), (LOCAL_ATTN, MLP_SWIGLU)),
    rglru_width=64,
    rglru_conv=4,
    local_window=16,
    head_dim=32,
    logit_softcap=30.0,
    tie_embeddings=True,
    subquadratic=True,
)

register(FULL, SMOKE)
