"""internvl2-2b [vlm]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.

InternViT + InternLM2 [arXiv:2404.16821; hf]. This entry specifies the LM
BACKBONE (internlm2-1.8b-shaped, vocab 92553 incl. image tokens). The ViT
frontend is a STUB: ``input_specs()`` provides precomputed patch embeddings
(B, S, d_model) already projected into the LM space.
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1_000_000.0,
    embed_inputs=False,    # patch/frame embeddings from the stubbed ViT frontend
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="internvl2-2b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    embed_inputs=False,
    subquadratic=False,
)

register(FULL, SMOKE)
