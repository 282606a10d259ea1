"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only transformer over EnCodec tokens [arXiv:2306.05284; hf].
MusicGen uses a GPT-style decoder: LayerNorm + GELU MLP, MHA (kv == q heads).
The EnCodec frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (B, S, d_model); the backbone predicts codebook tokens (vocab 2048).
"""
from repro_torch.config.base import ModelConfig, MLP_GELU
from repro_torch.config.registry import register

FULL = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    default_mlp=MLP_GELU,
    norm="layernorm",
    embed_inputs=False,     # frame embeddings come from the (stubbed) EnCodec frontend
    subquadratic=False,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    default_mlp=MLP_GELU,
    norm="layernorm",
    embed_inputs=False,
    subquadratic=False,
)

register(FULL, SMOKE)
