"""Model configuration for the PyTorch port.

A copy of ``ModelConfig``, ``TrainConfig`` and the block-kind constants of
the JAX package's ``config/base.py``, kept here so that the port imports
nothing of that package. ``TrainConfig.ckpt_dir`` has no fixed default:
checkpoints go under the checkout's ``build/ckpt/``, not to a path that
other checkouts share. ``ParallelConfig`` is the JAX dataclass whole: the
traffic model (``repro_torch.traffic``) reads its mesh, pod and compression
fields; training on one device reads only ``remat``, ``microbatches`` and
``opt_state_dtype``, and the mesh the other fields plan for is not built.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# Block kinds understood by repro_torch.models.transformer
ATTN = "attn"            # global causal GQA attention
LOCAL_ATTN = "local_attn"  # sliding-window causal attention
SSD = "ssd"              # Mamba2 state-space duality block
RGLRU = "rglru"          # RecurrentGemma RG-LRU recurrent block

MLP_SWIGLU = "swiglu"
MLP_RELU2 = "relu2"      # squared-ReLU (Nemotron-4)
MLP_GELU = "gelu"
MLP_MOE = "moe"          # top-k mixture of experts (SwiGLU experts)
MLP_NONE = "none"        # block has no separate MLP (e.g. Mamba2)


@dataclass(frozen=True)
class ModelConfig:
    """Unified decoder-only LM configuration covering all assigned families."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attn-free)
    num_kv_heads: int                # KV heads (GQA); == num_heads for MHA
    d_ff: int
    vocab_size: int

    # Block pattern. If empty, every layer is (mixer=ATTN, mlp=default_mlp).
    # Otherwise a repeating pattern of (mixer_kind, mlp_kind) tuples.
    block_pattern: tuple = ()

    default_mlp: str = MLP_SWIGLU
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention details ---
    qkv_bias: bool = False           # Qwen1.5
    rope_theta: float = 10000.0
    local_window: int = 2048         # for LOCAL_ATTN blocks
    logit_softcap: float = 0.0       # 0 = disabled
    # --- normalization / misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    moe_group_by_batch: bool = False
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0               # N (state size per head)
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_headdim: int = 64
    ssm_conv: int = 4                # depthwise conv width
    ssm_chunk: int = 128             # SSD chunk length
    # --- RG-LRU (RecurrentGemma) ---
    rglru_width: int = 0
    rglru_conv: int = 4
    # K cache stored time-minor [B, Hk, hd, S]
    decode_k_time_minor: bool = False
    # --- modality frontend stub ---
    embed_inputs: bool = True        # False => inputs are precomputed embeddings
    # --- attention flavor for very long context ---
    subquadratic: bool = False       # True for ssm / hybrid (long_500k eligible)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    def layer_blocks(self) -> tuple:
        """Expand block_pattern to num_layers entries of (mixer, mlp)."""
        if not self.block_pattern:
            return tuple((ATTN, self.default_mlp) for _ in range(self.num_layers))
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                       # embedding
        if not self.tie_embeddings:
            total += v * d                  # unembedding
        hd = self.resolved_head_dim
        for mixer, mlp in self.layer_blocks():
            if mixer == ATTN or mixer == LOCAL_ATTN:
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                total += q + kv + o
                if self.qkv_bias:
                    total += (self.num_heads + 2 * self.num_kv_heads) * hd
            elif mixer == SSD:
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_headdim
                # in_proj: z,x,B,C,dt ; out_proj ; conv ; A,D,dt_bias, norm
                total += d * (2 * d_in + 2 * self.ssm_state + nheads)
                total += d_in * d
                total += self.ssm_conv * (d_in + 2 * self.ssm_state)
                total += 3 * nheads + d_in
            elif mixer == RGLRU:
                w = self.rglru_width or d
                # linear in (x,y branches), gates, out
                total += d * w * 2 + w * d + 3 * w + self.rglru_conv * w + 2 * w * (w // 8 if w >= 8 else w)
            # norms
            total += 2 * d
            if mlp == MLP_SWIGLU:
                total += 3 * d * self.d_ff
            elif mlp in (MLP_RELU2, MLP_GELU):
                total += 2 * d * self.d_ff
            elif mlp == MLP_MOE:
                total += d * self.num_experts  # router
                total += self.num_experts * 3 * d * self.d_ff
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        dense = self.param_count()
        n_moe_layers = sum(1 for _, m in self.layer_blocks() if m == MLP_MOE)
        per_expert = 3 * self.d_model * self.d_ff
        inactive = n_moe_layers * (self.num_experts - self.num_experts_per_tok) * per_expert
        return dense - inactive


# ---------------------------------------------------------------------------
# Parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout + sharding strategy."""

    multi_pod: bool = False
    pods: int = 2
    data: int = 16
    model: int = 16

    fsdp: bool = False            # additionally shard params/opt-state over data axis
    remat: str = "block"          # none | block | dots; any other string means block
    scan_layers: bool = True
    microbatches: int = 1         # gradient accumulation
    # pod-axis (inter-DC) optimizations: the MatchRDMA-motivated features
    hierarchical_allreduce: bool = True
    pod_compression: str = "none"  # none | int8
    # decode layout
    shard_cache_seq: bool = True   # shard KV-cache sequence dim over model axis
    flash_decode: bool = False     # explicit partial-softmax decode
    # optimizer state dtype (bf16 for the 340B config)
    opt_state_dtype: str = "float32"

    def axis_names(self) -> tuple:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    def mesh_shape(self) -> tuple:
        if self.multi_pod:
            return (self.pods, self.data, self.model)
        return (self.data, self.model)

    def batch_axes(self) -> tuple:
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def num_devices(self) -> int:
        n = self.data * self.model
        return n * self.pods if self.multi_pod else n


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    # checkpointing / fault tolerance
    ckpt_dir: Optional[str] = None  # None: build/ckpt/<model name> in the checkout
    ckpt_every: int = 100
    ckpt_keep: int = 3
    ckpt_async: bool = True
    # straggler mitigation (simulated policy knobs)
    step_deadline_ms: float = 0.0   # 0 = disabled
    max_restarts: int = 3
