"""Basic layers: norms, rotary embeddings, MLPs, embedding/unembedding.

Each layer is an ``nn.Module`` holding its parameters under the names of the
JAX package's param dicts, with matrices in the ``[in, out]`` orientation of
its ``einsum("...d,de->...e")``. Mixed precision as there: parameters live in
``param_dtype``; norms and logits run in f32; matmuls run in the activation
dtype. ``reset_parameters(generator)`` draws the same distributions as the
JAX ``init_*`` functions (not the same numbers).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config.base import MLP_GELU, MLP_RELU2, MLP_SWIGLU, ModelConfig
from repro_torch.device import dtype_of
from repro_torch.parallel.tensor import (
    copy_to_model, gather_from_model, reduce_from_model, split_of, weight,
)


def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fills p with N(0, std^2) drawn on the generator's device."""
    draw = torch.randn(p.shape, generator=generator, device=generator.device,
                       dtype=torch.float32)
    with torch.no_grad():
        p.copy_(draw.mul_(std))      # in place: one f32 temporary, not two


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm / LayerNorm computed in f32, cast back to the input dtype."""

    def __init__(self, cfg: ModelConfig, dim: int = 0, device=None):
        super().__init__()
        d = dim or cfg.d_model
        pd = dtype_of(cfg.param_dtype)
        self.kind, self.eps = cfg.norm, cfg.norm_eps
        self.scale = nn.Parameter(torch.ones(d, dtype=pd, device=device))
        if cfg.norm == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=pd, device=device))
        else:
            self.bias = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.kind == "rmsnorm":
            var = xf.square().mean(dim=-1, keepdim=True)
            y = xf * torch.rsqrt(var + self.eps)
        else:
            mu = xf.mean(dim=-1, keepdim=True)
            var = (xf - mu).square().mean(dim=-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Causal conv state (SSD and RG-LRU blocks)
# ---------------------------------------------------------------------------

def conv_window(t: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width`` steps of t [B,S,Ch], left-padded with zeros when
    S < width (a causal conv's own padding), as a new tensor: the conv state
    that a prefill leaves for decode."""
    if t.shape[1] < width:
        t = F.pad(t, (0, 0, width - t.shape[1], 0))
    return t[:, t.shape[1] - width:].clone()


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies theta^(-i/half) as f32, computed in f64 and rounded
    once (within 1 ulp of the JAX package's f32 pow): the angles reach
    positions x freq, so a freq error of k ulps moves a late position's
    rotation by k ulps of its angle."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float64, device=device) / half
    return (1.0 / theta ** exponent).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE. x: [..., S, H, D]; positions: [..., S]."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                # [d/2]
    ang = positions[..., :, None].float() * freqs                # [..., S, d/2]
    cos = torch.cos(ang)[..., :, None, :]                        # [..., S, 1, d/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (w_gate, w_up, w_down) or a 2-matrix relu2 / gelu MLP.

    Split over "model" (``parallel.tensor``), d_ff is: w_gate and w_up are
    column-parallel, w_down row-parallel, its partial sums reduced."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        if kind not in (MLP_SWIGLU, MLP_RELU2, MLP_GELU):
            raise ValueError(f"unknown mlp kind {kind!r}")
        d, f = cfg.d_model, cfg.d_ff
        pd = dtype_of(cfg.param_dtype)
        self.kind = kind
        if kind == MLP_SWIGLU:
            self.w_gate = nn.Parameter(torch.empty(d, f, dtype=pd, device=device))
        self.w_up = nn.Parameter(torch.empty(d, f, dtype=pd, device=device))
        self.w_down = nn.Parameter(torch.empty(f, d, dtype=pd, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, f = self.w_down.shape[1], self.w_down.shape[0]
        if self.kind == MLP_SWIGLU:
            normal_(self.w_gate, d ** -0.5, generator)
        normal_(self.w_up, d ** -0.5, generator)
        normal_(self.w_down, f ** -0.5, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = split_of(self)
        x = copy_to_model(x, tp)
        w_up = weight(self, "w_up")
        if self.kind == MLP_SWIGLU:
            h = F.silu(x @ weight(self, "w_gate")) * (x @ w_up)
        elif self.kind == MLP_RELU2:
            h = F.relu(x @ w_up).square()
        else:
            h = F.gelu(x @ w_up, approximate="tanh")  # jax.nn.gelu's default
        return reduce_from_model(h @ weight(self, "w_down"), tp)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def as_f32(module: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32: the exact f32 copy of the module's ``name`` that the
    serve step installs in ``module.f32_copies`` while it runs
    (``serve.decode.ServeStep``), else a cast (the same values)."""
    copies = getattr(module, "f32_copies", None)
    return copies[name] if copies and name in copies else t.float()


LOGITS_BLOCK_BYTES = 1 << 30


class Embed(nn.Module):
    """Token table ``tok`` [V, d], only when ``embed_inputs``; ``unembed``
    [d, V] unless the model is tied and embeds its own tokens (the logits
    then read ``tok.T``). With ``embed_inputs=False`` the inputs are
    precomputed embeddings [..., d] (a stubbed frontend's EnCodec frames or
    ViT patches), cast to the activation dtype.

    Split over "model" (``vocab_shardable``), a rank holds a slice of the
    vocab: it looks up the ids it owns, zeros the others' rows and sums the
    rows over "model"; ``weight`` is its [d, V/M] slice, and ``logits`` and
    the loss (``models.model.chunked_ce_loss``) compute that slice's logits."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        pd = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.tok = (nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, dtype=pd,
                                             device=device))
                    if cfg.embed_inputs else None)
        self.unembed = (None if cfg.tie_embeddings and cfg.embed_inputs else
                        nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size, dtype=pd,
                                                 device=device)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.tok is not None:
            normal_(self.tok, 0.02, generator)
        if self.unembed is not None:
            normal_(self.unembed, self.cfg.d_model ** -0.5, generator)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """Token ids [...] -> their rows, or embeddings [..., d] as they are,
        in the activation dtype."""
        act = dtype_of(self.cfg.act_dtype)
        if self.tok is None:
            return inputs.to(act)
        tok, tp = weight(self, "tok"), split_of(self)
        if tp is None:
            return tok[inputs].to(act)
        off, n = tp.part(self.cfg.vocab_size)
        local = inputs - off
        own = (local >= 0) & (local < n)
        rows = tok[local.clamp(0, n - 1)] * own[..., None].to(tok.dtype)
        return reduce_from_model(rows, tp).to(act)

    def weight(self) -> torch.Tensor:
        """[d, V]: the tied table transposed, or the separate unembedding
        (split over "model", this rank's [d, V/M] slice of it)."""
        return weight(self, "tok").T if self.unembed is None else weight(self, "unembed")

    def weight_blocks(self) -> Tuple[int, list]:
        """(dim, blocks): ``weight()`` cut along ``dim`` into the blocks that
        ``logits`` casts to f32 one at a time, each at most
        ``LOGITS_BLOCK_BYTES`` in f32 (one block for a table that small;
        nemotron-4-340b's 18.9 GB takes 18). A block is a run of whole
        memory rows: of the vocab (dim 1) for the tied table's transpose, of
        d_model (dim 0) for a separate unembedding, whose f32 cast is then a
        dense copy."""
        w = self.weight()
        dim = 1 if w.stride(0) == 1 else 0
        n = max(1, LOGITS_BLOCK_BYTES // (4 * w.shape[1 - dim]))
        return dim, [w.narrow(dim, i, min(n, w.shape[dim] - i))
                     for i in range(0, w.shape[dim], n)]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Logits in f32 (loss-side numerics) of x [B, d]: against each block
        of the table in f32 (``weight_blocks``; a step holds one block's
        cast, not the whole table's), or against the exact f32 copies of
        those blocks that the serve step installs (``f32_copies["weight"]``):
        vocab blocks side by side, d_model blocks summed in order. Split
        over "model", each rank computes its slice of the vocab and the
        slices are gathered: every rank returns the whole [B, V]."""
        copies = getattr(self, "f32_copies", None)
        dim, blocks = self.weight_blocks()
        if copies and "weight" in copies:
            blocks = copies["weight"]
        xf = x.float()
        if len(blocks) == 1:
            logits = xf @ blocks[0].float()
        elif dim == 1:
            logits = torch.cat([xf @ w.float() for w in blocks], dim=-1)
        else:
            logits, i = None, 0
            for w in blocks:
                part = xf[:, i:i + w.shape[0]]
                logits = (part @ w.float() if logits is None
                          else torch.addmm(logits, part, w.float()))
                i += w.shape[0]
        logits = gather_from_model(logits, -1, split_of(self))
        c = self.cfg.logit_softcap
        if c > 0:
            logits = c * torch.tanh(logits / c)
        return logits
