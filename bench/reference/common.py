"""What the plain references of every family share: matmuls in float32 (or
the control's fp8), RMSNorm, rotary embeddings, the tied unembedding and its
cross-entropy, the decoder loop, and AdamW.

Plain PyTorch only. Nothing here imports the program under test, JAX or the
JAX package; the parameters are a name -> tensor dict that the benchmark made
from the seed (``bench.weights``), read by name. Every matmul runs in float32
with TF32 off (``no_tf32``), so the reference is the configuration's
mathematics, not a lower precision of it.

The control (``prec="fp8"``) is the same reference computed in FP8 as FP8
training runs a bf16 model, the precision a later change would be tempted
to use: every weight matmul takes its inputs rounded to float8 e4m3 under
one scale per tensor (amax to 448), and its backward takes the incoming
gradient rounded to e5m2 (amax to 57344) against those rounded inputs.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
PRECISIONS = ("f32", "fp8")
E4M3, E5M2 = (torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0)
LOSS_CHUNK = 512           # positions of the logits alive at once in the loss


def no_tf32() -> None:
    """float32 matmuls and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor, fmt: Tuple[torch.dtype, float]) -> torch.Tensor:
    """``t`` (float32) rounded to the FP8 format ``fmt`` under one scale for
    the tensor, its largest magnitude going to the format's largest."""
    dtype, top = fmt
    scale = t.abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Fp8Linear(torch.autograd.Function):
    """x @ w on e4m3 inputs; the backward's products on the e5m2 gradient."""

    @staticmethod
    def forward(ctx, x, w):
        qx, qw = fp8(x, E4M3), fp8(w, E4M3)
        ctx.save_for_backward(qx, qw)
        return qx @ qw

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = fp8(g, E5M2)
        gx = qg @ qw.T if ctx.needs_input_grad[0] else None
        gw = (qx.reshape(-1, qx.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x [..., d] @ w [d, e] in float32, or with ``prec="fp8"`` as the control."""
    if prec == "f32":
        return x.float() @ w.float()
    if prec != "fp8":
        raise ValueError(f"unknown precision {prec!r}; expected one of {PRECISIONS}")
    return _Fp8Linear.apply(x.float(), w.float())


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of the split-half (GPT-NeoX) form. x [B, S, H, D],
    positions [S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = (positions.double()[:, None] * freqs).float()          # [S, half]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# A block: (cfg, params, layer, x [B, S, d] f32, prec, groups) -> (x, aux dict).
# ``groups`` lists the position ranges [a, b) whose tokens (all rows) an MoE
# routes together, each under its own capacity.
Block = Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def hidden(block: Block, cfg: dict, params: Params, tokens: torch.Tensor, prec: str,
           groups: Sequence[Tuple[int, int]], remat: bool) -> Tuple[torch.Tensor, dict]:
    """The final-normed hidden states [B, S, d] f32 and the aux terms summed
    over the layers. With ``remat`` each layer is recomputed in the backward,
    so that one layer's activations are alive at a time."""
    x = params["embed.tok"][tokens].float()
    aux: Dict[str, torch.Tensor] = {}
    for i in range(cfg["num_layers"]):
        def one(x, i=i):
            return block(cfg, params, i, x, prec, groups)
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(one, x, use_reentrant=False)
        else:
            x, a = one(x)
        for k, v in a.items():
            aux[k] = aux.get(k, 0.0) + v
    return rmsnorm(x, params["backbone.final_norm.scale"], cfg["norm_eps"]), aux


def unembed(h: torch.Tensor, params: Params, prec: str) -> torch.Tensor:
    """Logits f32 [..., V] against the tied table."""
    return linear(h, params["embed.tok"].T, prec)


def _ce_chunk(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor, prec: str
              ) -> torch.Tensor:
    logits = linear(h, table.T, prec)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                           reduction="sum")


def loss(block: Block, cfg: dict, params: Params, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32") -> Tuple[torch.Tensor, dict]:
    """Mean next-token cross-entropy over every label, plus the MoE aux
    terms where the configuration has experts; (loss, its parts)."""
    h, aux = hidden(block, cfg, params, tokens, prec, [(0, tokens.shape[1])], remat=True)
    total = torch.zeros((), device=h.device)
    for a in range(0, h.shape[1], LOSS_CHUNK):
        total = total + checkpoint(_ce_chunk, h[:, a:a + LOSS_CHUNK], params["embed.tok"],
                                   labels[:, a:a + LOSS_CHUNK], prec, use_reentrant=False)
    ce = total / labels.numel()
    out = ce
    if cfg.get("num_experts"):
        out = out + cfg["router_aux_loss"] * aux["lb"] + cfg["router_z_loss"] * aux["z"]
    return out, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# AdamW, as the mix states it
# ---------------------------------------------------------------------------

def lr_at(mix: dict, step: int) -> float:
    """Linear warmup, then cosine decay to a tenth (step counts from 1)."""
    warm = min(step / max(mix["warmup_steps"], 1), 1.0)
    span = max(mix["total_steps"] - mix["warmup_steps"], 1)
    prog = min(max((step - mix["warmup_steps"]) / span, 0.0), 1.0)
    return mix["lr"] * warm * (0.1 + 0.45 * (1.0 + math.cos(math.pi * prog)))


def train_steps(block: Block, cfg: dict, stored: Params, batches: List[Tuple[torch.Tensor,
                torch.Tensor]], mix: dict, prec: str = "f32") -> dict:
    """AdamW steps on ``batches`` from the parameters ``stored`` (each kept in
    its storage dtype, as the configuration states, and updated in place),
    the gradients, moments and arithmetic in float32. Returns the losses,
    each leaf's norm of the first step's gradient before and after the clip,
    and each leaf's norm of its change over all the steps."""
    start = {k: v.clone() for k, v in stored.items()}
    m = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device) for k, v in stored.items()}
    v2 = {k: torch.zeros_like(t) for k, t in m.items()}
    b1, b2, eps, wd = mix["beta1"], mix["beta2"], mix["eps"], mix["weight_decay"]
    out = {"loss": [], "grad_raw": None, "grad": None}
    names = list(stored)
    for step, (tokens, labels) in enumerate(batches, start=1):
        leaves = [stored[k].float().requires_grad_(True) for k in names]
        value, _ = loss(block, cfg, dict(zip(names, leaves)), tokens, labels, prec)
        grads = torch.autograd.grad(value, leaves)
        del leaves
        out["loss"].append(float(value.detach()))
        norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads))
        scale = min(mix["grad_clip"] / max(float(norm), 1e-9), 1.0)
        if step == 1:
            out["grad_raw"] = {k: float(g.norm()) for k, g in zip(names, grads)}
            out["grad"] = {k: float(g.norm()) * scale for k, g in zip(names, grads)}
        lr = lr_at(mix, step)
        c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        with torch.no_grad():
            for k, g in zip(names, grads):
                g = g * scale
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).add_(g.square(), alpha=1 - b2)
                p = stored[k].float()
                upd = (m[k] / c1) / ((v2[k] / c2).sqrt() + eps) + wd * p
                stored[k].copy_(p - lr * upd)
        del grads
    with torch.no_grad():
        out["change"] = {k: float((stored[k].float() - start[k].float()).norm()) for k in names}
    return out


def served_logits(block: Block, cfg: dict, params: Params, tokens: torch.Tensor,
                  prompt_len: int, prec: str = "f32") -> torch.Tensor:
    """The logits [B, N, V] f32 that predict each served token: one forward
    over the prompt and the served tokens fed back (``tokens`` [B, P + N - 1]),
    read at positions P - 1 .. P + N - 2. An MoE routes the prompt's tokens
    of every row together, as one prefill call, and each later position's
    rows together, as one decode step."""
    s = tokens.shape[1]
    groups = [(0, prompt_len)] + [(t, t + 1) for t in range(prompt_len, s)]
    with torch.no_grad():
        h, _ = hidden(block, cfg, params, tokens, prec, groups, remat=False)
        return unembed(h[:, prompt_len - 1:], params, prec)
