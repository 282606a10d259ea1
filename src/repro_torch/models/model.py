"""Public model API: build_model(cfg, device=) -> Model(loss_fn, prefill,
decode_step, init_cache).

Input conventions, as in the JAX package: ``embed_inputs=True`` takes token
ids, ``batch["tokens"]`` [B, S] (int64); ``embed_inputs=False`` takes
precomputed embeddings, ``batch["embeds"]`` [B, S, d_model] (a stubbed
frontend's EnCodec frames or ViT patches), cast to the activation dtype.
``batch["labels"]`` [B, S], -1 = masked. With experts (``num_experts``) the
loss adds ``router_aux_loss * moe_lb_loss + 1e-3 * moe_z_loss``.

The loss is computed in sequence chunks of ``LOSS_CHUNK`` so that
[B, S, vocab] logits never exist at once (vocab up to 256k): the unembed
matmul runs inside the chunk loop in f32, as in the JAX package. The f32
copy of the unembedding is made once per call, outside the loop, and each
chunk's body is checkpointed, so that one chunk's logits are alive at a time
in the backward (where the JAX package's ``lax.scan`` stores per-chunk
residuals; the values are the same).

The cross-entropy has its own backward (softmax minus the one-hot, in the
buffer of the saved softmax). With the vocab split over "model" (``Embed``'s
split) it is vocab-parallel: each rank computes its vocab slice's logits
(the softcap applied first), the max and the sum of exponentials are
reduced over "model", and the label's logit comes from the rank that owns
it; the MoE aux terms are the same on every rank.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models.layers import Embed
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import Backbone, Cache, init_caches
from repro_torch.parallel.tensor import (
    Split, copy_to_model, max_over_model, reduce_from_model, split_of,
)

LOSS_CHUNK = 512


class _CrossEntropy(torch.autograd.Function):
    """Each token's loss, log-sum-exp minus the label's logit, from f32
    logits [..., V] or, with ``tp``, [..., V/M] of the vocab split over
    "model" (the max and the sum of exponentials reduced over "model", the
    label's logit from the rank that owns it). The backward is softmax minus
    the one-hot in one buffer (the saved softmax, scaled in place), as
    Megatron's vocab-parallel cross-entropy."""

    @staticmethod
    def forward(ctx, logits, labels, tp: Optional[Split]):
        off, n = tp.part(logits.shape[-1] * tp.size) if tp is not None else (0, logits.shape[-1])
        local = labels - off
        own = ((local >= 0) & (local < n)).to(logits.dtype)
        idx = local.clamp(0, n - 1)[..., None]
        m = max_over_model(logits.amax(dim=-1), tp)
        e = torch.exp(logits - m[..., None])
        total = reduce_from_model(e.sum(dim=-1), tp)
        picked = reduce_from_model(torch.gather(logits, -1, idx)[..., 0] * own, tp)
        e.div_(total[..., None])
        ctx.save_for_backward(e, idx, own)
        return torch.log(total) + m - picked

    @staticmethod
    def backward(ctx, g):
        p, idx, own = ctx.saved_tensors
        grad = p.mul_(g[..., None])
        grad.scatter_add_(-1, idx, -(g * own)[..., None])
        return grad, None, None


def _ce_chunk(xch: torch.Tensor, w32: torch.Tensor, lch: torch.Tensor, softcap: float,
              tp: Optional[Split]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the chunk's token losses, its unmasked tokens), in f32; with
    ``tp``, ``w32`` is this rank's [d, V/M] slice of the vocab."""
    logits = copy_to_model(xch, tp).float() @ w32
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    mask = (lch >= 0).float()
    return torch.sum(_CrossEntropy.apply(logits, lch, tp) * mask), torch.sum(mask)


def chunked_ce_loss(x: torch.Tensor, w_un: torch.Tensor, labels: torch.Tensor,
                    softcap: float = 0.0, tp: Optional[Split] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d]; w_un [d, V] (with ``tp``, this rank's [d, V/M] slice
    of a vocab split over "model"); labels [B, S] (-1 = pad). Returns
    (sum_loss, n_tokens), f32 scalars."""
    b, s, d = x.shape
    c = min(LOSS_CHUNK, s)
    assert s % c == 0
    w32 = w_un.float()                       # once, outside the chunk loop
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        args = (x[:, i:i + c], w32, labels[:, i:i + c], softcap, tp)
        if torch.is_grad_enabled() and (x.requires_grad or w32.requires_grad):
            t, n = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            t, n = _ce_chunk(*args)
        tot, cnt = tot + t, cnt + n
    return tot, cnt


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, remat: str = "block"):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.embed = Embed(cfg, device=device)
        self.backbone = Backbone(cfg, device=device)

    @property
    def device(self) -> torch.device:
        return self.backbone.final_norm.scale.device

    def active_param_count(self) -> int:
        """The parameters one token's forward reads: all of them, less the
        E - k of each MoE layer's E experts that its router passes over."""
        n = sum(p.numel() for p in self.parameters())
        e, k = self.cfg.num_experts, self.cfg.num_experts_per_tok
        experts = sum(p.numel() for m in self.modules() if isinstance(m, MoE)
                      for p in (m.w_gate, m.w_up, m.w_down))
        return n - experts * (e - k) // e if e else n

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, dict]:
        """Mean next-token cross-entropy over the unmasked labels, plus the
        MoE aux losses with experts. Returns (loss, metrics ``loss``, ``ce``,
        ``tokens`` and the three ``moe_*`` aux values), f32 scalars; the
        backbone runs in train mode under ``self.remat``."""
        cfg = self.cfg
        inputs = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
        h, aux, _ = self.backbone(self.embed(inputs), mode="train", remat=self.remat)
        tot, cnt = chunked_ce_loss(h, self.embed.weight(), batch["labels"], cfg.logit_softcap,
                                   split_of(self.embed))
        ce = tot / torch.clamp(cnt, min=1.0)
        loss = ce
        if cfg.num_experts:
            loss = loss + cfg.router_aux_loss * aux["moe_lb_loss"] + 1e-3 * aux["moe_z_loss"]
        return loss, {"loss": loss, "ce": ce, "tokens": cnt, **aux}

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (the JAX init's distributions)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def init_cache(self, batch: int, max_len: int) -> List[Cache]:
        """Zeroed caches; on a split model this rank's shards of them
        (``init_caches`` under the rules that ``shard_model`` kept)."""
        return init_caches(self.cfg, batch, max_len, dtype_of(self.cfg.act_dtype),
                           device=self.device, rules=getattr(self, "rules", None))

    @torch.no_grad()
    def prefill(self, inputs: torch.Tensor, max_len: int
                ) -> Tuple[List[Cache], torch.Tensor]:
        """inputs: tokens [B, S] or embeds [B, S, d]. Returns (caches of
        max_len, last-position logits f32 [B, V]).

        On a model that ``parallel.tensor.shard_model`` split, every rank of a
        "model" group gives the same rows (this rank's rows of a batch split
        over the batch dims; under ``parallel.use_mesh`` when they are split,
        so that the MoE routes every rank's rows together): each layer
        computes on its shards, the row-parallel outputs are summed over
        "model", the vocab-parallel logits gathered to the whole [B, V],
        ZeRO-3's parameters gathered over "data", and the caches are this
        rank's shards in the rules' ``cache_spec`` layout."""
        h, _, caches = self.backbone(self.embed(inputs), mode="prefill", max_len=max_len)
        return caches, self.embed.logits(h[:, -1])

    @torch.no_grad()
    def decode_step(self, caches: List[Cache], inputs: torch.Tensor,
                    pos: Union[int, torch.Tensor]) -> Tuple[List[Cache], torch.Tensor]:
        """inputs: tokens [B] or embeds [B, 1, d] at position ``pos``, an int
        or a 0-d int tensor on the model's device (never read on the host, so
        the step can be captured in a CUDA graph); updates ``caches`` in
        place. Returns (caches, logits f32 [B, V]). On a split model as
        ``prefill``: ``caches`` are this rank's shards."""
        pos = torch.as_tensor(pos, dtype=torch.int64, device=self.device)
        x = self.embed(inputs[:, None] if self.cfg.embed_inputs else inputs)
        h, _, caches = self.backbone(x, mode="decode", caches=caches, pos=pos)
        return caches, self.embed.logits(h[:, 0])


def build_model(cfg: ModelConfig, *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None, remat: str = "block") -> Model:
    """Builds the model on ``device`` (default ``cuda``; raises without a GPU).

    Parameters are drawn from ``generator`` (default: seed 0 on the model's
    device); on the ``meta`` device they are left unset. ``remat`` is the
    loss's rematerialisation policy (``Backbone``).
    """
    dev = resolve_device(device)
    model = Model(cfg, device=dev, remat=remat)
    if dev.type != "meta":
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        model.reset_parameters(generator)
    return model.eval()
