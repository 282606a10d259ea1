"""Public model API: build_model(cfg, device=) -> Model(loss_fn, prefill,
decode_step, init_cache).

Input convention: token ids [B, S] (int64); ``batch["labels"]`` [B, S], -1 =
masked. The loss is computed in sequence chunks of ``LOSS_CHUNK`` so that
[B, S, vocab] logits never exist at once (vocab up to 256k): the unembed
matmul runs inside the chunk loop in f32, as in the JAX package. The f32
copy of the unembedding is made once per call, outside the loop, and each
chunk's body is checkpointed, so that one chunk's logits are alive at a time
in the backward (where the JAX package's ``lax.scan`` stores per-chunk
residuals; the values are the same).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import arch_of, ported_archs
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models.layers import Embed
from repro_torch.models.transformer import Backbone, Cache, init_caches

LOSS_CHUNK = 512


def _ce_chunk(xch: torch.Tensor, w32: torch.Tensor, lch: torch.Tensor, softcap: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the chunk's token losses, its unmasked tokens), in f32."""
    logits = xch.float() @ w32
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, lch.clamp(min=0)[..., None])[..., 0]
    mask = (lch >= 0).float()
    return torch.sum((lse - picked) * mask), torch.sum(mask)


def chunked_ce_loss(x: torch.Tensor, w_un: torch.Tensor, labels: torch.Tensor,
                    softcap: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d]; w_un [d, V]; labels [B, S] (-1 = pad). Returns (sum_loss,
    n_tokens), f32 scalars."""
    b, s, d = x.shape
    c = min(LOSS_CHUNK, s)
    assert s % c == 0
    w32 = w_un.float()                       # once, outside the chunk loop
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        args = (x[:, i:i + c], w32, labels[:, i:i + c], softcap)
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

    def unembed_weight(self) -> torch.Tensor:
        """[d, V]: the tied table transposed, or the separate unembedding."""
        return self.embed.tok.T if self.embed.unembed is None else self.embed.unembed

    def loss_fn(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, dict]:
        """Mean next-token cross-entropy over the unmasked labels. Returns
        (loss, metrics ``loss``, ``ce``, ``tokens``), f32 scalars; the
        backbone runs in train mode under ``self.remat``."""
        h, _ = self.backbone(self.embed(batch["tokens"]), mode="train", remat=self.remat)
        tot, cnt = chunked_ce_loss(h, self.unembed_weight(), batch["labels"],
                                   self.cfg.logit_softcap)
        ce = tot / torch.clamp(cnt, min=1.0)
        return ce, {"loss": ce, "ce": ce, "tokens": cnt}

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init from ``generator`` (the JAX init's distributions)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def init_cache(self, batch: int, max_len: int) -> List[Cache]:
        return init_caches(self.cfg, batch, max_len, dtype_of(self.cfg.act_dtype),
                           device=self.embed.tok.device)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int
                ) -> Tuple[List[Cache], torch.Tensor]:
        """tokens [B, S]. Returns (caches of max_len, last-position logits f32 [B, V])."""
        h, caches = self.backbone(self.embed(tokens), mode="prefill", max_len=max_len)
        return caches, self.embed.logits(h[:, -1])

    @torch.no_grad()
    def decode_step(self, caches: List[Cache], tokens: torch.Tensor, pos: int
                    ) -> Tuple[List[Cache], torch.Tensor]:
        """tokens [B] at position ``pos``; updates ``caches`` in place.

        Returns (caches, logits f32 [B, V])."""
        h, caches = self.backbone(self.embed(tokens[:, None]), mode="decode",
                                  caches=caches, pos=int(pos))
        return caches, self.embed.logits(h[:, 0])


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config of a registered arch whose
    model the port does not build yet (``ported_archs()``)."""
    arch = arch_of(cfg)
    if arch is not None and arch not in ported_archs():
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: its config and traffic are "
            f"data here, its model comes with ROADMAP queue 1 item 3 (ported: "
            f"{ported_archs()})")


def build_model(cfg: ModelConfig, *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None, remat: str = "block") -> Model:
    """Builds the model on ``device`` (default ``cuda``; raises without a GPU).

    Parameters are drawn from ``generator`` (default: seed 0 on the model's
    device); on the ``meta`` device they are left unset. ``remat`` is the
    loss's rematerialisation policy (``Backbone``). A config of a registered
    arch that is not in ``ported_archs()`` raises ``NotImplementedError``
    before anything is allocated.
    """
    check_ported(cfg)
    dev = resolve_device(device)
    model = Model(cfg, device=dev, remat=remat)
    if dev.type != "meta":
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        model.reset_parameters(generator)
    return model.eval()
