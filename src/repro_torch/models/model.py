"""Public model API: build_model(cfg, device=) -> Model(prefill, decode_step, init_cache).

Input convention: token ids [B, S] (int64). The training loss comes with
the training slice.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from repro_torch.config.base import ModelConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models.layers import Embed
from repro_torch.models.transformer import Backbone, Cache, init_caches


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg, device=device)
        self.backbone = Backbone(cfg, device=device)

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


def build_model(cfg: ModelConfig, *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Model:
    """Builds the model on ``device`` (default ``cuda``; raises without a GPU).

    Parameters are drawn from ``generator`` (default: seed 0 on the model's
    device); on the ``meta`` device they are left unset.
    """
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    if dev.type != "meta":
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        model.reset_parameters(generator)
    return model.eval()
