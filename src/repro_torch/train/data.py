"""Deterministic synthetic data: the port of ``repro.train.data``.

Markov-chain token streams (not uniform noise: the LM gets a learnable
signal, so loss curves mean something), drawn per step from an explicit
``torch.Generator`` seeded from (seed, step): step -> batch, deterministic
and seekable (resuming at step k reproduces batch k). The chain is the JAX
package's: a first-order chain over k = min(vocab, 257) states with sharp
transitions (logits N(0,1) * 4 from a fixed seed), states mapped into the
vocab as ``(state * (vocab // k)) % vocab``. The draws are torch's, not
``jax.random``'s: the two give other numbers from one seed, so the parity
tests hand JAX-made batches to the port through numpy. A model of
precomputed-embedding inputs (``embed_inputs=False``) gets ``embeds`` [B, S,
d_model] bf16 in place of the tokens, N(0, 1) from a second generator of
(seed, step) (the JAX package's ``fold_in(key, 1)``), beside the chain's
labels: a stubbed frontend's frames or patches.
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

from repro_torch.config.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike

_TRANSITION_SEED = 7


def _generator(seed: int, step: int, stream: int = 0) -> torch.Generator:
    """A CPU generator for (seed, step) and a stream of that step (0: the
    tokens, 1: the embeddings): distinct, reproducible streams."""
    return torch.Generator().manual_seed((seed * 1_000_003 + step + stream * 2 ** 61) % (2 ** 63))


def gen_tokens(gen: torch.Generator, batch: int, seq: int, vocab: int) -> torch.Tensor:
    """[batch, seq] int64 token ids of the Markov chain, on the CPU."""
    k = min(vocab, 257)
    trans = torch.randn((k, k), generator=torch.Generator().manual_seed(_TRANSITION_SEED)) * 4.0
    probs = torch.softmax(trans, dim=-1)
    state = torch.randint(0, k, (batch,), generator=gen)
    toks = torch.empty((batch, seq), dtype=torch.int64)
    for t in range(seq):
        state = torch.multinomial(probs[state], 1, generator=gen)[:, 0]
        toks[:, t] = state
    return (toks * max(vocab // k, 1)) % vocab


class SyntheticDataset:
    """step -> batch dict {"tokens", "labels"} [global_batch, seq_len] int64
    (``embed_inputs=False``: {"embeds" [global_batch, seq_len, d_model] bf16,
    "labels"}), on ``device``. Deterministic, seekable."""

    def __init__(self, model: ModelConfig, train: TrainConfig, device: DeviceLike = "cpu"):
        self.model = model
        self.train = train
        self.device = torch.device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        b, s, seed = self.train.global_batch, self.train.seq_len, self.train.seed
        toks = gen_tokens(_generator(seed, step), b, s + 1,
                          self.model.vocab_size).to(self.device)
        if self.model.embed_inputs:
            return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        embeds = torch.randn((b, s, self.model.d_model), generator=_generator(seed, step, 1),
                             dtype=torch.bfloat16)
        return {"embeds": embeds.to(self.device), "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
