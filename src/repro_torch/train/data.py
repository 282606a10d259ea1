"""Deterministic synthetic data: the port of ``repro.train.data``.

Markov-chain token streams (not uniform noise: the LM gets a learnable
signal, so loss curves mean something), drawn per step from an explicit
``torch.Generator`` seeded from (seed, step): step -> batch, deterministic
and seekable (resuming at step k reproduces batch k). The chain is the JAX
package's: a first-order chain over k = min(vocab, 257) states with sharp
transitions (logits N(0,1) * 4 from a fixed seed), states mapped into the
vocab as ``(state * (vocab // k)) % vocab``. The draws are torch's, not
``jax.random``'s: the two give other numbers from one seed, so the parity
tests hand JAX-made batches to the port through numpy.
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

from repro_torch.config.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike

_TRANSITION_SEED = 7


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for (seed, step): distinct, reproducible streams."""
    return torch.Generator().manual_seed((seed * 1_000_003 + step) % (2 ** 63))


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
    """step -> batch dict {"tokens", "labels"} [global_batch, seq_len] int64,
    on ``device``. Deterministic, seekable."""

    def __init__(self, model: ModelConfig, train: TrainConfig, device: DeviceLike = "cpu"):
        if not model.embed_inputs:
            raise NotImplementedError("precomputed-embedding batches (embed_inputs=False) "
                                      "come with the slice that ports their archs")
        self.model = model
        self.train = train
        self.device = torch.device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        toks = gen_tokens(_generator(self.train.seed, step), self.train.global_batch,
                          self.train.seq_len + 1, self.model.vocab_size).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
