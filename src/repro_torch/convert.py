"""Carry JAX parameters across into the port's Model.

``params_from_jax(tree, cfg)`` takes the JAX param tree as nested dicts and
tuples of numpy arrays (``jax.tree.map(np.asarray, params)``, done by the
caller) and returns a state dict for ``Model.load_state_dict``:

* each leaf of ``backbone.groups[i]`` carries a leading ``n_groups`` axis
  (the JAX backbone scans stacked groups); it is unstacked so that group g's
  pattern position i becomes layer ``g * len(pattern) + i``, and the
  ``rem`` blocks follow (recurrentgemma-2b's 26 layers: 8 groups of
  (RG-LRU, RG-LRU, local attention), then RG-LRU layers 24 and 25);
* each leaf keeps its dtype: the f32 leaves of a bf16 model (SSD's
  ``A_log``, ``D``, ``dt_bias``; RG-LRU's ``b_a``, ``b_i``, ``lam``) stay f32;
* bfloat16 arrays arrive with the ``ml_dtypes`` dtype, which
  ``torch.from_numpy`` refuses; their bits go across through uint16;
* matrices keep the JAX ``[in, out]`` orientation, which the port's layers
  use as they are; an MoE block's ``moe.router`` [d, E] and its experts
  ``moe.w_gate``/``moe.w_up`` [E, d, f] and ``moe.w_down`` [E, f, d] too;
* a tied model has no ``unembed`` leaf, and a model of embedding inputs
  (``embed_inputs=False``) no ``tok`` leaf: its embed subtree is ``unembed``
  alone.

The state dict holds whole tensors. On a mesh, ``train_step.ShardedStep.
place`` takes them as they are and keeps each rank's shard under the
``ShardingRules`` (the step then computes tensor-parallel on those shards).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.config.base import ATTN, ModelConfig


def to_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding the array's values bit for bit (bf16 included)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, np.ndarray]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """State dict of the port's Model from a numpy JAX param tree."""
    pat = cfg.block_pattern or ((ATTN, cfg.default_mlp),)
    n_groups = cfg.num_layers // len(pat)
    backbone = tree["backbone"]
    sd = {f"embed.{name}": to_tensor(a) for name, a in _leaves(tree["embed"])}
    for i, group in enumerate(backbone["groups"]):
        for name, a in _leaves(group):
            if a.shape[0] != n_groups:
                raise ValueError(f"groups[{i}].{name} has leading axis {a.shape[0]}, "
                                 f"expected n_groups={n_groups}")
            for g in range(n_groups):
                sd[f"backbone.layers.{g * len(pat) + i}.{name}"] = to_tensor(a[g])
    for j, block in enumerate(backbone["rem"]):
        for name, a in _leaves(block):
            sd[f"backbone.layers.{n_groups * len(pat) + j}.{name}"] = to_tensor(a)
    for name, a in _leaves(backbone["final_norm"]):
        sd[f"backbone.final_norm.{name}"] = to_tensor(a)
    return sd
