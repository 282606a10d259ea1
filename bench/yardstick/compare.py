"""The numbers that decide ``correct``: each a gap between what the program
produced and what the plain reference works out from the same weights and
inputs.

Training: ``loss_gap`` is the worst of the checked steps' relative loss
gaps; ``grad_gap`` and ``change_gap`` compare, leaf by leaf, the norm of the
first step's gradient as the optimizer got it and the norm of each leaf's
change over the checked steps, by the worst leaf: the gap between the
program's norm and the reference's, over the reference's norm of that leaf
or of the median leaf, whichever is larger. A leaf whose reference gradient
is under a thousandth of the median leaf's moves by round-off alone and is
left out of the change. ``grad_gap_median`` is the median leaf's gap of the
first gradient's norm: steady from seed to seed where the worst leaf is one
small leaf's noise (an MoE router's gradient moves as near-ties in its top
k flip).

Serving: ``logit_gap`` is the widest gap by which a served token's logit
lies below the reference's best logit at its position, ``mean_logit_gap``
the mean of those gaps over every served token checked.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Sequence

import torch

ROUNDOFF_SHARE = 1e-3


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref, strict=True))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's |prog - ref| over its reference norm or the median leaf's."""
    names = sorted(ref if leaves is None else leaves)
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Optional[Iterable[str]] = None) -> str:
    gaps = leaf_gaps(prog, ref, leaves)
    return max(gaps, key=gaps.get)


def moving_leaves(ref_grad: Dict[str, float]) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= ROUNDOFF_SHARE * med]


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: "loss" (each checked step's), "grad" (each
    leaf's first clipped gradient norm), "change" (each leaf's change norm);
    ``ref`` also "grad_raw", its gradients' norms before the clip."""
    return {"loss_gap": loss_gap(prog["loss"], ref["loss"]),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": leaf_gap(prog["change"], ref["change"], moving_leaves(ref["grad_raw"])),
            "grad_gap_median": statistics.median(leaf_gaps(prog["grad"], ref["grad"]).values())}


def logit_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """ref_logits [..., V] f32, tokens [...] the tokens served there -> the
    gap of each served token below the reference's best."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, tokens[..., None])[..., 0]
