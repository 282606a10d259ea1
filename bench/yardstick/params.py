"""Parameters counted from a configuration file: all of them, and those one
token's forward reads (an MoE's k of its E experts; a tied table once)."""
from __future__ import annotations

import math

from bench.weights import family


def param_count(cfg: dict) -> int:
    return sum(math.prod(shape) for _, shape, *_ in family(cfg).param_specs(cfg))


def active_param_count(cfg: dict) -> int:
    e, k = cfg.get("num_experts", 0), cfg.get("num_experts_per_tok", 0)
    total = param_count(cfg)
    if not e:
        return total
    experts = sum(math.prod(shape) for name, shape, *_ in family(cfg).param_specs(cfg)
                  if name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down") and ".moe." in name)
    return total - experts * (e - k) // e
