"""Conventional end-to-end baselines: DCQCN and the THEMIS-like variant.

``dcqcn`` is exactly the ``Scheme`` default hook set; ``themis`` differs only
in the RTT-fairness-corrected DCQCN gains: long-haul flows increase faster
and cut softer so the short intra-DC loop cannot starve them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cc_proxy import themis_rtt_scale
from repro_torch.netsim.schemes.base import Scheme, SchemeCtx
from repro_torch.netsim.soft import clip


class DcqcnScheme(Scheme):
    """Conventional e2e RDMA, the paper's primary baseline. Streams the mean
    inter-DC DCQCN sender rate as ``mean_cc_rate_gbps``."""

    def init_metric_acc(self, ctx: SchemeCtx, state) -> dict:
        return dict(super().init_metric_acc(ctx, state),
                    cc_rate_sum=torch.zeros_like(state.inflight[..., 0]))

    def accumulate_metrics(self, ctx: SchemeCtx, acc, state, out, inc):
        acc = super().accumulate_metrics(ctx, acc, state, out, inc)
        n_inter = clip(ctx.is_inter.sum(-1), 1.0)
        rc = (state.cc.rc * ctx.is_inter).sum(-1) / n_inter
        return dict(acc, cc_rate_sum=acc["cc_rate_sum"] + rc * inc)

    def finalize_metrics(self, acc: dict, n_steps: int, n_warm: int) -> dict:
        cols = super().finalize_metrics(acc, n_steps, n_warm)
        cols["mean_cc_rate_gbps"] = (np.asarray(acc["cc_rate_sum"])
                                     / max(n_warm, 1) * 8.0 / 1e9)
        return cols


class ThemisScheme(DcqcnScheme):
    """e2e RDMA with RTT-fairness-corrected DCQCN gains."""

    def rtt_scale(self, ctx: SchemeCtx):
        return themis_rtt_scale(ctx.rtt_us)
