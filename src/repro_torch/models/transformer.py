"""Block-typed decoder-only backbone: mixer in {attn, local_attn, ssd, rglru},
mlp in {swiglu, relu2, gelu, moe, none}.

The JAX package stacks each pattern position's layers and scans them; the
port keeps one ``Block`` module per layer in order (layer g*len(pattern)+i is
group g's pattern position i, then the remainder), which is the order that
``convert.params_from_jax`` unstacks the scanned groups into.

Modes: ``train`` runs the whole sequence and makes no cache; ``prefill``
runs the whole prompt and returns one cache per layer (K/V of ``max_len``
for attention, a ring of the last ``local_window`` K/V for local attention,
the conv windows and the state for SSD and RG-LRU; all but global attention
ignore ``max_len``); ``decode`` runs one token against those caches and
updates them in place (SSD and RG-LRU ignore ``pos``). With
``decode_k_time_minor`` a global attention layer keeps its K cache
time-minor, [B, Hk, hd, Smax], so that decode's q.K contracts hd with S
free (local layers keep their time-major ring, as in the JAX package).
Each mode also returns the MoE aux values (``moe.AUX_KEYS``) summed over
the layers, zeros without an MoE layer, as ``apply_backbone`` sums them.

Train and prefill attention go through ``kernels.ops.flash_attention``
(local attention with its window), the SSD scan through
``kernels.ops.ssd_scan``, the RG-LRU recurrence through
``kernels.ops.rglru_recurrence``: autograd Functions around the kernels.

In train mode the backbone rematerialises as the JAX package's
``_remat_wrap`` does, with ``torch.utils.checkpoint`` in place of
``jax.checkpoint``: ``remat="block"`` (or any string but ``none`` and
``dots``) keeps only the input of each pattern group (one layer for qwen and
mamba2, three for recurrentgemma; the scan body of the JAX package) and
recomputes the group in the backward; ``dots`` keeps the outputs of the
weight matmuls too; ``none`` keeps everything. The remainder layers are not
rematerialised, as there.
"""
from __future__ import annotations

from functools import partial
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.config.base import (
    ATTN, LOCAL_ATTN, MLP_MOE, MLP_NONE, RGLRU, SSD, ModelConfig,
)
from repro_torch.device import dtype_of
from repro_torch.kernels.ops import flash_attention
from repro_torch.models.attention import (
    decode_attention, decode_attention_tm, decode_local_attention, local_attention, seq_part,
    write_at,
)
from repro_torch.models.layers import MLP, Norm, apply_rope, normal_
from repro_torch.models.moe import AUX_KEYS, MoE, Aux, aux_zero
from repro_torch.models.rglru import RGLRU as RGLRUMixer
from repro_torch.models.rglru import init_rglru_cache
from repro_torch.models.ssm import SSD as SSDMixer
from repro_torch.models.ssm import init_ssd_cache
from repro_torch.parallel.sharding import ShardingRules
from repro_torch.parallel.tensor import (
    copy_to_model, gather_from_model, reduce_from_model, split_of, weight,
)

# attention: {"k": [B, Smax, Hk, hd], "v": [B, Smax, Hk, hd]} (Smax = local_window
# for local attention, a ring: position p in slot p % W; "k" [B, Hk, hd, Smax]
# for a global layer under decode_k_time_minor; on a split model a rank's
# shard of them, init_caches);
# SSD: {"conv_x": [B, K-1, d_in], "conv_bc": [B, K-1, 2gn], "ssm": [B, h, n, p] f32};
# RG-LRU: {"conv": [B, K-1, W], "h": [B, W] f32}
Cache = dict


# ---------------------------------------------------------------------------
# Attention sub-block
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """Global causal (``mixer=ATTN``) or sliding-window (``LOCAL_ATTN``) attention.

    Split over "model" (``q_shardable``), a rank projects its own q heads
    (column-parallel wq, bq) and its kv heads when ``kv_shardable``; when
    the kv heads do not divide, wk and wv are whole on every rank, and the
    rank keeps the kv heads that its q heads read (one a rank when its q
    heads share a group, else one per q head). ``wo`` is row-parallel. When
    the q heads do not divide, nothing is split and the attention runs whole
    on every rank.

    Serving on a split model keeps the caches in the rules' ``cache_spec``
    layout: this rank's kv heads where they divide, else (``seq_split``,
    the default) every kv head at this rank's slice of the positions, or of
    a ring's slots (``_prefill_cache``, ``_decode``)."""

    def __init__(self, cfg: ModelConfig, mixer: str = ATTN, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hk = cfg.num_heads, cfg.num_kv_heads
        pd = dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.mixer = mixer
        self.time_minor = cfg.decode_k_time_minor and mixer != LOCAL_ATTN
        self.wq = nn.Parameter(torch.empty(d, hq * hd, dtype=pd, device=device))
        self.wk = nn.Parameter(torch.empty(d, hk * hd, dtype=pd, device=device))
        self.wv = nn.Parameter(torch.empty(d, hk * hd, dtype=pd, device=device))
        self.wo = nn.Parameter(torch.empty(hq * hd, d, dtype=pd, device=device))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(hq * hd, dtype=pd, device=device))
            self.bk = nn.Parameter(torch.zeros(hk * hd, dtype=pd, device=device))
            self.bv = nn.Parameter(torch.zeros(hk * hd, dtype=pd, device=device))
        else:
            self.bq = self.bk = self.bv = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.cfg.d_model
        for w in (self.wq, self.wk, self.wv):
            normal_(w, d ** -0.5, generator)
        normal_(self.wo, self.wo.shape[0] ** -0.5, generator)
        if self.bq is not None:
            with torch.no_grad():
                for bias in (self.bq, self.bk, self.bv):
                    bias.zero_()

    def _qkv(self, x: torch.Tensor, whole_kv: bool = False):
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        tp = split_of(self)
        if tp is not None:
            return self._qkv_split(x, tp, whole_kv)
        q, k, v = (x @ weight(self, w) for w in ("wq", "wk", "wv"))
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        shp = x.shape[:-1]
        return (q.reshape(*shp, cfg.num_heads, hd),
                k.reshape(*shp, cfg.num_kv_heads, hd),
                v.reshape(*shp, cfg.num_kv_heads, hd))

    def _qkv_split(self, x: torch.Tensor, tp, whole_kv: bool = False):
        """This rank's q heads and the kv heads they read (with
        ``whole_kv``, every kv head where the kv heads are whole)."""
        cfg = self.cfg
        hd, hk = cfg.resolved_head_dim, cfg.num_kv_heads
        shp = x.shape[:-1]
        xc = copy_to_model(x, tp)
        q = xc @ weight(self, "wq")
        if self.bq is not None:
            q = q + self.bq
        q = q.reshape(*shp, -1, hd)
        kv = []
        for w, b in (("wk", self.bk), ("wv", self.bv)):
            t = (xc if self.wk.shape[-1] < hk * hd else x) @ weight(self, w)
            if b is not None:
                t = t + b
            kv.append(t.reshape(*shp, -1, hd))
        k, v = kv
        if k.shape[-2] == hk and not whole_kv:
            # whole kv heads on every rank (whole compute, whole gradients):
            # keep the ones this rank's q heads read, their gradient summed
            # over "model" where the kept heads are used
            k, v = (self._heads_read(copy_to_model(t, tp), tp, -2) for t in (k, v))
        return q, k, v

    def _heads_read(self, t: torch.Tensor, tp, dim: int) -> torch.Tensor:
        """Of ``t``'s whole kv heads (along ``dim``), the ones this rank's q
        heads read: one a rank when its q heads share a group (a view), else
        one per q head."""
        hq, hk = self.cfg.num_heads, self.cfg.num_kv_heads
        first, n = tp.part(hq)
        used = [(first + i) // (hq // hk) for i in range(n)]
        keep = sorted(set(used))
        if used == [h for h in keep for _ in range(n // len(keep))]:
            return t.narrow(dim, keep[0], len(keep))
        return t.index_select(dim, torch.tensor(used, device=t.device))

    def forward(self, x: torch.Tensor, *, mode: str, cache: Optional[Cache],
                pos=None, max_len: int = 0) -> Tuple[torch.Tensor, Cache]:
        theta = self.cfg.rope_theta
        b, s, _ = x.shape
        tp = split_of(self)
        if mode == "decode":
            o = self._decode(x[:, 0], cache, pos)[:, None]
        elif mode in ("train", "prefill"):
            if mode == "prefill" and self.mixer == ATTN and max_len < s:
                raise ValueError(f"max_len {max_len} < prompt length {s}")
            q, k, v = self._qkv(x, whole_kv=mode == "prefill")
            positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
            if mode == "prefill":
                cache = self._prefill_cache(k, v, max_len)
                if tp is not None and k.shape[-2] == self.cfg.num_kv_heads:
                    k, v = (self._heads_read(t, tp, -2) for t in (k, v))
            local, w = self.mixer == LOCAL_ATTN, self.cfg.local_window
            o = local_attention(q, k, v, window=w) if local else flash_attention(q, k, v)
        else:
            raise ValueError(f"unknown mode {mode!r}; expected train, prefill or decode")
        o = o.reshape(b, o.shape[1], -1)
        return reduce_from_model(o @ weight(self, "wo"), tp), cache

    def _prefill_cache(self, k: torch.Tensor, v: torch.Tensor, max_len: int) -> Cache:
        """The cache a prefill leaves: K/V [B, S, Hk', hd] (rope applied; this
        rank's kv heads, or every kv head where they are whole) written at
        their positions, into this rank's slice of the sequence under a
        sequence split (``seq_split``)."""
        b, s = k.shape[:2]
        seq = getattr(self, "seq_split", None)
        cache = init_attn_cache(self.cfg, b, max_len, k.dtype, k.device, self.mixer,
                                kv_heads=k.shape[2], seq_parts=seq.size if seq else 1)
        if self.mixer == LOCAL_ATTN:
            # the last W positions, position p in slot p % W (zeros past s when
            # s < W), the layout of the JAX package's roll
            w = self.cfg.local_window
            n = min(s, w)
            k, v = (torch.roll(t[:, s - n:], s % w, 1) for t in (k, v))
        rows = cache["v"].shape[1]
        off = seq_part(seq, rows)[0] if seq is not None else 0
        n = max(0, min(k.shape[1] - off, rows))
        if self.time_minor:
            cache["k"][..., :n] = k[:, off:off + n].permute(0, 2, 3, 1)
        else:
            cache["k"][:, :n] = k[:, off:off + n]
        cache["v"][:, :n] = v[:, off:off + n]
        return cache

    def _decode(self, x: torch.Tensor, cache: Cache, pos) -> torch.Tensor:
        """One token x [B, d] at ``pos`` against ``cache``, which it updates in
        place. Returns this rank's q heads' output [B, Hq', hd].

        Under a sequence split (``seq_split``) the rank that owns the new
        token's row writes it, every rank attends all q heads (gathered over
        "model" where wq is split) to its slice, and the partial softmaxes
        are combined over "model"; with whole kv heads and no sequence split
        the rank reads the kv heads its q heads use."""
        cfg, theta = self.cfg, self.cfg.rope_theta
        tp, seq = split_of(self), getattr(self, "seq_split", None)
        q, k, v = self._qkv(x, whole_kv=True)                     # [B,H,hd]
        # pos: an int, or a 0-d int tensor on x's device that no host
        # code reads, so that the step can be captured in a CUDA graph
        pos = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
        positions = pos.to(torch.int32).expand(x.shape[0], 1)
        q = apply_rope(q[:, None], positions, theta)[:, 0]
        k = apply_rope(k[:, None], positions, theta)[:, 0]
        # The cache was preallocated at max_len, or at the window for a ring
        # (by prefill or init_cache), and is updated in place here, where the
        # JAX package returns an updated copy of it.
        local = self.mixer == LOCAL_ATTN
        slot = pos % cfg.local_window if local else pos
        kc, vc = cache["k"], cache["v"]
        if self.time_minor:
            write_at(kc, 3, slot, k.to(kc.dtype)[..., None], seq)
        else:
            write_at(kc, 1, slot, k.to(kc.dtype)[:, None], seq)
        write_at(vc, 1, slot, v.to(vc.dtype)[:, None], seq)
        attend = (decode_local_attention if local else
                  decode_attention_tm if self.time_minor else decode_attention)
        if seq is not None:
            kw = {"window": cfg.local_window} if local else {}
            o = attend(gather_from_model(q, 1, tp), kc, vc, pos, split=seq, **kw)
            return o if tp is None else o.narrow(1, *tp.part(cfg.num_heads))
        if tp is not None and vc.shape[2] == cfg.num_kv_heads:
            kc = self._heads_read(kc, tp, 1 if self.time_minor else 2)
            vc = self._heads_read(vc, tp, 2)
        return attend(q, kc, vc, pos)


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device=None, mixer: str = ATTN,
                    kv_heads: int = 0, seq_parts: int = 1) -> Cache:
    """Zeroed K/V of ``max_len`` rows, or of ``local_window`` for a local
    layer; a global layer's K time-minor [B, Hk, hd, max_len] under
    ``decode_k_time_minor``. A rank's shard of a split cache: ``kv_heads``
    of them (default all), or of a sequence (a ring's slots) split into
    ``seq_parts``, ceil(rows / seq_parts) rows (the rules' ``cache_spec``)."""
    length = cfg.local_window if mixer == LOCAL_ATTN else max_len
    length = -(-length // seq_parts)
    hk, hd = kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, length, hk, hd)
    k_shape = ((batch, hk, hd, length) if cfg.decode_k_time_minor and mixer != LOCAL_ATTN
               else shape)
    return {"k": torch.zeros(k_shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# One block = mixer + optional MLP, pre-norm residual
# ---------------------------------------------------------------------------

class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, mixer: str, mlp: str, device=None):
        super().__init__()
        if mixer not in (ATTN, LOCAL_ATTN, SSD, RGLRU):
            raise ValueError(f"unknown mixer {mixer!r}")
        self.norm1 = Norm(cfg, device=device)
        self.attn = (Attention(cfg, mixer, device=device)
                     if mixer in (ATTN, LOCAL_ATTN) else None)
        self.ssd = SSDMixer(cfg, device=device) if mixer == SSD else None
        self.rglru = RGLRUMixer(cfg, device=device) if mixer == RGLRU else None
        self.norm2 = Norm(cfg, device=device) if mlp != MLP_NONE else None
        self.mlp = MLP(cfg, mlp, device=device) if mlp not in (MLP_NONE, MLP_MOE) else None
        self.moe = MoE(cfg, device=device) if mlp == MLP_MOE else None

    def forward(self, x: torch.Tensor, *, mode: str, cache: Optional[Cache],
                pos: Optional[torch.Tensor], max_len: int = 0
                ) -> Tuple[torch.Tensor, Optional[Aux], Cache]:
        """(x after the block, its MoE aux or None without an MoE, cache)."""
        h = self.norm1(x)
        if self.attn is not None:
            mx, new_cache = self.attn(h, mode=mode, cache=cache, pos=pos, max_len=max_len)
        elif self.ssd is not None:
            mx, new_cache = self.ssd(h, mode=mode, cache=cache)
        else:
            mx, new_cache = self.rglru(h, mode=mode, cache=cache)
        x = x + mx
        aux = None
        if self.mlp is not None:
            x = x + self.mlp(self.norm2(x))
        elif self.moe is not None:
            y, aux = self.moe(self.norm2(x))
            x = x + y
        return x, aux, new_cache


def _add_aux(total: Aux, aux: Optional[Aux]) -> Aux:
    return total if aux is None else {k: total[k] + aux[k] for k in AUX_KEYS}


# ---------------------------------------------------------------------------
# The backbone
# ---------------------------------------------------------------------------

class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            Block(cfg, mixer, mlp, device=device) for mixer, mlp in cfg.layer_blocks())
        self.final_norm = Norm(cfg, device=device)

    def forward(self, x: torch.Tensor, *, mode: str,
                caches: Optional[List[Cache]] = None, pos: Optional[torch.Tensor] = None,
                max_len: int = 0, remat: str = "block"
                ) -> Tuple[torch.Tensor, Aux, List[Cache]]:
        """Runs all layers. Returns (hidden after the final norm, the MoE aux
        summed over the layers, caches); in train mode the caches are None
        and ``remat`` applies."""
        aux = aux_zero(x.device)
        if mode == "train":
            x, aux = self._train(x, aux, remat)
            return self.final_norm(x), aux, [None] * len(self.layers)
        new_caches = []
        for i, layer in enumerate(self.layers):
            x, a, c = layer(x, mode=mode, cache=None if caches is None else caches[i],
                            pos=pos, max_len=max_len)
            aux = _add_aux(aux, a)
            new_caches.append(c)
        return self.final_norm(x), aux, new_caches

    def _train(self, x: torch.Tensor, aux: Aux, remat: str) -> Tuple[torch.Tensor, Aux]:
        n_pat = len(self.cfg.block_pattern or (None,))
        n_grouped = len(self.layers) - len(self.layers) % n_pat

        def group(x: torch.Tensor, aux: Aux, first: int) -> Tuple[torch.Tensor, Aux]:
            for layer in self.layers[first:first + n_pat]:
                x, a, _ = layer(x, mode="train", cache=None, pos=None)
                aux = _add_aux(aux, a)
            return x, aux

        for first in range(0, n_grouped, n_pat):
            if remat == "none":
                x, aux = group(x, aux, first)
            elif remat == "dots":
                x, aux = checkpoint(group, x, aux, first, use_reentrant=False,
                                    context_fn=_save_matmuls)
            else:
                x, aux = checkpoint(group, x, aux, first, use_reentrant=False)
        for layer in self.layers[n_grouped:]:   # the remainder: not rematerialised
            x, a, _ = layer(x, mode="train", cache=None, pos=None)
            aux = _add_aux(aux, a)
        return x, aux


# the weight matmuls: x @ w of a [B, S, d] activation is aten.mm on [B*S, d]
# (attention's batched einsums are bmm and are recomputed), as the JAX
# package's dots_with_no_batch_dims_saveable policy keeps dots without batch dims
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _matmul_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_save_matmuls = partial(create_selective_checkpoint_contexts, _matmul_policy)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                device=None, rules: Optional[ShardingRules] = None) -> List[Cache]:
    """One zeroed cache per layer, in layer order (only a global attention
    layer's depends on max_len). With ``rules`` (of a mesh whose "model" dim
    has ``rules.n_model`` ranks), one rank's shards over "model" under
    ``rules.cache_spec``: K/V of its kv heads, or of its slice of the
    sequence; the SSD and RG-LRU states whole (split over the batch only)."""
    n = rules.n_model if rules is not None else 1
    kv_heads = cfg.num_kv_heads // n if n > 1 and rules.kv_shardable else 0
    parts = n if n > 1 and rules.cache_seq_split else 1

    def one(mixer: str) -> Cache:
        if mixer == SSD:
            return init_ssd_cache(cfg, batch, dtype, device)
        if mixer == RGLRU:
            return init_rglru_cache(cfg, batch, dtype, device)
        return init_attn_cache(cfg, batch, max_len, dtype, device, mixer, kv_heads, parts)
    return [one(mixer) for mixer, _ in cfg.layer_blocks()]
