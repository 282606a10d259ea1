"""Serving: prefill, then a batched greedy decode.

The caches are allocated once by prefill (K/V at ``max_len``, a local
layer's ring at its window, SSD and RG-LRU states at their fixed sizes), and
every decode step updates them in place. A model of embedding inputs
(``embed_inputs=False``) is fed the prompt's last embedding at every decode
step, as ``repro.launch.serve`` feeds it, and its argmax tokens are the
output.

``make_serve_step`` is the port of the JAX package's jitted single-token
step (``decode_step`` plus argmax, the caches donated). On a mesh it splits
the model by the rules (``parallel.tensor.shard_model``) and the step holds
each rank's caches in ``cache_spec``'s layout; a model split over "model"
steps eagerly, by ``ServeStep.eager`` (``greedy_decode(graph=False)``):
collectives over gloo cannot be captured in a CUDA graph, and the step
refuses to capture them. Unsplit, on the card it is one
captured CUDA graph over static input and position buffers and its own
caches, written in place, replayed once per token; on the CPU the same
function runs eagerly. As a jitted step compiles once per shape, the graph
is captured once per (batch, cache length): the first prefill's caches
become the graph's, and a later request's prefill caches are copied into
them. A failure to capture or to replay raises: there is no fallback to
eager steps on the card.

A step casts the unembedding table (in blocks of at most 1 GiB in f32,
``Embed.weight_blocks``) and each RG-LRU layer's gate weights to f32
(``models.layers.as_f32``). On the card the step keeps exact f32 copies
of them instead (bf16 to f32 is exact, so no token can change), made once,
at the first capture, and installed only while it runs, where they fit: the
table when its f32 bytes are at most ``TABLE_F32_MAX_BYTES``
(recurrentgemma-2b's tied 2.6 GB; deepseek-67b's 3.4 GB and
nemotron-4-340b's 18.9 GB stay bf16), all of them within a quarter of the
device's free memory.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.config.base import ParallelConfig
from repro_torch.device import dtype_of
from repro_torch.models.model import Model
from repro_torch.models.rglru import RGLRU
from repro_torch.models.transformer import Cache
from repro_torch.parallel.sharding import ShardingRules, batch_dims, use_mesh
from repro_torch.parallel.tensor import groups_of, shard_model
from repro_torch.serve.kvcache import cache_shardings


TABLE_F32_MAX_BYTES = 3_000_000_000


def f32_copies(model: Model) -> list:
    """[(module, {name: exact f32 copy})] of what a decode step casts, as
    far as it fits (see the module docstring); [] off the card."""
    if model.device.type != "cuda":
        return []
    _, blocks = model.embed.weight_blocks()
    out = ([(model.embed, {"weight": blocks})]
           if sum(w.numel() for w in blocks) * 4 <= TABLE_F32_MAX_BYTES else [])
    out += [(m, {"w_a": m.w_a, "w_i": m.w_i}) for m in model.modules() if isinstance(m, RGLRU)]

    def leaves(v):
        return v if isinstance(v, list) else [v]
    need = sum(t.numel() * 4 for _, ts in out for v in ts.values() for t in leaves(v))
    if need > torch.cuda.mem_get_info(model.device)[0] // 4:
        return []
    with torch.no_grad():
        # each table block cast as the step casts it (the same strides), so
        # the graph's products are the eager step's
        return [(m, {k: [t.float() for t in v] if isinstance(v, list) else v.float()
                     for k, v in ts.items()}) for m, ts in out]


def _shapes(caches: List[Cache], inp: torch.Tensor) -> tuple:
    return (tuple((k, t.shape, t.dtype) for c in caches for k, t in c.items()),
            inp.shape, inp.dtype)


class ServeStep:
    """``step(caches, inp, pos) -> (caches, token [B])``: one greedy decode
    step of ``model`` at ``pos`` (an int, or a 0-d int tensor on the model's
    device).

    On the CPU it updates ``caches`` in place and returns them. On a CUDA
    model it runs on its own caches (``load``): the first call with caches of
    a shape captures the step into a CUDA graph over those very caches (a
    warm-up run on a side stream first, on copies of them, so that the caches
    advance only at replays), and they become the step's; caches of that
    shape are then copied into them, and caches of another shape are captured
    anew. Each call copies ``inp`` and ``pos`` into the graph's static
    buffers, replays it, and returns the step's caches and a copy of its
    token: pass those caches to the next call. The kernel launch counters of
    ``repro_torch.kernels`` tick at capture, not at replay; the decode step
    launches none of the three kernels (its attention is plain PyTorch, as in
    the JAX package).

    With ``mesh`` the steps run under it (``parallel.use_mesh``): each rank
    gives its rows of a batch split over the mesh's batch dims. A model
    that ``shard_model`` split refuses to capture unless every group its
    collectives run over is NCCL's: call ``eager``."""

    def __init__(self, model: Model, mesh=None):
        self.model = model
        self.mesh = mesh
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captures = 0
        self.caches: Optional[List[Cache]] = None   # the graph's caches
        self.copies: Optional[list] = None          # f32_copies, made at the first capture
        self._key = None
        self._inp = self._pos = self._token = self._logits = None

    @contextlib.contextmanager
    def _installed(self) -> Iterator[None]:
        for module, ts in self.copies or ():
            module.f32_copies = ts
        try:
            yield
        finally:
            for module, _ in self.copies or ():
                module.f32_copies = None

    def eager(self, caches: List[Cache], inp: torch.Tensor, pos: Union[int, torch.Tensor]
              ) -> Tuple[List[Cache], torch.Tensor, torch.Tensor]:
        """The step without a graph, on ``caches`` in place: (caches, token,
        logits f32 [B, V])."""
        ambient = use_mesh(self.mesh) if self.mesh is not None else contextlib.nullcontext()
        with self._installed(), ambient:
            caches, logits = self.model.decode_step(caches, inp, pos)
        return caches, torch.argmax(logits, dim=-1), logits

    def __call__(self, caches: List[Cache], inp: torch.Tensor, pos: Union[int, torch.Tensor]
                 ) -> Tuple[List[Cache], torch.Tensor]:
        if self.model.device.type != "cuda":
            caches, token, self._logits = self.eager(caches, inp, pos)
            return caches, token
        caches = self.load(caches, inp)
        self._inp.copy_(inp)
        if isinstance(pos, torch.Tensor):
            self._pos.copy_(pos)
        else:
            self._pos.fill_(pos)
        self.graph.replay()
        return caches, self._token.clone()

    @property
    def logits(self) -> torch.Tensor:
        """The logits of the last call (f32 [B, V]; on the card the graph's
        buffer, which the next replay overwrites)."""
        return self._logits

    def load(self, caches: List[Cache], inp: torch.Tensor) -> List[Cache]:
        """The step's caches holding ``caches``' values, for inputs shaped as
        ``inp`` (card only): ``caches`` themselves when they are the step's,
        or when the step has no graph of their shapes yet (it captures one
        over them); else the step's, into which ``caches`` are copied."""
        if caches is self.caches:
            return caches
        if self.graph is not None and _shapes(caches, inp) == self._key:
            with torch.no_grad():
                for mine, theirs in zip(self.caches, caches):
                    for k, t in mine.items():
                        t.copy_(theirs[k])
            return self.caches
        self._capture(caches, inp)
        return caches

    def _capture(self, caches: List[Cache], inp: torch.Tensor) -> None:
        model = self.model
        other = sorted({dist.get_backend(g) for g in groups_of(model)} - {"nccl"})
        if other:
            raise RuntimeError(f"this model is split over {other} process groups, whose "
                               "collectives cannot be captured in a CUDA graph: step it "
                               "with ServeStep.eager (greedy_decode(graph=False))")
        self.graph = self.caches = None
        if self.copies is None:
            self.copies = f32_copies(model)
        self._inp = inp.clone()
        self._pos = torch.zeros((), dtype=torch.int64, device=model.device)
        side = torch.cuda.Stream(model.device)
        side.wait_stream(torch.cuda.current_stream(model.device))
        with torch.cuda.stream(side):
            # warm-up (lazy library state, the allocator's blocks) on copies
            # of the caches: a step on the caches themselves would advance
            # the recurrent states once more than the replays do
            scratch = [{k: t.clone() for k, t in c.items()} for c in caches]
            self.eager(scratch, self._inp, self._pos)
            del scratch
        torch.cuda.current_stream(model.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            _, self._token, self._logits = self.eager(caches, self._inp, self._pos)
        self.graph, self.caches, self._key = graph, caches, _shapes(caches, inp)
        self.captures += 1


def make_serve_step(model: Model, par: ParallelConfig, mesh, batch: int, max_len: int):
    """Returns (step, cache placements, rules): ``step`` a ``ServeStep``,
    the placements of the caches on ``mesh`` (None without a mesh: one
    device) and the ``ShardingRules`` of (model, par).

    On a mesh the model is split by the rules (``shard_model``, unless it
    holds shards already), so that its prefill and the step keep each
    rank's caches in those placements (``cache_spec``'s layout; the SSD and
    RG-LRU states whole). The step runs under the mesh when ``batch``
    divides over its batch dims (each rank then gives its rows), else on
    the whole batch on every rank, as the JAX package's specs replicate it."""
    rules = ShardingRules(model.cfg, par)
    if mesh is None:
        return ServeStep(model), None, rules
    if not getattr(model, "sharded", False):
        shard_model(model, mesh, rules)
    cache_sh, _ = cache_shardings(model.cfg, par, mesh, batch, max_len,
                                  dtype_of(model.cfg.act_dtype))
    n = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in batch_dims(mesh))
    return ServeStep(model, mesh if batch % n == 0 else None), cache_sh, rules


def greedy_decode(model: Model, caches: List[Cache], token: torch.Tensor,
                  start_pos: int, steps: int, embeds: Optional[torch.Tensor] = None, *,
                  step: Optional[ServeStep] = None, graph: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Feeds ``token`` [B] at ``start_pos`` and decodes ``steps`` tokens;
    with ``embeds`` [B, 1, d] that embedding is fed at every step instead.
    The steps go through ``step`` (a new ``ServeStep`` if None): its graph
    on the card, or with ``graph=False`` its eager step.

    Returns (tokens [B, steps], logits of the last step [B, V], or None
    when ``steps`` is 0)."""
    step = step or ServeStep(model)
    out, logits = [], None
    for t in range(steps):
        inp = token if embeds is None else embeds
        if graph:
            caches, token = step(caches, inp, start_pos + t)
        else:
            caches, token, logits = step.eager(caches, inp, start_pos + t)
        out.append(token)
    if not out:
        return token.new_empty((token.shape[0], 0)), None
    return torch.stack(out, dim=1), (step.logits.clone() if graph else logits)


def greedy_generate(model: Model, prompt: torch.Tensor, *, max_new: int = 32,
                    max_len: int = 0) -> torch.Tensor:
    """Prefill ``prompt`` (tokens [B, S] or embeds [B, S, d]), then decode
    greedily through a ``ServeStep``; returns [B, max_new]."""
    s = prompt.shape[1]
    caches, logits = model.prefill(prompt, max_len=max_len or (s + max_new))
    token = torch.argmax(logits, dim=-1)
    last = None if model.cfg.embed_inputs else prompt[:, -1:]
    rest, _ = greedy_decode(model, caches, token, s, max_new - 1, last)
    return torch.cat([token[:, None], rest], dim=1)
