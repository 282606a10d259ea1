"""Layer-by-layer readers of the card checks (``chip_smoke.py``), shared with
their CPU rehearsals in ``tests/``.

* ``split_vs_whole``: one layer split over "model" against the same layer
  whole, on the same weights, input and output gradient: the largest error
  of its output, of its input's gradient and of each parameter's gradient
  (this rank's shard against the same slice of the whole gradient), each
  relative to the largest value of its reference, the largest over the
  ranks.
* ``keep_blocks``: a context that keeps, for each chosen block of a
  model's forward, the inputs and outputs of its two parts (the mixer and
  its new cache; the MLP) on the CPU.
* ``replay_blocks``: each kept block run again by a CPU copy of that block
  (its shards and its collectives, where it is split), each part on the
  card's input to it, and the share of each part's outputs more than one
  bf16 step from the replay (``over_one_step``).
"""
from __future__ import annotations

import contextlib
import copy
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref| (in f64)."""
    got, ref = got.detach().double(), ref.detach().double()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


# ---------------------------------------------------------------------------
# A split layer against itself whole
# ---------------------------------------------------------------------------

def split_vs_whole(cfg, attr: str, make: Callable, run: Callable, mesh, par, *,
                   device="cpu", shape=(2, 48), seed: int = 1,
                   fault: Optional[Callable] = None) -> dict:
    """The layer ``make(cfg)`` (built under ``device``, its weights drawn
    from ``seed``) whole and split over "model" by the rules of (cfg,
    ``par``) on ``mesh``, on the same input x [*shape, d_model] (and token
    ids and labels [*shape]), through ``run(module, x, ids, labels)``, and
    the same output gradient. ``fault`` is a context factory planted around
    the split layer's forward. Returns {"out", "x_grad", "param_grad"} (the
    largest over the ranks of each relative error; "param_grad" the largest
    over the parameters), "param_grads" (name -> error), and "split" (the
    parameters that the rules split)."""
    from repro_torch.parallel.sharding import ShardingRules, named, shard_of
    from repro_torch.parallel.tensor import shard_model

    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    with torch.device(dev):
        whole = nn.Module()
        setattr(whole, attr, make(cfg))
    getattr(whole, attr).reset_parameters(gen.manual_seed(seed))
    split = copy.deepcopy(whole)
    rules = ShardingRules(cfg, par)
    shard_model(split, mesh, rules)
    gen.manual_seed(seed + 1)
    x = torch.randn((*shape, cfg.d_model), generator=gen, device=dev)
    ids = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    labels = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    labels[0, :5] = -1
    outs = {}
    for tag, h in (("whole", whole), ("split", split)):
        xi = x.clone().requires_grad_(True)
        ctx = fault() if tag == "split" and fault is not None else contextlib.nullcontext()
        with ctx:
            y = run(getattr(h, attr), xi, ids, labels)
            gy = torch.randn(y.shape, generator=gen.manual_seed(seed + 2), device=dev)
            g = torch.autograd.grad((y * gy).sum(), [xi, *h.parameters()])
        outs[tag] = (y.detach(), g[0], dict(zip([n for n, _ in h.named_parameters()], g[1:])))
        del y, g
    (yw, xw, gw), (ys, xs, gs) = outs["whole"], outs["split"]
    pl = {n: named(mesh, rules.param_spec(n, p.dim())).placements
          for n, p in whole.named_parameters()}
    names = sorted(gw)
    errs = [rel_err(ys, yw), rel_err(xs, xw)] + [rel_err(gs[n], shard_of(gw[n], mesh, pl[n]))
                                                 for n in names]
    t = torch.tensor(errs, dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    by_name = dict(zip(names, t[2:].tolist()))
    split_names = sorted(n for n, p in split.named_parameters()
                         if p.shape != dict(whole.named_parameters())[n].shape)
    return {"out": float(t[0]), "x_grad": float(t[1]), "param_grad": max(by_name.values()),
            "param_grads": by_name, "split": split_names}


# ---------------------------------------------------------------------------
# Blocks replayed in bf16
# ---------------------------------------------------------------------------

def _step(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |t| (f32)."""
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126))) - 7)


def over_one_step(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of ``a``'s elements more than one bf16 step from ``b``'s,
    each step that of the larger of the element and the root mean square of
    ``b``: an output that cancellation made small is read in the steps of
    the tensor's scale, where one changed rounding upstream moves it by many
    of its own."""
    a, b = a.detach().cpu().float(), b.detach().cpu().float()
    rms = b.square().mean().sqrt()
    return float(((a - b).abs() > torch.maximum(_step(b), _step(rms))).float().mean())


def mixer_of(block: nn.Module) -> nn.Module:
    """A block's mixer: its attention, SSD or RG-LRU."""
    return next(m for m in (block.attn, block.ssd, block.rglru) if m is not None)


def _cpu(t):
    if torch.is_tensor(t):
        return t.detach().to("cpu", copy=True)
    if isinstance(t, dict):
        return {k: _cpu(v) for k, v in t.items()}
    return t


@contextlib.contextmanager
def keep_blocks(model: nn.Module, layers: Optional[Iterable[int]] = None):
    """Inside the context the first forward of each chosen block of
    ``model`` (``model.backbone.layers``; default every one) is kept: yields
    {layer: {"x": the block's input, "kwargs": its keyword arguments but the
    cache, "mixer": the mixer's output, "cache": the mixer's new cache,
    "mlp_in": the input of the MLP's norm (the block's input plus the
    mixer's output), "mlp": the MLP's output}} on the CPU (no MLP: no
    "mlp_in", "mlp")."""
    blocks = model.backbone.layers
    kept: Dict[int, dict] = {}
    hooks = []

    def on(i):
        def pre(mod, args, kwargs):
            if i not in kept:
                kept[i] = {"x": _cpu(args[0]),
                           "kwargs": {k: v for k, v in kwargs.items() if k != "cache"}}

        def mixer(mod, args, out):
            if "mixer" not in kept[i]:
                kept[i]["mixer"], kept[i]["cache"] = _cpu(out[0]), _cpu(out[1])

        def mlp_in(mod, args):
            kept[i].setdefault("mlp_in", _cpu(args[0]))

        def mlp(mod, args, out):
            kept[i].setdefault("mlp", _cpu(out))
        return pre, mixer, mlp_in, mlp

    for i in range(len(blocks)) if layers is None else layers:
        block = blocks[i]
        pre, mixer, mlp_in, mlp = on(i)
        hooks += [block.register_forward_pre_hook(pre, with_kwargs=True),
                  mixer_of(block).register_forward_hook(mixer)]
        if block.mlp is not None:
            hooks += [block.norm2.register_forward_pre_hook(mlp_in),
                      block.mlp.register_forward_hook(mlp)]
    try:
        yield kept
    finally:
        for h in hooks:
            h.remove()


def cpu_block(block: nn.Module) -> nn.Module:
    """A copy of ``block`` on the CPU: the same values (this rank's shards,
    where it is split) and the same marks (its splits' process groups are
    shared, not copied)."""
    memo = {}
    for m in block.modules():
        for attr in ("tp", "seq_split"):
            s = getattr(m, attr, None)
            if s is not None:
                memo[id(s)] = s
        m.__dict__.pop("f32_copies", None)
    return copy.deepcopy(block, memo).to("cpu").eval()


@torch.no_grad()
def replay(block: nn.Module, rec: dict) -> dict:
    """The parts of ``block`` (a CPU copy) each on the card's input to that
    part in ``rec``, so that nothing compounds from one part to the next:
    the mixer (and its new cache) on the block's input, the MLP on the
    block's input plus the card's mixer output."""
    kwargs = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in rec["kwargs"].items()
              if block.attn is not None or k == "mode"}
    out, cache = mixer_of(block)(block.norm1(rec["x"]), cache=None, **kwargs)
    again = {"mixer": out, "cache": cache}
    if "mlp" in rec:
        again["mlp"] = block.mlp(block.norm2(rec["mlp_in"]))
    return again


def block_readings(rec: dict, again: dict, cache_keys=()) -> dict:
    """The card's parts of a block (``rec``) against their replay
    (``again``): the mixer's and the MLP's outputs, ``over_one_step``; each
    of ``cache_keys`` of the mixer's new cache, ``over_one_step`` for bf16
    entries and max abs err / max |replay| for f32 ones."""
    out = {k: over_one_step(rec[k], again[k]) for k in ("mixer", "mlp") if k in rec}
    for k in cache_keys:
        a, b = rec["cache"][k], again["cache"][k]
        out[f"cache {k}"] = (over_one_step(a, b) if b.dtype == torch.bfloat16
                             else rel_err(a, b))
    return out


def replay_blocks(model: nn.Module, kept: Dict[int, dict], cache_keys=()) -> Dict[int, dict]:
    """Each kept block of ``model`` replayed by its CPU copy (made and
    dropped one block at a time) on the card's inputs: {layer:
    ``block_readings``}. Where the blocks are split, every rank replays the
    same layers in the same order, so that their collectives pair up."""
    out = {}
    for i in sorted(kept):
        block = cpu_block(model.backbone.layers[i])
        out[i] = block_readings(kept[i], replay(block, kept[i]), cache_keys)
        del block
    return out
