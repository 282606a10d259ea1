"""Per-rank analysis of one run of a step: collective bytes classified
inter-pod vs intra-pod, FLOPs, HBM bytes and peak memory; the counterpart of
``repro.launch.hlo_analysis``.

JAX's analysis parses the compiled HLO of a step. The port has no compiled
module, so it records the step as it runs, eagerly, on ``meta`` tensors over
a fake process group (``launch.mesh.make_production_mesh``): ``record``
runs the block under one dispatch mode of its own, which sees every aten op
and every c10d or functional collective, and counts

  * each collective with its process group and its result bytes;
  * the FLOPs of each op that ``FlopCounterMode``'s formulas cover (the
    matmuls, as JAX counts its dot FLOPs), by those formulas;
  * each op's HBM bytes;
  * the live bytes of every storage the ops make, and their peak, as
    ``MemTracker`` counts them (``tests/test_torch_op_analysis.py`` holds the
    two counts equal): MemTracker walks every live tensor at every op, which
    made a 24-layer step take minutes;

and, beside the mode, the kernel ops' operations and bytes by formula
(``kernels.cost``), as they run no arithmetic on ``meta``.

What is not equivalent:

  * Collectives are classified by the mesh dims of their group, read from
    its ranks: a group that spans "pod" is inter-pod. The tensor-parallel
    step's own (``parallel.tensor``: activations all-reduced over "model",
    ZeRO-3's gathers and reduce-scatters over "data") are c10d collectives
    on the mesh's groups like the gradients', and are counted so. That is exact, where
    JAX infers the dims from group sizes ({2, 32, 512} span the pod).
  * No loop needs a trip count: an eager step runs every iteration, and each
    collective is recorded each time it runs. ``num_collectives`` counts the
    distinct (kind, group, result bytes), as JAX counts an instruction in a
    loop body once.
  * ``hlo_dot_flops_per_device`` (JAX's name, kept for the readers of the
    cells) is the formulas' count plus the kernel ops'; ``hlo_hbm_bytes_per_
    device`` counts, for every op that is not a view, each distinct tensor
    among its operands and results once (the eager program's traffic: no
    fusion), and the kernel ops' bytes by formula.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost


@dataclass
class Collective:
    kind: str
    group_size: int
    result_bytes: int
    count: int = 1
    dims: Tuple[str, ...] = ()      # the mesh dims its group spans

    def wire_bytes_per_device(self) -> float:
        g = max(self.group_size, 1)
        r = self.result_bytes
        if self.kind == "all-reduce":
            return 2.0 * r * (g - 1) / g
        if self.kind == "all-gather":
            return r * (g - 1) / g
        if self.kind == "reduce-scatter":
            return r * (g - 1)          # result is the scattered shard
        if self.kind == "all-to-all":
            return r * (g - 1) / g
        return float(r)                 # collective-permute


# op name fragments -> JAX's collective kinds
_KINDS = (("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
          ("all_reduce", "all-reduce"), ("allgather", "all-gather"),
          ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
          ("all_to_all", "all-to-all"), ("broadcast", "broadcast"),
          ("send", "collective-permute"), ("recv", "collective-permute"))
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "_c10d_functional_autograd")
# ops that move no bytes: views without the view tag, allocation, wrappers
_FREE = {"_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "wait_tensor", "_wrap_tensor_autograd",
         "barrier", "monitored_barrier", "_local_scalar_dense", "set_"}


def _kind(name: str) -> Optional[str]:
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return None


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or results (tensors, lists and
    tuples of them, dicts of keyword arguments)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    out = []
    for x in tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple, dict)):
            out.extend(_tensors(x))
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _flop_formulas() -> dict:
    """``FlopCounterMode``'s formulas by op (each takes the op's arguments
    and ``out_val``)."""
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False).flop_registry


class _OpMode(TorchDispatchMode):
    """Sees every op: collectives with their groups, FLOPs, bytes, and the
    storages each op makes (live until their last tensor goes)."""

    def __init__(self, rec: "Recording"):
        super().__init__()
        self.rec = rec
        self.formulas = _flop_formulas()
        self.infos: dict = {}
        self.live: Dict[int, int] = {}
        self.finalizers: list = []

    def track(self, t: torch.Tensor) -> None:
        """Counts ``t``'s storage among the live bytes until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.rec.live_bytes += n
        self.rec.peak_bytes = max(self.rec.peak_bytes, self.rec.live_bytes)
        self.finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key: int) -> None:
        self.rec.live_bytes -= self.live.pop(key)

    def __exit__(self, *exc):
        for f in self.finalizers:
            f.detach()
        return super().__exit__(*exc)

    def _info(self, func) -> tuple:
        """(name, moves no bytes, is a collective, FLOP formula) of an op."""
        info = self.infos.get(func)
        if info is None:
            name = func.__name__.split(".")[0]
            info = (name, func.is_view or name in _FREE, func.namespace in _COLLECTIVE_NS,
                    self.formulas.get(func._overloadpacket))
            self.infos[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name, free, collective, formula = self._info(func)
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if formula is not None:
            self.rec.flops += formula(*args, **kwargs, out_val=out)
        if collective:
            self._collective(func, name, args, kwargs, out)
        if free:
            return out
        seen, nbytes = set(), 0
        for t in _tensors(args) + _tensors(kwargs) + outs:
            if id(t) not in seen:
                seen.add(id(t))
                nbytes += t.numel() * t.element_size()
        self.rec.hbm_bytes += nbytes
        self.rec.by_op[name] = self.rec.by_op.get(name, 0.0) + nbytes
        return out

    def _collective(self, func, name, args, kwargs, out) -> None:
        kind = _kind(name)
        if kind is None:
            return
        if func.namespace == "c10d":      # in place: the result is the first argument
            pg = next(dist.ProcessGroup.unbox(a) for a in args
                      if isinstance(a, torch.ScriptObject)
                      and "ProcessGroup" in a._type().qualified_name())
            result = _nbytes(_tensors(args[0]))
        else:                              # functional: the group's name is its last str
            from torch.distributed.distributed_c10d import _resolve_process_group
            pg = _resolve_process_group([a for a in (*args, *kwargs.values())
                                         if isinstance(a, str)][-1])
            result = _nbytes(_tensors(out))
        self.rec.add_collective(kind, pg, result)


@dataclass
class Recording:
    """What one run recorded (per rank). ``mesh`` names the dims of each
    collective's group; without one, every group spans no named dim."""
    mesh: object = None
    flops: float = 0.0               # by FlopCounterMode's formulas
    hbm_bytes: float = 0.0
    live_bytes: int = 0
    peak_bytes: int = 0              # the peak of live_bytes
    by_op: Dict[str, float] = field(default_factory=dict)
    collectives: List[Collective] = field(default_factory=list)
    kernel_ops: Dict[str, Dict[str, float]] = field(default_factory=dict)
    _dims: Dict[str, tuple] = field(default_factory=dict)
    _coords: Dict[int, tuple] = field(default_factory=dict)
    _seen: Dict[tuple, Collective] = field(default_factory=dict)

    def __post_init__(self) -> None:
        # each global rank's coordinates on the mesh (read here, outside the
        # dispatch mode, which would record the tensor ops)
        if self.mesh is not None:
            for idx, r in np.ndenumerate(self.mesh.mesh.numpy()):
                self._coords[int(r)] = idx

    def add_collective(self, kind: str, pg, result_bytes: int) -> None:
        key = (kind, self._group_dims(pg), pg.size(), result_bytes)
        if key in self._seen:
            self._seen[key].count += 1
            return
        self._seen[key] = Collective(kind, pg.size(), result_bytes, dims=key[1])
        self.collectives.append(self._seen[key])

    def _group_dims(self, pg) -> tuple:
        """The mesh dims along which the group's ranks differ."""
        key = pg.group_name
        if key not in self._dims:
            dims = ()
            if self.mesh is not None:
                coords = [self._coords[r] for r in dist.get_process_group_ranks(pg)]
                dims = tuple(n for d, n in enumerate(self.mesh.mesh_dim_names)
                             if len({c[d] for c in coords}) > 1)
            self._dims[key] = dims
        return self._dims[key]

    def add_kernel_op(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernel_ops.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    @property
    def total_flops(self) -> float:
        return self.flops + sum(k["flops"] for k in self.kernel_ops.values())

    @property
    def total_hbm_bytes(self) -> float:
        return self.hbm_bytes + sum(k["bytes"] for k in self.kernel_ops.values())


@contextlib.contextmanager
def record(mesh=None, track: tuple = ()) -> Iterator[Recording]:
    """Records the block into a ``Recording``. ``track`` (modules, whose
    parameters and buffers count, and tensors that exist before the block:
    optimizer state, inputs) counts toward the live bytes from the start.
    Collectives on groups of ``mesh`` are classified by its dims."""
    rec = Recording(mesh=mesh)
    mode = _OpMode(rec)
    for x in track:
        for t in (list(x.parameters()) + list(x.buffers())
                  if isinstance(x, torch.nn.Module) else [x]):
            mode.track(t)
    with mode, cost.recording(rec.add_kernel_op):
        yield rec


def collective_summary(rec: Recording, multi_pod: bool) -> dict:
    """JAX's keys (``repro.launch.hlo_analysis.collective_summary``), per rank."""
    inter = intra = 0.0
    by_kind: Dict[str, float] = {}
    for c in rec.collectives:
        b = c.wire_bytes_per_device() * c.count
        by_kind[c.kind] = by_kind.get(c.kind, 0.0) + b
        if multi_pod and "pod" in c.dims:
            inter += b
        else:
            intra += b
    return {
        "collective_bytes_per_device": inter + intra,
        "inter_pod_bytes_per_device": inter,
        "intra_pod_bytes_per_device": intra,
        "by_kind": by_kind,
        "num_collectives": len(rec.collectives),
        "hlo_dot_flops_per_device": rec.total_flops,
        "hlo_hbm_bytes_per_device": rec.total_hbm_bytes,
    }


def op_breakdown(rec: Recording, top: int = 20) -> list:
    """[(op, bytes)] by aten op (the kernel ops under their names), the
    largest first: where the bytes go."""
    totals = dict(rec.by_op)
    for name, k in rec.kernel_ops.items():
        totals[name] = totals.get(name, 0.0) + k["bytes"]
    return sorted(totals.items(), key=lambda kv: -kv[1])[:top]
