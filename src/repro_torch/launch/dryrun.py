"""Multi-pod dry run: every (architecture x input-shape x mesh) cell on the
production mesh, per rank: memory, FLOPs, HBM bytes, collective bytes
(inter-pod vs intra-pod) and a three-term roofline; the port of
``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k --mesh single [--device cpu] [--out results/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu

JAX's dry run lowers and compiles each cell's step on 512 placeholder
devices and reads XLA's analyses. The port runs each cell's step once, on
``meta`` tensors (shapes, no storage, no arithmetic), as rank 0 of a fake
process group of the mesh's 256 or 512 ranks (``launch.mesh.
make_production_mesh``), under ``launch.op_analysis.record``. So a cell
measures the port's own step:

  * train cells run the step ``launch.train`` runs (``train_step.
    lower_train_step``: the ``ShardedStep``), with ``par.microbatches``,
    remat ``par.remat`` and this rank's rows of the global batch. Each rank
    holds exactly the rules' shards of the parameters and the moments and
    computes on them as GSPMD partitions the JAX step: tensor-parallel over
    "model" (heads, d_ff, experts, SSD heads, the RG-LRU width, the vocab;
    ``parallel.tensor``) and, under ``fsdp``, ZeRO-3 over "data"
    (``"tensor_parallel": true``). The kernel ops record each rank's local
    shapes (flash on its heads, the SSD scan on its heads, the RG-LRU on its
    width);
  * prefill cells run ``model.prefill(inputs, max_len=S)``, decode and
    long_decode cells one ``decode_step`` at position S - 1 (a Python int)
    and the argmax, on the model that ``parallel.tensor.shard_model`` split
    by the same rules, as the JAX package jits them with the parameters in
    the rules' shardings and the caches in ``cache_spec``'s: a serve cell is
    one rank's rows (the batch split over the batch axes where it divides,
    else replicated, as ``specs._batch_axes_or_none``; under ``use_mesh``
    when split, so that the MoE routes every rank's rows together), its
    shards of the parameters, and its caches in ``cache_spec``'s layout (K/V
    split by kv heads, or along the sequence over "model"; the SSD and
    RG-LRU states whole over "model"). Every cell is ``"tensor_parallel":
    true``.

Each cell's record keeps JAX's keys and adds ``argument_size_in_bytes_under_
rules`` (what the shards of the rules' specs hold, as GSPMD would place
them), ``params_init`` (the meta model's own count beside ``params`` =
``param_count()``), ``peak_bytes``, ``kernel_ops``, ``op_breakdown`` and
``tensor_parallel``. ``lower_s`` is the time to build the meta model and
specs, ``compile_s`` the meta run of the step (there is no compile);
``generated_code_size_in_bytes`` is 0. The memory keys split the peak of
live bytes as XLA splits a compiled step's: arguments, outputs that are not
arguments updated in place (``alias``), and temporaries (the rest of the
peak). The roofline constants are one H100's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from repro_torch.config import (
    SHAPES, ModelConfig, ParallelConfig, ShapeSpec, TrainConfig, get_model_config,
    get_parallel_config, list_archs, shape_applicable,
)
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.kernels import cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_analysis import collective_summary, op_breakdown, record
from repro_torch.launch.specs import (
    _batch_axes_or_none, decode_input_specs, mesh_sizes, params_and_opt_specs,
    prefill_input_specs, shard_shape, train_input_specs, tree_bytes,
)
from repro_torch.models.model import build_model
from repro_torch.parallel.sharding import ShardingRules, use_mesh
from repro_torch.parallel.tensor import shard_model
from repro_torch.serve.kvcache import cache_shape_specs
from repro_torch.train.train_step import lower_train_step

# One NVIDIA H100 SXM (its data sheet, at its 700 W limit)
PEAK_FLOPS = cost.PEAK_FLOPS_BF16   # 989e12 FLOP/s, dense bf16 on the tensor cores
HBM_BW = cost.PEAK_BYTES            # 3.35e12 B/s of HBM3
# Intra-pod: the per-GPU network rate, one 400 Gb/s NIC a GPU (DGX H100):
# a 16-wide mesh axis spans two 8-GPU NVLink domains, so a ring over it runs
# at the NIC's rate, not NVLink's
ICI_BW = 400e9 / 8.0
OTN_BW = 16 * 100e9 / 8.0           # inter-DC aggregate per pod pair (16 x 100G), as JAX's

META = torch.device("meta")


def _rows(t: torch.Tensor, spec, sizes: dict) -> torch.Tensor:
    """One rank's rows of ``t``: a meta tensor of its shard shape."""
    return torch.empty(shard_shape(tuple(t.shape), spec, sizes), dtype=t.dtype, device=META)


def _memory(rec, args: int, outputs: int, alias: int) -> dict:
    return {"argument_size_in_bytes": args, "output_size_in_bytes": outputs,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": max(rec.peak_bytes - args - (outputs - alias), 0),
            "generated_code_size_in_bytes": 0, "peak_bytes": rec.peak_bytes}


def run_train(model_cfg: ModelConfig, par: ParallelConfig, shape: ShapeSpec, mesh) -> dict:
    """The train step's analysis on ``mesh`` (a fake group's), per rank."""
    model = build_model(model_cfg, device=META, remat=par.remat)
    params_s, params_p, opt_s, opt_p = params_and_opt_specs(model, par)
    batch_s, batch_p = train_input_specs(model_cfg, par, shape)
    train = TrainConfig(global_batch=shape.global_batch, seq_len=shape.seq_len)
    step, _ = lower_train_step(model, par, train, mesh, params_p, batch_p)
    sizes = mesh_sizes(par)
    under_rules = (tree_bytes(params_s, params_p, sizes) + tree_bytes(opt_s, opt_p, sizes)
                   + tree_bytes(batch_s, batch_p, sizes))
    n_params = _count(model)
    params, opt = step.place(params_s, opt_s)      # the model now holds its shards
    rows = {k: _rows(v, batch_p[k], sizes) for k, v in batch_s.items()}
    moments = [t.to_local() for tree in (opt.m, opt.v) for t in tree.values()]
    state = tree_bytes(params) + sum(t.numel() * t.element_size() for t in moments)
    args = state + tree_bytes(rows)
    t0 = time.perf_counter()
    with record(mesh, (model, *moments, *rows.values())) as rec:
        step.step_rows(params, opt, rows)
    return {"rec": rec, "run_s": time.perf_counter() - t0, "params_init": n_params,
            "argument_size_in_bytes_under_rules": under_rules,
            **_memory(rec, args, outputs=state, alias=state)}


def run_serve(model_cfg: ModelConfig, par: ParallelConfig, shape: ShapeSpec, mesh) -> dict:
    """One rank's prefill, or decode step and argmax, on the split model:
    its rows of the batch, its shards of the parameters and of the caches
    (``cache_spec``'s layout), and the collectives the split makes."""
    model = build_model(model_cfg, device=META, remat=par.remat)
    params_s, params_p, _, _ = params_and_opt_specs(model, par, with_opt=False)
    sizes = mesh_sizes(par)
    axes = _batch_axes_or_none(par, shape.global_batch)
    b = shape.global_batch // math.prod(sizes[a] for a in axes or ())
    under_rules = tree_bytes(params_s, params_p, sizes)
    n_params = _count(model)
    rules = ShardingRules(model_cfg, par)
    shard_model(model, mesh, rules)                 # the model now holds its shards
    params = tree_bytes(dict(model.named_parameters()))
    # the MoE routes every rank's rows together when the batch is split
    ambient = use_mesh(mesh) if axes else contextlib.nullcontext()
    if shape.kind == "prefill":
        inp_s, inp_p = prefill_input_specs(model_cfg, par, shape)
        inp = _rows(inp_s, inp_p, sizes)
        under_rules += tree_bytes(inp_s, inp_p, sizes)
        t0 = time.perf_counter()
        with record(mesh, (model, inp)) as rec, ambient:
            caches, logits = model.prefill(inp, max_len=shape.seq_len)
        outputs, alias = tree_bytes(caches) + tree_bytes(logits), 0
        args = params + tree_bytes(inp)
    else:
        cache_s, cache_p, inp_s, inp_p, _ = decode_input_specs(model_cfg, par, shape)
        caches = cache_shape_specs(model_cfg, b, shape.seq_len, dtype_of(model_cfg.act_dtype),
                                   rules=rules)
        inp = _rows(inp_s, inp_p, sizes)
        under_rules += tree_bytes(cache_s, cache_p, sizes) + tree_bytes(inp_s, inp_p, sizes)
        cache_leaves = [t for c in caches for t in c.values()]
        t0 = time.perf_counter()
        with record(mesh, (model, inp, *cache_leaves)) as rec, ambient:
            caches, logits = model.decode_step(caches, inp, shape.seq_len - 1)
            tokens = torch.argmax(logits, -1)
        alias = tree_bytes(caches)
        outputs, args = alias + tree_bytes(tokens), params + alias + tree_bytes(inp)
    return {"rec": rec, "run_s": time.perf_counter() - t0, "params_init": n_params,
            "argument_size_in_bytes_under_rules": under_rules,
            **_memory(rec, args, outputs, alias)}


def _count(model) -> int:
    return sum(p.numel() for p in model.parameters())


def run_cell(arch: str, shape_name: str, multi_pod: bool, device: DeviceLike = None) -> dict:
    t0 = time.time()
    shape = SHAPES[shape_name]
    model_cfg = get_model_config(arch)
    par = get_parallel_config(arch, multi_pod=multi_pod)
    dev = resolve_device(device)
    chips = par.num_devices
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "kind": shape.kind,
        "params": model_cfg.param_count(),
        "active_params": model_cfg.active_param_count(),
        "tensor_parallel": True,
    }
    if not shape_applicable(model_cfg, shape):
        result["status"] = "SKIP(full-attention)"
        return result

    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    if shape.kind == "train":
        run = run_train(model_cfg, par, shape, mesh)
        tokens = shape.global_batch * shape.seq_len
        result["model_flops"] = 6.0 * model_cfg.active_param_count() * tokens
    else:
        run = run_serve(model_cfg, par, shape, mesh)
        tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
        result["model_flops"] = 2.0 * model_cfg.active_param_count() * tokens
    rec = run.pop("rec")
    compile_s = run.pop("run_s")
    result.update(run)
    result["cost_analysis"] = {"flops": rec.total_flops, "bytes accessed": rec.total_hbm_bytes}
    result.update(collective_summary(rec, multi_pod))
    result["kernel_ops"] = rec.kernel_ops
    result["op_breakdown"] = op_breakdown(rec, top=10)

    # ---- roofline terms (per device, seconds) ----
    flops_dev = result["hlo_dot_flops_per_device"]
    bytes_dev = result["hlo_hbm_bytes_per_device"]
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = bytes_dev / HBM_BW
    t_intra = result["intra_pod_bytes_per_device"] / ICI_BW
    # inter-pod: per-device bytes x 256 chips share the 16x100G OTN pipe
    inter_dev = result["inter_pod_bytes_per_device"]
    t_inter = inter_dev * 256 / OTN_BW if multi_pod else 0.0
    t_coll = t_intra + t_inter
    result["roofline"] = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_coll_intra_s": t_intra,
        "t_coll_inter_s": t_inter,
        "dominant": max(
            [("compute", t_compute), ("memory", t_memory),
             ("collective", t_coll)], key=lambda kv: kv[1])[0],
        "useful_flops_ratio": (result["model_flops"] / (chips * flops_dev)
                               if flops_dev else 0.0),
    }
    result["lower_s"] = round(time.time() - t0 - compile_s, 2)
    result["compile_s"] = round(compile_s, 2)
    result["status"] = "OK"
    return result


def cell_name(arch, shape, multi_pod):
    m = "multi" if multi_pod else "single"
    return f"{arch}__{shape}__{m}".replace("/", "_")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type: cuda (default; raises when no GPU "
                         "is visible) or cpu. The step runs on meta tensors either way")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = cell_name(arch, shape, mp)
                path = os.path.join(args.out, name + ".json")
                if os.path.exists(path) and not args.force:
                    print(f"[skip-cached] {name}")
                    continue
                print(f"[run] {name}", flush=True)
                try:
                    res = run_cell(arch, shape, mp, dev)
                except Exception as e:  # noqa: BLE001 - a cell's failure is its record
                    res = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": f"FAIL: {type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                with open(path, "w") as f:
                    json.dump(res, f, indent=1)
                st = res.get("status")
                rf = res.get("roofline", {})
                print(f"  -> {st} compile={res.get('compile_s', '-')}s "
                      f"dominant={rf.get('dominant', '-')}", flush=True)


if __name__ == "__main__":
    main()
