"""Multi-rank harness of the parallel-layer tests: the port on 8 gloo ranks
of a (2, 2, 2) ("pod", "data", "model") mesh, and the JAX package on 8
forced host devices, each in a subprocess.

``run_ranks(job, args, out)`` spawns 8 CPU processes (``torch.distributed``
with gloo over localhost) that each run ``JOBS[job](mesh, args)``; rank 0's
return value is saved with ``torch.save`` to ``out``. ``shape`` and ``axes``
give another mesh (the ranks are its size): the tensor-parallel layer cases
run on 2 ranks of a (1, 2) ("data", "model") mesh. ``run_fake(job, args,
out, shape, axes)`` runs the job once, as rank 0 of a fake process group of
the mesh's ranks (``launch.mesh.fake_mesh``; its collectives move no data),
in a subprocess. ``run_jax(script,
out)`` runs a JAX script with 8 host devices, which writes its results to
``out``. Both raise with the subprocess's output when it fails.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
TIMEOUT_S = 300     # each subprocess's limit, as tests/test_parallel.py's


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, job: str, args: dict, out: str, port: int,
               shape=(2, 2, 2), axes=("pod", "data", "model")) -> None:
    import math
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=math.prod(shape))
    try:
        mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))
        result = JOBS[job](mesh, args)
        if rank == 0:
            torch.save(result, out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(job: str, args: dict, out: Path, shape=(2, 2, 2),
              axes=("pod", "data", "model")):
    """Runs ``job`` on the gloo ranks of a ``shape`` mesh (8 by default) in a
    subprocess; returns rank 0's result."""
    n = 1
    for k in shape:
        n *= k
    script = textwrap.dedent(f"""
        import sys, warnings
        warnings.simplefilter("ignore")
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT / 'tests')!r}]
        import torch.multiprocessing as mp
        import torch_mesh_harness as h
        if __name__ == "__main__":
            mp.spawn(h._rank_main, args=({job!r}, h.load_args({str(out)!r}), {str(out)!r},
                                         h._free_port(), {tuple(shape)!r}, {tuple(axes)!r}),
                     nprocs={n})
    """)
    torch.save(args, str(out) + ".args")
    _run([sys.executable, "-c", script])
    return torch.load(out, weights_only=False)


def run_fake(job: str, args: dict, out: Path, shape=(2, 2, 2),
             axes=("pod", "data", "model")):
    """Runs ``job`` as rank 0 of a fake group of ``shape``'s ranks in a
    subprocess; returns its result."""
    script = textwrap.dedent(f"""
        import sys, warnings
        warnings.simplefilter("ignore")
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT / 'tests')!r}]
        import torch
        import torch_mesh_harness as h
        from repro_torch.launch.mesh import fake_mesh
        mesh = fake_mesh({tuple(shape)!r}, {tuple(axes)!r}, "cpu")
        torch.save(h.JOBS[{job!r}](mesh, h.load_args({str(out)!r})), {str(out)!r})
    """)
    torch.save(args, str(out) + ".args")
    _run([sys.executable, "-c", script])
    return torch.load(out, weights_only=False)


def load_args(out: str) -> dict:
    return torch.load(out + ".args", weights_only=False)


def run_jax(script: str, out: Path) -> dict:
    """Runs a JAX script on 8 host devices; it saves a dict of numpy arrays
    to ``OUT`` (a name it is given) with ``np.savez``."""
    head = textwrap.dedent(f"""
        import os, sys, warnings
        warnings.simplefilter("ignore")
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={WORLD}"
        os.environ["JAX_PLATFORMS"] = "cpu"
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT / 'tests')!r}]
        OUT = {str(out)!r}
    """)
    _run([sys.executable, "-c", head + textwrap.dedent(script)])
    with np.load(str(out), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _run(cmd) -> None:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=TIMEOUT_S,
                       env=env)
    if r.returncode != 0:
        raise AssertionError(f"subprocess exited {r.returncode}\n{r.stdout[-4000:]}\n"
                             f"{r.stderr[-8000:]}")


# ---------------------------------------------------------------------------
# Jobs: each runs on every rank; rank 0's return value is kept
# ---------------------------------------------------------------------------

def job_hierarchical(mesh, args: dict) -> dict:
    """tests/test_parallel.py's all-reduce inputs, plain and compressed."""
    from repro_torch.parallel import make_hierarchical_allreduce
    g = args["g"]
    errs = {k: torch.zeros(v.shape, dtype=torch.float32) for k, v in g.items()}
    out, _ = make_hierarchical_allreduce(mesh)(g, errs)
    outc, errc = make_hierarchical_allreduce(mesh, compress=True)(g, errs)
    return {"plain": out, "compressed": outc, "err": errc}


def job_grouped_moe(mesh, args: dict) -> dict:
    """The grouped MoE under the mesh (each rank its row of x) against the
    flat dispatch of the whole x (tests/test_parallel.py's MoE case)."""
    import torch.distributed as dist
    from repro_torch.config import get_model_config
    from repro_torch.models.moe import MoE
    from repro_torch.parallel import use_mesh
    from repro_torch.parallel.sharding import batch_dims
    from repro_torch.models.moe import _row_block

    cfg = dataclasses.replace(get_model_config("phi3.5-moe-42b-a6.6b", smoke=True),
                              act_dtype="float32", param_dtype="float32",
                              moe_capacity_factor=8.0)
    layer = MoE(cfg, device="cpu")
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    y_flat, aux_flat = layer(x)
    grouped = MoE(dataclasses.replace(cfg, moe_group_by_batch=True), device="cpu")
    grouped.load_state_dict(layer.state_dict())
    r = _row_block(mesh, batch_dims(mesh))
    with use_mesh(mesh):
        y, aux = grouped(x[r:r + 1])
    ys = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(ys, y.contiguous())
    # world ranks in mesh order: pod, data, model; rows by (pod, data)
    rows = torch.cat([ys[i * 2] for i in range(4)])
    return {"y_flat": y_flat.detach(), "y_grouped": rows.detach(),
            "aux": {k: float(v) for k, v in aux.items()}}


def job_all(mesh, args: dict) -> dict:
    return {"hierarchical": job_hierarchical(mesh, args),
            "grouped_moe": job_grouped_moe(mesh, args)}


def job_train(mesh, args: dict) -> dict:
    """One ``make_train_step`` step per arch on the mesh, from the given
    weights and batch: {arch: {"metrics", "params"}} (the params gathered
    whole from the ranks' shards)."""
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.models import build_model
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.optimizer import init_adam

    par = ParallelConfig(multi_pod=True, pods=2, data=2, model=2)
    out = {}
    for arch, (cfg, state, batch) in args["cases"].items():
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        _, _, jit_step, _ = make_train_step(model, par, TrainConfig(**args["train"]), mesh)
        params = dict(model.named_parameters())
        step = jit_step(params)
        params, opt = step.place(params, init_adam(params))
        params, opt, metrics = step(params, opt, batch)
        out[arch] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "params": {k: p.clone() for k, p in step.full(params).items()}}
    return out


def job_record_step(mesh, args: dict) -> dict:
    """The smoke qwen's mesh step on this rank's rows, under
    ``op_analysis.record``: on ``args["device"]`` ("cpu" on gloo ranks,
    "meta" on a fake group). Returns the collectives and the summary."""
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.launch.op_analysis import collective_summary, record
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.train_step import make_train_step

    dev = args["device"]
    par = ParallelConfig(multi_pod=True, pods=2, data=2, model=2, **args.get("par", {}))
    model = build_model(args["cfg"], device=dev)
    _, _, jit_step, _ = make_train_step(model, par, TrainConfig(), mesh)
    params = dict(model.named_parameters())
    step = jit_step(params)
    params, opt = step.place(params, init_adam({k: p.detach() for k, p in params.items()}))
    b, s = args["batch"]
    tokens = torch.zeros((b, s), dtype=torch.int64, device=dev)
    rows = step._rows({"tokens": tokens, "labels": tokens})
    with record(mesh) as rec:
        step.step_rows(params, opt, rows)
    return {"collectives": sorted((c.kind, c.dims, c.group_size, c.result_bytes, c.count)
                                  for c in rec.collectives),
            "summary": collective_summary(rec, multi_pod=True)}


def job_synthetic(mesh, args: dict) -> dict:
    """tests/test_hlo_analysis.py's SYNTHETIC module as a torch program on
    meta, instruction for instruction as JAX's analysis walks it: a
    [128, 256] @ [256, 32] matmul, an all-gather over "pod" of f32[64], and a
    loop of 12 all-reduces of f32[64] over "model", each with its reducer
    and the loop's s32 count. The reducer (``%add.1``) adds the all-reduce's
    elements in registers; JAX's walk counts it through ``to_apply`` as one
    f32[] add of 2 x 4 bytes, which the program has as an f32[] added to
    itself (one operand, one result)."""
    import torch.distributed._functional_collectives as funcol
    from repro_torch.launch.op_analysis import collective_summary, record

    meta = torch.device("meta")
    p0, p1, p2, r = (torch.empty(s, device=meta) for s in ((64,), (128, 256), (256, 32), ()))
    i = torch.empty((), dtype=torch.int32, device=meta)
    with record(mesh, (p0, p1, p2, r, i)) as rec:
        p1 @ p2
        funcol.all_gather_tensor(p0, 0, mesh.get_group("pod"))
        x = p0
        for _ in range(12):
            x = funcol.all_reduce(x, "sum", mesh.get_group("model"))
            r + r
            i = i + 1
    return {mp: collective_summary(rec, mp) for mp in (True, False)}


# ---------------------------------------------------------------------------
# Tensor-parallel compute: each split layer against itself whole, and the
# split train step
# ---------------------------------------------------------------------------

def _f32_config(arch: str, smoke: bool = True, **kw):
    from repro_torch.config import get_model_config
    return dataclasses.replace(get_model_config(arch, smoke=smoke), act_dtype="float32",
                               param_dtype="float32", **kw)


def tp_layer_cases(arch=None, smoke: bool = True) -> dict:
    """name -> (config, attribute, make(cfg), run(module, x, ids, labels)):
    one layer under the attribute name that its parameters' rules read,
    and the output (or loss) whose gradient the check takes. Without
    ``arch``, the smoke table of layer cases; with it, each layer that
    ``arch``'s blocks and embedding hold (its MLP, embedding and CE, its
    attention in the case that it takes, its SSD, its RG-LRU), in f32 at
    its published widths unless ``smoke``."""
    from repro_torch.config.base import ATTN, LOCAL_ATTN, MLP_MOE, MLP_NONE, RGLRU, SSD as SSD_
    from repro_torch.models.layers import MLP, Embed
    from repro_torch.models.model import chunked_ce_loss
    from repro_torch.models.moe import MoE
    from repro_torch.models.rglru import RGLRU as RGLRUMixer
    from repro_torch.models.ssm import SSD
    from repro_torch.models.transformer import Attention
    from repro_torch.parallel.tensor import split_of

    def mixer(m, x, ids, labels):
        return m(x, mode="train", cache=None)[0]

    def moe(m, x, ids, labels):
        y, aux = m(x)
        return y * (1.0 + aux["moe_lb_loss"] + aux["moe_z_loss"])

    def embed_ce(m, x, ids, labels):
        tot, _ = chunked_ce_loss(m(ids) + x, m.weight(), labels, m.cfg.logit_softcap,
                                 split_of(m))
        return tot

    kinds = {"mlp": ("mlp", lambda c: MLP(c, next(k for _, k in c.layer_blocks()
                                                  if k not in (MLP_NONE, MLP_MOE))),
                     lambda m, x, i, l: m(x)),
             "embed": ("embed", Embed, embed_ce),
             "attn": ("attn", lambda c: Attention(c, ATTN), mixer),
             "local attn": ("attn", lambda c: Attention(c, LOCAL_ATTN), mixer),
             "ssd": ("ssd", SSD, mixer),
             "rglru": ("rglru", RGLRUMixer, mixer),
             "moe": ("moe", MoE, moe)}

    def case(cfg, kind):
        attr, make, run = kinds[kind]
        return cfg, attr, make, run

    if arch is not None:
        cfg = _f32_config(arch, smoke=smoke)
        mixers, mlps = zip(*cfg.layer_blocks())
        names = {"mlp": any(k not in (MLP_NONE, MLP_MOE) for k in mlps), "embed": True,
                 "attn": ATTN in mixers, "local attn": LOCAL_ATTN in mixers,
                 "ssd": SSD_ in mixers, "rglru": RGLRU in mixers}
        return {kind: case(cfg, kind) for kind, held in names.items() if held}
    internlm = "internlm2-1.8b"
    return {
        "mlp swiglu": case(_f32_config("qwen1.5-0.5b"), "mlp"),
        "mlp relu2": case(_f32_config("nemotron-4-340b"), "mlp"),
        "embed and CE, tied, softcap": case(_f32_config("recurrentgemma-2b"), "embed"),
        "embed and CE, untied": case(_f32_config("deepseek-67b"), "embed"),
        "attention, q and kv heads split": case(_f32_config("qwen1.5-0.5b"), "attn"),
        "attention, kv heads whole, one a rank": case(
            _f32_config(internlm, num_kv_heads=1), "attn"),
        "attention, kv heads whole, one per q head": case(
            _f32_config(internlm, num_heads=6, num_kv_heads=3, head_dim=16), "attn"),
        "attention, q heads do not divide": case(
            _f32_config(internlm, num_heads=3, num_kv_heads=1, head_dim=16), "attn"),
        "local attention, kv heads whole": case(_f32_config("recurrentgemma-2b"), "local attn"),
        "ssd": case(_f32_config("mamba2-370m"), "ssd"),
        "rglru": case(_f32_config("recurrentgemma-2b"), "rglru"),
        "moe experts split": case(_f32_config("granite-moe-1b-a400m"), "moe"),
    }


# planted faults: each must make its case part from the whole layer
TP_PLANTED = {
    "wo all-reduce dropped": "attention, q and kv heads split",
    "gated-norm sum not reduced over model": "ssd",
    "RG-LRU gates read the local width only": "rglru",
    "MLP row-parallel all-reduce dropped": "mlp swiglu",
    "vocab-parallel CE sums not reduced over model": "embed and CE, tied, softcap",
    "SSD out_proj all-reduce dropped": "ssd",
}
# the layer kind (``tp_layer_cases(arch)``'s key) that each fault breaks
TP_PLANTED_KIND = {
    "wo all-reduce dropped": "attn",
    "gated-norm sum not reduced over model": "ssd",
    "RG-LRU gates read the local width only": "rglru",
    "MLP row-parallel all-reduce dropped": "mlp",
    "vocab-parallel CE sums not reduced over model": "embed",
    "SSD out_proj all-reduce dropped": "ssd",
}


def plant(fault: str):
    """A context that plants ``fault`` (TP_PLANTED) in the port's modules."""
    from repro_torch.models import layers, model, rglru, ssm, transformer

    def local_width_only(x, dim, tp):
        parts = [torch.zeros_like(x)] * tp.size
        parts[tp.rank] = x
        return torch.cat(parts, dim=dim)

    mlp_forward = layers.MLP.forward

    def mlp_unreduced(self, x):
        with patched(layers, "reduce_from_model", lambda x, tp: x):
            return mlp_forward(self, x)

    target = {"wo all-reduce dropped": (transformer, "reduce_from_model", lambda x, tp: x),
              "gated-norm sum not reduced over model": (ssm, "sum_over_model",
                                                        lambda x, tp: x * tp.size),
              "RG-LRU gates read the local width only": (rglru, "gather_from_model",
                                                         local_width_only),
              "MLP row-parallel all-reduce dropped": (layers.MLP, "forward", mlp_unreduced),
              "vocab-parallel CE sums not reduced over model": (
                  model, "reduce_from_model", lambda x, tp: x),
              "SSD out_proj all-reduce dropped": (ssm, "reduce_from_model",
                                                  lambda x, tp: x)}[fault]
    return patched(*target)


def patched(owner, name: str, fn):
    """A context in which ``owner.name`` is ``fn``."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        old = getattr(owner, name)
        setattr(owner, name, fn)
        try:
            yield
        finally:
            setattr(owner, name, old)
    return ctx()


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def job_tp_layers(mesh, args: dict) -> dict:
    """Each case of ``tp_layer_cases`` whole and split over "model" (the
    rules of a 1 x 2 mesh), on the same weights, input and output gradient
    (``readings.split_vs_whole``): the largest relative error over the
    ranks of the output, the input's gradient and each parameter's gradient
    (the split one against its shard of the whole one), and the names of
    the parameters split; then the planted faults' output errors. With
    ``args["archs"]``, also each of those archs' layer cases
    (``tp_layer_cases(arch)``, smoke) under "archs", and each fault of
    TP_PLANTED_KIND on the arch's layer of that kind under "arch_planted"."""
    from repro_torch.config import ParallelConfig
    from repro_torch.readings import split_vs_whole

    par = ParallelConfig(multi_pod=False, data=1, model=2)
    seeds = args.get("seeds", (1,))

    def run_case(case, fault=None, seed=seeds[0]):
        return split_vs_whole(*case, mesh, par, seed=seed,
                              fault=fault and (lambda: plant(fault)))

    out = {}
    if args.get("table", True):
        cases = tp_layer_cases()
        out = {name: run_case(case) for name, case in cases.items()}
        out["planted"] = {f: run_case(cases[name], f)["out"] for f, name in TP_PLANTED.items()}
    for arch in args.get("archs", ()):
        arch_cases = tp_layer_cases(arch)
        out.setdefault("archs", {})[arch] = {
            k: {seed: run_case(c, seed=seed) for seed in seeds} for k, c in arch_cases.items()}
        out.setdefault("arch_planted", {})[arch] = {
            f: (k, run_case(arch_cases[k], f)) for f, k in TP_PLANTED_KIND.items()
            if k in arch_cases}
    return out


def job_layer_readings(mesh, args: dict) -> dict:
    """``chip_smoke.py``'s split readers at the smoke configs of
    ``args["archs"]`` on this mesh's two ranks of "model": the per-layer
    split readings (``job_tp_layers`` with ``args``, under "layers") and the
    bf16 split prefill's layer replays (``chip_smoke.split_layer_replays``
    on a smoke model split by ``make_serve_step``, under "serve")."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.config import ParallelConfig
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.decode import make_serve_step

    out = {"layers": job_tp_layers(mesh, dict(args, table=False)), "serve": {}}
    par = ParallelConfig(multi_pod=False, data=1, model=2)
    for arch in args["archs"]:
        model = launch_serve.build(arch, smoke=True, device="cpu", seed=0)
        make_serve_step(model, par, mesh, 1, chip_smoke.TP_LAYER_LEN)
        out["serve"][arch] = chip_smoke.split_layer_replays(torch, model, mesh, arch)
    return out


def job_tp_train(mesh, args: dict) -> dict:
    """Two steps of the split ``make_train_step`` step on the (2, 2, 2)
    mesh for each case: {name: {"metrics": [step 1, step 2], "params": the
    params after step 2 gathered whole, "bad_shapes": the (rank, name) of
    every parameter or moment whose local shape is not the rules' shard
    shape, over all ranks, "whole_held": every split parameter some rank
    holds whole}}."""
    import torch.distributed as dist
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.launch.specs import shard_shape
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.train_step import make_train_step

    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    out = {}
    for name, (cfg, par_kw, state, batches) in args["cases"].items():
        par = ParallelConfig(multi_pod=True, pods=2, data=2, model=2, **par_kw)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        _, _, jit_step, rules = make_train_step(model, par, TrainConfig(**args["train"]), mesh)
        params = dict(model.named_parameters())
        whole = {k: tuple(p.shape) for k, p in params.items()}
        step = jit_step(params)
        params, opt = step.place(params, init_adam(params))
        bad, held = [], []
        for k, p in params.items():
            spec = rules.param_spec(k, p.dim())
            want = shard_shape(whole[k], spec, sizes)
            local = [tuple(p.shape), tuple(opt.m[k].to_local().shape),
                     tuple(opt.v[k].to_local().shape)]
            if any(sh != want for sh in local):
                bad.append((dist.get_rank(), k, local, want))
            if want != whole[k] and tuple(p.shape) == whole[k]:
                held.append((dist.get_rank(), k))
        metrics = []
        for batch in batches:
            params, opt, m = step(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (bad, held))
        out[name] = {"metrics": metrics,
                     "params": {k: p.clone() for k, p in step.full(params).items()},
                     "bad_shapes": [x for b, _ in every for x in b],
                     "whole_held": [x for _, h in every for x in h]}
    return out


# ---------------------------------------------------------------------------
# Serving on a mesh: each split mixer's prefill and decode against itself
# whole, and the split serve of whole models
# ---------------------------------------------------------------------------

def tp_serve_layer_cases() -> dict:
    """name -> (config, ParallelConfig changes, attribute, make(cfg)): one
    mixer whose prefill and decode the split-serve check runs."""
    from repro_torch.config.base import ATTN, LOCAL_ATTN
    from repro_torch.models.rglru import RGLRU
    from repro_torch.models.ssm import SSD
    from repro_torch.models.transformer import Attention

    internlm = "internlm2-1.8b"
    return {
        "attention, kv heads split": (_f32_config("qwen1.5-0.5b"), {}, "attn",
                                      lambda c: Attention(c, ATTN)),
        "attention, sequence split": (_f32_config(internlm, num_kv_heads=1), {}, "attn",
                                      lambda c: Attention(c, ATTN)),
        "attention, sequence split, time-minor K": (
            _f32_config(internlm, num_kv_heads=1, decode_k_time_minor=True), {}, "attn",
            lambda c: Attention(c, ATTN)),
        "attention, kv heads split, time-minor K": (
            _f32_config("qwen1.5-0.5b", decode_k_time_minor=True), {}, "attn",
            lambda c: Attention(c, ATTN)),
        "attention, kv heads whole, cache whole": (
            _f32_config(internlm, num_heads=6, num_kv_heads=3, head_dim=16),
            {"shard_cache_seq": False}, "attn", lambda c: Attention(c, ATTN)),
        "attention, kv heads whole, cache whole, time-minor K": (
            _f32_config(internlm, num_kv_heads=1, decode_k_time_minor=True),
            {"shard_cache_seq": False}, "attn", lambda c: Attention(c, ATTN)),
        "attention, q heads do not divide, sequence split": (
            _f32_config(internlm, num_heads=3, num_kv_heads=1, head_dim=16), {}, "attn",
            lambda c: Attention(c, ATTN)),
        "local attention, ring sequence split": (_f32_config("recurrentgemma-2b"), {}, "attn",
                                                 lambda c: Attention(c, LOCAL_ATTN)),
        "ssd": (_f32_config("mamba2-370m"), {}, "ssd", SSD),
        "rglru": (_f32_config("recurrentgemma-2b"), {}, "rglru", RGLRU),
    }


# planted faults of the split serve: each must make its case part from the
# whole mixer (its outputs, or its cache)
SERVE_PLANTED = {
    "combine dropped (rank-local softmax)": "attention, sequence split",
    "wrong sequence offset (every rank at 0)": "local attention, ring sequence split",
    "SSD state not gathered over model": "ssd",
}
SERVE_S0, SERVE_MAXLEN, SERVE_STEPS = 30, 64, 6   # decode crosses row 32, rank 1's first


def plant_serve(fault: str):
    """A context that plants ``fault`` (SERVE_PLANTED) in the port's modules."""
    import contextlib
    from repro_torch.models import attention, ssm

    def local_part_only(x, dim, tp):
        parts = [torch.zeros_like(x)] * tp.size
        parts[tp.rank] = x
        return torch.cat(parts, dim=dim)

    mod, name, fn = {
        "combine dropped (rank-local softmax)": (
            attention, "combine_partials", lambda m, l, acc, split: acc / l.clamp_min(1e-30)),
        "wrong sequence offset (every rank at 0)": (attention, "seq_part",
                                                    lambda split, rows: (0, rows)),
        "SSD state not gathered over model": (ssm, "gather_from_model", local_part_only),
    }[fault]

    @contextlib.contextmanager
    def ctx():
        old = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            yield
        finally:
            setattr(mod, name, old)
    return ctx()


def local_shard(t: torch.Tensor, spec, sizes: dict, coords: dict) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec`` as the port's caches hold it:
    each split dim cut into parts of ceil(n / ranks), the last zero-padded."""
    import torch.nn.functional as F
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (() if entry is None else (entry,))
        for a in axes:
            n, c = t.shape[d], -(-t.shape[d] // sizes[a])
            off = coords[a] * c
            part = t.narrow(d, min(off, n), max(0, min(c, n - off)))
            pad = [0, 0] * (t.dim() - d - 1) + [0, c - part.shape[d]]
            t = F.pad(part, pad)
    return t


def job_tp_serve_layers(mesh, args: dict) -> dict:
    """Each case of ``tp_serve_layer_cases`` whole and split over "model"
    (the rules of a 1 x 2 mesh) on the same weights: a prefill of
    ``SERVE_S0`` positions into caches of ``SERVE_MAXLEN``, then
    ``SERVE_STEPS`` decode steps (pos as a 0-d tensor). The largest relative
    error over the ranks of the outputs, and of each rank's cache against
    its shard of the whole cache under ``cache_spec`` after prefill and after
    the last step; whether every cache has the spec's local shape; then the
    planted faults' largest errors."""
    import copy
    import torch.distributed as dist
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.specs import shard_shape
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.parallel.tensor import shard_model

    cases = tp_serve_layer_cases()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}

    def run_case(name, fault=None):
        cfg, par_kw, attr, make = cases[name]
        par = ParallelConfig(multi_pod=False, data=1, model=2, **par_kw)
        rules = ShardingRules(cfg, par)
        whole = torch.nn.Module()
        setattr(whole, attr, make(cfg))
        getattr(whole, attr).reset_parameters(torch.Generator().manual_seed(1))
        split = copy.deepcopy(whole)
        shard_model(split, mesh, rules)
        gen = torch.Generator().manual_seed(2)
        b = 2
        xs = torch.randn((b, SERVE_S0 + SERVE_STEPS, cfg.d_model), generator=gen)
        outs, caches = {}, {}
        with torch.no_grad():
            for tag, h in (("whole", whole), ("split", split)):
                layer = getattr(h, attr)

                kw = ({"max_len": SERVE_MAXLEN} if attr == "attn" else {},
                      lambda t: {"pos": torch.tensor(SERVE_S0 + t)} if attr == "attn" else {})

                def go():
                    y, c = layer(xs[:, :SERVE_S0], mode="prefill", cache=None, **kw[0])
                    first = {k: t.clone() for k, t in c.items()}
                    ys = [y]
                    for t in range(SERVE_STEPS):
                        y, c = layer(xs[:, SERVE_S0 + t:SERVE_S0 + t + 1], mode="decode",
                                     cache=c, **kw[1](t))
                        ys.append(y)
                    return torch.cat(ys, dim=1), first, c
                if tag == "split" and fault is not None:
                    with plant_serve(fault):
                        outs[tag], first, last = go()
                else:
                    outs[tag], first, last = go()
                caches[tag] = (first, last)
        errs = [_rel(outs["split"], outs["whole"])]
        shapes_ok = True
        for i in range(2):
            for k, t in caches["split"][i].items():
                spec = rules.cache_spec(k, t.dim())
                ref = local_shard(caches["whole"][i][k], spec, sizes, coords)
                shapes_ok &= (tuple(t.shape) == shard_shape(tuple(caches["whole"][i][k].shape),
                                                              spec, sizes) == tuple(ref.shape))
                errs.append(_rel(t, ref) if t.shape == ref.shape else float("inf"))
        t = torch.tensor([errs[0], max(errs[1:]), float(not shapes_ok)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        layer = getattr(split, attr)
        return {"out": float(t[0]), "cache": float(t[1]), "shapes_ok": not bool(t[2]),
                "layout": ("seq" if getattr(layer, "seq_split", None) is not None else
                           "split" if getattr(layer, "tp", None) is not None else "whole")}

    out = {name: run_case(name) for name in cases}
    out["planted"] = {f: run_case(case, f) for f, case in SERVE_PLANTED.items()}
    return out


def job_tp_serve(mesh, args: dict) -> dict:
    """For each case ({name: (config, ParallelConfig changes, state, prompt
    [B, S0] int64)}): ``make_serve_step`` on the (2, 2, 2) mesh (which
    splits the model by the rules), a prefill of every rank's rows under
    ``use_mesh`` into caches of ``SERVE_MAXLEN``, then ``SERVE_STEPS`` greedy
    steps through ``step.eager``, each rank fed its own tokens. Returns
    {name: {"prefill": logits [B, V] of all rows, "logits": [steps, B, V],
    "tokens": [steps + 1, B], "bad_shapes": every (rank, layer, leaf, shape,
    want) whose cache is not ``cache_spec``'s local shape after prefill or
    decode, or whose ``model.init_cache`` is not the prefill's shape,
    "ranks_differ": whether the ranks of a "model" group returned different
    logits, "layouts": the set of each attention's cache layout, "refused":
    the error of the step's graph capture (rank 0's)}}."""
    import torch.distributed as dist
    from repro_torch.config import ParallelConfig
    from repro_torch.launch.specs import shard_shape
    from repro_torch.models import build_model
    from repro_torch.models.moe import _row_block
    from repro_torch.parallel import use_mesh
    from repro_torch.parallel.sharding import batch_dims
    from repro_torch.serve.decode import make_serve_step
    from repro_torch.serve.kvcache import cache_shape_specs

    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    dims = batch_dims(mesh)
    r = _row_block(mesh, dims)
    out = {}
    for name, (cfg, par_kw, state, prompt) in args["cases"].items():
        par = ParallelConfig(multi_pod=True, pods=2, data=2, model=2, **par_kw)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state)
        b = prompt.shape[0] // 4
        step, cache_sh, rules = make_serve_step(model, par, mesh, prompt.shape[0], SERVE_MAXLEN)
        rows = prompt[r * b:(r + 1) * b]
        with use_mesh(mesh):
            caches, logits = model.prefill(rows, max_len=SERVE_MAXLEN)
        bad = []

        def check_shapes(tag):
            whole = cache_shape_specs(cfg, prompt.shape[0], SERVE_MAXLEN, torch.float32)
            for i, (c, w) in enumerate(zip(caches, whole)):
                for k, t in c.items():
                    want = shard_shape(tuple(w[k].shape), rules.cache_spec(k, t.dim()), sizes)
                    if tuple(t.shape) != want:
                        bad.append((dist.get_rank(), tag, i, k, tuple(t.shape), want))
        check_shapes("prefill")
        fresh = model.init_cache(b, SERVE_MAXLEN)       # this rank's shards, zeroed
        for i, (c, f) in enumerate(zip(caches, fresh)):
            for k, t in c.items():
                if f[k].shape != t.shape:
                    bad.append((dist.get_rank(), "init_cache", i, k, tuple(f[k].shape),
                                tuple(t.shape)))
        token = torch.argmax(logits, -1)
        toks, step_logits = [token], []
        for t in range(SERVE_STEPS):
            caches, token, lg = step.eager(caches, token, SERVE_S0 + t)
            toks.append(token)
            step_logits.append(lg)
        check_shapes("decode")
        try:            # the capture a CUDA model's step would make: refused over gloo
            step._capture(caches, token)
            refused = ""
        except RuntimeError as e:
            refused = str(e)
        mine = (r, mesh.get_local_rank("model"), logits, torch.stack(step_logits),
                torch.stack(toks), bad)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        by_row = {}
        differ = False
        for rb, mr, lg, sl, tk, _ in every:
            if rb in by_row:
                differ |= not (torch.equal(lg, by_row[rb][0]) and torch.equal(sl, by_row[rb][1]))
            else:
                by_row[rb] = (lg, sl, tk)
        blocks = [by_row[i] for i in sorted(by_row)]
        attn = [m for m in model.modules() if hasattr(m, "time_minor")]
        out[name] = {"prefill": torch.cat([x[0] for x in blocks]),
                     "logits": torch.cat([x[1] for x in blocks], dim=1),
                     "tokens": torch.cat([x[2] for x in blocks], dim=1),
                     "bad_shapes": [x for e in every for x in e[5]],
                     "ranks_differ": differ,
                     "layouts": sorted({"seq" if getattr(m, "seq_split", None) is not None else
                                        "heads" if (getattr(m, "tp", None) is not None and
                                                    m.wk.shape[-1] < cfg.num_kv_heads
                                                    * cfg.resolved_head_dim)
                                        else "whole" for m in attn}),
                     "captures": step.captures, "refused": refused}
    return out


JOBS = {"all": job_all, "train": job_train, "record_step": job_record_step,
        "synthetic": job_synthetic, "tp_layers": job_tp_layers, "tp_train": job_tp_train,
        "tp_serve_layers": job_tp_serve_layers, "tp_serve": job_tp_serve,
        "layer_readings": job_layer_readings}
