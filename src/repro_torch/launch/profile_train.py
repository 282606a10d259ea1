"""Where a training step's time goes on the card, for one arch's default workload.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch mamba2-370m] [--trace-dir DIR]

The workload is the one ``python -m repro_torch.launch.train --arch ARCH``
runs with no other arguments (``launch.train.TRAIN_WORKLOADS``; qwen1.5-0.5b
by default: batch 8 x 2048 tokens, remat "block"). After one warm-up step,
one step runs unprofiled (host clock after a synchronise: wall time) and one
under ``torch.profiler`` (kernel time by name, kernel count), each on the
same batch, as ``launch.profile_serve`` measures a phase. The device's idle
share is 1 - kernel time / wall time. Also read: the port's kernel launches
a step (their wrappers' counts) and their device time by name (the
profiled step), the peak device memory, and the model-FLOPs
share 6 * active parameters * tokens / wall time / 989 TFLOP/s (the bf16
dense peak of the H100 SXM; an MoE's active parameters count k of each
layer's E experts, ``Model.active_param_count``). Prints one JSON line. Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.cost import PEAK_FLOPS_BF16
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rglru_scan import rglru_scan_fwd
from repro_torch.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.launch import train as launch_train
from repro_torch.launch.profile_serve import measure
from repro_torch.train.data import SyntheticDataset
from repro_torch.train.optimizer import init_adam
from repro_torch.train.train_step import train_step

KERNELS = {"flash_attention": flash_attention_fwd, "ssd_scan": ssd_scan_fwd,
           "rglru_scan": rglru_scan_fwd}
PORT_KERNEL_NAMES = ("fa_fwd", "ssd_bf16_kernel", "ssd_f32_kernel", "rglru_")   # in csrc/


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=launch_train.ARCH,
                    choices=sorted(launch_train.TRAIN_WORKLOADS))
    ap.add_argument("--trace-dir", default="")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    model, train_cfg, par = launch_train.setup(args.arch, device=dev)
    batch = SyntheticDataset(model.cfg, train_cfg, device=dev).batch_at(0)
    state = {"opt": init_adam(dict(model.named_parameters()), par.opt_state_dtype)}

    def step(_) -> None:
        state["opt"], metrics = train_step(model, state["opt"], batch, par, train_cfg)

    step(None)                                    # warm-up
    for fn in KERNELS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    trace = Path(args.trace_dir) / "train_step.json" if args.trace_dir else None
    out = measure(step, dev, trace, top=100_000)  # two steps: wall, then profiled
    out["port_kernels"] = [k for k in out["top"] if any(n in k["name"] for n in PORT_KERNEL_NAMES)]
    out["top"] = out["top"][:12]
    params, active = sum(p.numel() for p in model.parameters()), model.active_param_count()
    tokens = train_cfg.global_batch * train_cfg.seq_len
    out.update(
        arch=args.arch, batch=train_cfg.global_batch, seq=train_cfg.seq_len, remat=par.remat,
        device=torch.cuda.get_device_name(dev), params=params, active_params=active,
        tokens_per_s=tokens / (out["wall_ms"] / 1e3),
        model_flops_share=6.0 * active * tokens / (out["wall_ms"] / 1e3) / PEAK_FLOPS_BF16,
        kernel_launches_per_step={k: fn.launches / 2 for k, fn in KERNELS.items()},
        peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
