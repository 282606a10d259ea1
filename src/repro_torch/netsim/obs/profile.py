"""Launch profiling and run manifests of the port's runner, the torch twin
of the JAX package's ``netsim/obs/profile.py``.

  * ``profiled_traced_batch`` runs one launch of a sweep's plan through
    ``simulate_batch`` and fills a record with its timings and memory
    figures. There is no ahead-of-time compile on the card: capturing the
    launch's CUDA graphs stands in for it. The record's keys, which
    ``tools/obs_report.py`` reads, mean on the card:

      ``compile_s``       host seconds capturing the graphs (0 on the CPU,
                          where the steps run eagerly)
      ``compile_cached``  false: every launch captures its own graphs
      ``execute_s``       the replays' time by CUDA events (the host clock
                          around the eager steps on the CPU)
      ``backend``         ``cuda`` or ``cpu``
      ``argument_size_in_bytes``  the batch's stacked ``NetParams`` and
                          workload tensors
      ``temp_size_in_bytes``      the launch's peak
                          ``torch.cuda.max_memory_allocated`` (reset before
                          it) above what was allocated before it, less the
                          arguments
      ``output_size_in_bytes``    the returned final state and aux

    The three memory keys are omitted on the CPU.
  * ``git_rev`` / ``memory_figures`` are the helpers behind those figures.
  * ``write_manifest`` / ``read_manifest``: JSONL run manifests in the JAX
    package's schema, one header record (git rev, plan sha256 fingerprint,
    backend, grid summary) followed by one record per launch, so that
    ``tools/obs_report.py`` summarizes and diffs both packages' manifests.

Schema: every line is a JSON object with a ``record`` field, ``header``
for the first line and ``launch`` for the rest.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

MANIFEST_VERSION = 1


def git_rev(cwd: Optional[str] = None) -> str:
    """``git describe --always --dirty`` of the repo containing this file
    (or ``cwd``); ``"unknown"`` outside a checkout."""
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else "unknown"
    except Exception:
        return "unknown"


def tree_nbytes(tree) -> int:
    """Bytes of every tensor (or numpy array) leaf of a NamedTuple / dict /
    tuple tree."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(v) for v in tree)
    return 0


def memory_figures(arguments, outputs, peak_bytes: int) -> dict:
    """``argument_size_in_bytes`` and ``output_size_in_bytes`` of two trees,
    and ``temp_size_in_bytes``: the launch's peak allocation above what was
    allocated before it (``peak_bytes``), less the arguments."""
    args = tree_nbytes(arguments)
    return {"argument_size_in_bytes": args,
            "output_size_in_bytes": tree_nbytes(outputs),
            "temp_size_in_bytes": max(int(peak_bytes) - args, 0)}


def profiled_traced_batch(cfgs, wlp, scheme, horizon_us, period_slots,
                          profile: dict, *, device=None,
                          timing: Optional[dict] = None, **kw):
    """Run one launch (``simulate_batch(cfgs, wlp, scheme, horizon_us,
    period_slots, device=device, **kw)``), filling ``profile`` in place
    with ``compile_s`` / ``compile_cached`` / ``execute_s`` / ``backend``
    and, on the card, the memory figures (see the module docstring).
    ``timing`` receives ``simulate_batch``'s own timing dict. Returns the
    engine output."""
    from repro_torch.config.net import stack_net_params
    from repro_torch.device import resolve_device
    from repro_torch.netsim.fluid import simulate_batch
    from repro_torch.netsim.workload import as_workload_batch

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    timing = {} if timing is None else timing
    if cuda:
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    final, aux = simulate_batch(cfgs, wlp, scheme, horizon_us, period_slots,
                                device=dev, profile=timing, **kw)
    profile["compile_s"] = timing["capture_s"] if cuda else 0.0
    profile["compile_cached"] = False
    profile["execute_s"] = timing["run_ms"] / 1e3
    profile["backend"] = dev.type
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) - before
        args = (stack_net_params(list(cfgs), device="cpu"),
                [np.asarray(v, np.float32)
                 for v in as_workload_batch(wlp, len(cfgs))])
        profile.update(memory_figures(args, (final, aux), peak))
    return final, aux


def _json_safe(obj):
    """Round-trippable JSON: non-finite floats become strings, numpy
    scalars collapse to Python numbers."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, (int, str)):
        return obj
    if isinstance(obj, float):
        return obj if obj == obj and abs(obj) != float("inf") else str(obj)
    if hasattr(obj, "item"):
        return _json_safe(obj.item())
    return str(obj)


def write_manifest(path: str, header: dict, launches: list) -> str:
    """Write a JSONL run manifest: one ``record: "header"`` line, then one
    ``record: "launch"`` line per launch. Returns ``path``."""
    head = dict(header)
    head.setdefault("record", "header")
    head.setdefault("manifest_version", MANIFEST_VERSION)
    head.setdefault("git_rev", git_rev())
    head.setdefault("timestamp", time.strftime("%Y-%m-%dT%H:%M:%S"))
    lines = [head] + [dict(l, record="launch") for l in launches]
    with open(path, "w") as f:
        for rec in lines:
            f.write(json.dumps(_json_safe(rec), sort_keys=True) + "\n")
    return path


def read_manifest(path: str):
    """Read a JSONL manifest -> ``(header, launches)``. Tolerates a
    missing header (returns ``{}``) so partial files still summarize."""
    header, launches = {}, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("record") == "header":
                header = rec
            else:
                launches.append(rec)
    return header, launches
