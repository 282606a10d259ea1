"""Fault-tolerant checkpointing: the port of ``repro.train.checkpoint``.

Layout (one directory per step):
    <ckpt_dir>/step_000000123/
        manifest.json      step, paths, dtypes, shapes, extra
        arrays.npz         flattened leaves, gathered to the host, as raw bytes
    <ckpt_dir>/LATEST      -> "step_000000123"  (atomic pointer file)

Writes go to ``step_X.tmp`` and then ``os.replace()``: a crash mid-write
never corrupts the latest checkpoint. ``keep`` checkpoints are retained for
rollback. ``async_save`` serialises on a background thread, from host copies
taken before it starts. A tree is nested dicts (and tuples) of tensors. Each
leaf is stored as its raw bytes with its torch dtype's name in the manifest
(numpy has no bfloat16: a bf16 leaf goes through its uint16 bits), so a
restore is bit-exact.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import dtype_of

# torch dtypes numpy holds as they are; bfloat16 goes through uint16
_VIA_NUMPY = {torch.bfloat16: torch.int16}


def _flatten_with_paths(tree: Any, prefix: str = "") -> Tuple[List[str], List[torch.Tensor]]:
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        return [prefix[:-1]], [tree]
    paths, leaves = [], []
    for k, v in items:
        p, l = _flatten_with_paths(v, f"{prefix}{k}/")
        paths += p
        leaves += l
    return paths, leaves


def _unflatten_like(like: Any, leaves: list) -> Any:
    if isinstance(like, dict):
        return {k: _unflatten_like(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten_like(v, leaves) for v in like)
    return leaves.pop(0)


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    return t.view(_VIA_NUMPY.get(t.dtype, t.dtype)).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        paths, leaves = _flatten_with_paths(tree)
        dtypes = [str(t.dtype).removeprefix("torch.") for t in leaves]
        host_leaves = [_to_host(t) for t in leaves]
        if self._thread is not None:
            self._thread.join()        # the previous async save must finish
            self._thread = None
        args = (step, paths, dtypes, host_leaves, extra)
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=args)
            self._thread.start()
        else:
            self._write(*args)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, paths, dtypes, host_leaves, extra) -> None:
        name = f"step_{step:09d}"
        final = os.path.join(self.dir, name)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays = {f"a{i}": np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)
                  for i, leaf in enumerate(host_leaves)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "paths": paths,
            "dtypes": dtypes,
            "shapes": [list(l.shape) for l in host_leaves],
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic publish
        ptr_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(ptr_tmp, "w") as f:
            f.write(name)
        os.replace(ptr_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------- restore ----------------
    def latest_step(self) -> Optional[int]:
        ptr = os.path.join(self.dir, "LATEST")
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, step: Optional[int], like: Any) -> Tuple[int, Any]:
        """Restore into the structure of ``like`` (values replaced): each leaf
        as a new tensor on the device of ``like``'s leaf, in the dtype saved
        and then in ``like``'s leaf's dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(d, "arrays.npz"))
        _, flat_like = _flatten_with_paths(like)
        assert len(flat_like) == len(manifest["paths"]), (
            f"checkpoint has {len(manifest['paths'])} leaves, target {len(flat_like)}")
        leaves = []
        for i, l in enumerate(flat_like):
            dt = dtype_of(manifest["dtypes"][i])
            raw = torch.from_numpy(data[f"a{i}"].copy())          # uint8 bytes
            t = raw.view(dt).reshape(manifest["shapes"][i])
            leaves.append(t.to(device=l.device, dtype=l.dtype))
        return step, _unflatten_like(like, leaves)
