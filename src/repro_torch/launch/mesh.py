"""Mesh construction: the port of ``repro.launch.mesh``.

``make_mesh_for(par)`` builds a ``DeviceMesh`` of ``par.mesh_shape()`` named
``par.axis_names()`` over the launched world: one rank per device, as
``torchrun --nproc-per-node N`` launches it. When no default process group
exists it initialises one for a world of one process (rank 0, an in-process
store, NCCL on the card, gloo on the CPU), so that a one-device run takes
the same path as a launched one.

``make_production_mesh`` is the dry run's mesh (``launch.dryrun``): the
production layout, ``(16, 16)`` ("data", "model") or ``(2, 16, 16)`` ("pod",
"data", "model"), over a process group of 256 or 512 ranks of the ``fake``
backend (rank 0 in the calling process: its collectives move no data), on
which the step runs on ``meta`` tensors.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.config.base import ParallelConfig
from repro_torch.device import DeviceLike, resolve_device


def ensure_process_group(device: DeviceLike = None) -> None:
    """The default process group: as launched (``torchrun`` sets
    ``WORLD_SIZE``), else a world of one on ``device``'s backend."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    """The production ``DeviceMesh`` on a fake group of its 256 or 512 ranks,
    of ``device``'s type (``cuda`` unless ``"cpu"`` is given; raises without
    a GPU)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes, device)


def fake_mesh(shape: tuple, axes: tuple, device: DeviceLike = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes``, of ``device``'s type,
    on the default process group as rank 0 of its ranks of the ``fake``
    backend, in this process. A fake group of another size is replaced; a
    launched group of another size raises."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    dev = resolve_device(device)
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a launched process group of {dist.get_world_size()} ranks "
                               f"exists; the mesh {shape} needs a fake group of {world}")
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_mesh_for(par: ParallelConfig, devices: DeviceLike = None):
    """A ``DeviceMesh`` of ``par``'s shape and axis names on ``devices``'
    type (``cuda`` unless ``"cpu"`` is given; raises without a GPU). Raises
    when the world's size is not ``par.num_devices``."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(devices)
    ensure_process_group(dev)
    world = dist.get_world_size()
    if world != par.num_devices:
        raise ValueError(f"the mesh {par.mesh_shape()} {par.axis_names()} needs "
                         f"{par.num_devices} ranks; the world has {world}")
    return init_device_mesh(dev.type, par.mesh_shape(), mesh_dim_names=par.axis_names())
