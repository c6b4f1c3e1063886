"""Meshes over the ranks of a ``torch.distributed`` world.

Mirrors ``repro.launch.mesh``.  Functions, not module-level constants, so
that importing this module touches no process-group state.  The
production meshes need a world of 256 or 512 ranks: on one host, torch's
fake process group stands in for them (backend ``"fake"`` with a
``FakeStore``), which is what a dry run lowers onto.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import resolve_device

__all__ = ["make_production_mesh", "make_host_mesh", "init_process_group"]


def init_process_group(init_file: str, rank: int = 0, world_size: int = 1,
                       backend: str = "nccl", timeout_s: float = 60.0) -> None:
    """Join a world through a rendezvous file (``file://``: no network), with
    ``timeout_s`` for every collective.  With NCCL, rank r takes card r
    modulo the cards there are."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{os.path.abspath(init_file)}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods for the multi-pod dry run."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """Small mesh over the ranks that exist (tests, one card); (world, 1)
    when ``data * model`` asks for more ranks than there are."""
    resolve_device(device_type)
    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    return DeviceMesh(device_type, torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=("data", "model"))
