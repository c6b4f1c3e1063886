"""Differentiable collectives for the model's mesh paths.

The model's mesh paths run SPMD on each rank's own tensors, as the body of
a ``shard_map`` does in the reference; these are their collectives, each
with its transpose as its backward:

  * ``reduce_model``  sums partial results over the "model" axis (the
    reference's ``psum``); its backward passes the gradient through;
  * ``enter_model``   marks a value every model rank holds whole and uses
    only in part (a region's input, a weight sliced by rank); forward it
    passes through, and its backward sums the partial gradients;
  * ``gather_data``   concatenates each data rank's rows, for a caller
    that holds the whole batch on every rank (forward only).

Groups come from the ``DeviceMesh``; the data axes are ``("pod", "data")``
(pod the major one), or ``("data",)``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

MP = "model"


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def model_rank(mesh) -> int:
    return mesh.get_local_rank(MP)


def data_index(mesh) -> Tuple[int, int]:
    """(this rank's index over the data axes, pod-major; their total size)."""
    idx, size = 0, 1
    for a in data_axes(mesh):
        n = mesh.size(mesh.mesh_dim_names.index(a))
        idx, size = idx * n + mesh.get_local_rank(a), size * n
    return idx, size


def _all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    x = x.contiguous().clone()
    for a in axes:
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh, (MP,))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, (MP,)), None


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        out = x.contiguous()
        for a in reversed(data_axes(mesh)):        # the minor axis first
            group = mesh.get_group(a)
            parts = [torch.empty_like(out) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, out, group=group)
            out = torch.cat(parts, 0)
        return out

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("gather_data has no backward: a train step shards its batch "
                           "over the data axes (ctx.sharded_batch)")


def reduce_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceModel.apply(x, mesh)


def enter_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _EnterModel.apply(x, mesh)


def gather_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """[n, ...] on each data rank -> [n * data ranks, ...], rows in data-index order."""
    return _GatherData.apply(x, mesh)


def all_reduce_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the data axes (not differentiable: gradients, not activations)."""
    return _all_reduce(x, mesh, data_axes(mesh))


def model_slice(w: torch.Tensor, mesh, dim: int, n: int) -> torch.Tensor:
    """This model rank's ``n`` entries of ``w`` along ``dim`` (rank r takes
    [r n, (r + 1) n)); the gradient of the whole ``w`` sums every rank's."""
    return enter_model(w, mesh).narrow(dim, model_rank(mesh) * n, n)
