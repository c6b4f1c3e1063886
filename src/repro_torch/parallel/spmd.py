"""Differentiable collectives for the model's mesh paths.

The model's mesh paths run SPMD on each rank's own tensors, as the body of
a ``shard_map`` does in the reference; these are their collectives, each
with its transpose as its backward:

  * ``reduce_model``  sums partial results over the "model" axis (the
    reference's ``psum``); its backward passes the gradient through;
  * ``enter_model``   marks a value every model rank holds whole and uses
    only in part (a region's input, a weight sliced by rank); forward it
    passes through, and its backward sums the partial gradients;
  * ``all_gather_model`` concatenates the model ranks' blocks of a value
    every rank then uses whole, alike; its backward is this rank's slice
    of the gradient.  ``reduce_scatter_model`` sums partial results over
    "model" and keeps this rank's block; its backward is that all-gather.
    The pair costs what one ``reduce_model`` does;
  * ``gather_data``   concatenates each data rank's rows, for a caller
    that holds the whole batch on every rank (forward only).

A train step on placed parameters (``ctx.placed_params``) hands the model
each rank's blocks (``DTensor.to_local()``), and the model gathers a
layer's blocks inside its checkpointed block, so that only one layer is
held gathered and the recompute gathers it again:

  * ``gather``       all-gathers each leaf over the data axes where it is
    sharded (FSDP); its backward is the transpose: the data ranks' partial
    gradients reduce-scattered onto the block.  A leaf left split over
    "model" is marked as this rank's block (``model_dim``);
  * ``model_part``   this model rank's part of a weight for the TP code:
    the block itself where it is that part, else the weight (gathered
    whole over "model" first if it is a block) sliced as ``model_slice``,
    and ``model_whole`` a weight each model rank uses whole for its part
    of the work; ``gather_model`` a block gathered whole over "model" for
    a computation every model rank runs alike (its gradient: this rank's
    chunk of the whole one), counted in ``MODEL_GATHERS``;
  * ``max_model``    a row max over the "model" axis, with the gradient
    of ``amax`` (the vocab-parallel cross-entropy's max term);
  * ``reduce_grad``  a gradient summed over the data axes onto its ZeRO-1
    block, and ``gather_block`` the updated block gathered back.

A placed serving call (no gradients) projects a decode token on each
rank's columns of a weight and gathers the columns (``all_gather_model``),
and splits decode attention's softmax over the cache's sequence:
``amax_model`` is its elementwise max over "model", and ``reduce_model``
its sums (the exp-sum, then the partial outputs: the probabilities are
normalised between the two, so no two tensors are summed in one call).

Groups come from the ``DeviceMesh``; the data axes are ``("pod", "data")``
(pod the major one), or ``("data",)``.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ..train.optimizer import flatten_with_paths, unflatten

MP = "model"

# calls of ``gather`` (each gathers a layer's, or an embedding's, blocks; a
# checkpointed layer's recompute gathers again) and of its backward (each
# reduce-scatters that tree's gradients), for a caller to reset and read
GATHERS: Counter = Counter()
# blocks gathered whole over "model" (``gather_model``, also inside
# ``model_part`` and ``model_whole``): "leaves" and their whole "elements"
MODEL_GATHERS: Counter = Counter()


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


def model_size(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index(MP))


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


# ------------------------------------------------------------ placed parameters

def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's blocks of x concatenated along ``dim``, in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((dist.get_world_size(group) * xt.shape[0], *xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's sum of x, this rank's chunk along ``dim``."""
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // dist.get_world_size(group), *xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _plan(pls, mesh) -> Tuple[Tuple[str, int], ...]:
    """(axis, tensor dim) of each all-gather a leaf placed by ``pls`` takes:
    the data axes it is sharded over, the minor one first."""
    named = [(a, pl.dim) for a, pl in zip(mesh.mesh_dim_names, pls) if isinstance(pl, Shard)]
    return tuple(s for s in reversed(named) if s[0] != MP)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, plans, counted, *blocks):
        ctx.mesh, ctx.plans, ctx.counted = mesh, plans, counted
        GATHERS["gather"] += counted
        outs = []
        for x, plan in zip(blocks, plans):
            for axis, dim in plan:
                x = _all_gather(x, mesh.get_group(axis), dim)
            outs.append(x if plan else x.view_as(x))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        GATHERS["reduce_scatter"] += ctx.counted
        mesh, out = ctx.mesh, []
        for g, plan in zip(grads, ctx.plans):
            for axis, dim in reversed(plan if g is not None else ()):
                if axis == MP:      # every model rank computed the same whole gradient
                    g = g.chunk(model_size(mesh), dim)[model_rank(mesh)]
                else:
                    g = _reduce_scatter(g, mesh.get_group(axis), dim)
            out.append(g)
        return (None, None, None, *out)


def model_dim(x: torch.Tensor) -> Optional[int]:
    """The dim along which ``x`` is this model rank's block (from ``gather``),
    or None where it is whole on every model rank."""
    return getattr(x, "_model_block_dim", None)


def whole_size(x: torch.Tensor, dim: int, mesh) -> int:
    """Entries along ``dim`` of the whole tensor ``x`` is a block of (or is)."""
    dim %= x.dim()
    return x.shape[dim] * model_size(mesh) if model_dim(x) == dim else x.shape[dim]


def gather(tree, placements, mesh):
    """A tree of this rank's parameter blocks as the model computes with it
    (see the module's docstring); ``placements``: a tree like ``tree`` of
    each leaf's DTensor placements, or None for a tree that is whole (the
    tree itself)."""
    if placements is None:
        return tree
    paths, blocks = zip(*flatten_with_paths(tree))
    pl_of = dict(flatten_with_paths(placements))
    pls = [pl_of[path] for path in paths]
    outs = _Gather.apply(mesh, tuple(_plan(p, mesh) for p in pls), 1, *blocks)
    if model_size(mesh) > 1:
        for x, p in zip(outs, pls):
            dims = [pl.dim for a, pl in zip(mesh.mesh_dim_names, p)
                    if a == MP and isinstance(pl, Shard)]
            if dims:
                x._model_block_dim = dims[0]
    return unflatten(zip(paths, outs))


def layer_placements(placements):
    """The placements of one layer's slice of [L]-stacked leaves placed by
    ``placements`` (a tree of them, or None): dim d of the stacked leaf is
    dim d - 1 of a layer's."""
    if placements is None:
        return None
    if isinstance(placements, dict):
        return {k: layer_placements(v) for k, v in placements.items()}
    return tuple(Shard(pl.dim - 1) if isinstance(pl, Shard) else pl for pl in placements)


def gather_model(w: torch.Tensor, mesh) -> torch.Tensor:
    """``w`` whole: a block (``model_dim``) gathered over "model", whose
    gradient is then this rank's chunk of the whole one (every model rank
    computes that whole gradient alike); ``w`` itself where it is whole."""
    block = model_dim(w)
    if block is None:
        return w
    MODEL_GATHERS["leaves"] += 1
    MODEL_GATHERS["elements"] += w.numel() * model_size(mesh)
    return _Gather.apply(mesh, (((MP, block),),), 0, w)[0]


def model_whole(w: torch.Tensor, mesh) -> torch.Tensor:
    """``enter_model`` of a weight every model rank uses whole, each for its
    part of the work: gathered over "model" first if it is a block."""
    return enter_model(gather_model(w, mesh), mesh)


def model_part(w: torch.Tensor, mesh, dim: int, n: int, padded: Optional[int] = None
               ) -> torch.Tensor:
    """This model rank's ``n`` entries of ``w`` along ``dim`` (rank r takes
    [r n, (r + 1) n)), ``w`` zero-padded to ``padded`` entries there first
    where given.  A block of ``w`` (``model_dim``) that is this part is
    returned as it is; any other block is gathered whole over "model" first
    (and its gradient, summed by ``model_slice``, is this rank's chunk)."""
    dim %= w.dim()
    block = model_dim(w)
    if block == dim and w.shape[dim] == n and padded in (None, n * model_size(mesh)):
        return w
    w = gather_model(w, mesh)
    if padded is not None and padded != w.shape[dim]:
        pad = [0, 0] * (w.dim() - 1 - dim) + [0, padded - w.shape[dim]]
        w = torch.nn.functional.pad(w, pad)
    return model_slice(w, mesh, dim, n)


class _MaxModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        m = x.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(MP))
        hit = x == m[..., None]
        ties = _all_reduce(hit.sum(-1, dtype=x.dtype), mesh, (MP,))
        ctx.save_for_backward(hit, ties)
        return m

    @staticmethod
    def backward(ctx, g):
        hit, ties = ctx.saved_tensors
        return hit * (g / ties)[..., None], None


def max_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """x [..., n] on each model rank -> the max of each row over every rank's
    entries.  Its gradient is ``amax``'s: split evenly over the row's
    maxima, which land on whichever ranks hold them."""
    return _MaxModel.apply(x, mesh)


class _AllGatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _all_gather(x, mesh.get_group(MP), dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(model_size(ctx.mesh), ctx.dim)[model_rank(ctx.mesh)], None, None


class _ReduceScatterModel(torch.autograd.Function):
    # contiguous results: along a last dim the collective's result is strided
    # (it moves the dim to the front), and its backward's feeds a product's
    # backward, where a transposed operand can take another cuBLAS kernel
    # than the mesh-free path's contiguous one
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _reduce_scatter(x, mesh.get_group(MP), dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh.get_group(MP), ctx.dim).contiguous(), None, None


def all_gather_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The "model" ranks' blocks of ``x`` concatenated along ``dim``, in rank
    order.  Every rank uses the whole result alike, so the gradient of its
    block is its slice of the whole gradient."""
    return _AllGatherModel.apply(x, mesh, dim % x.dim())


def reduce_scatter_model(x: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The sum over the "model" ranks of partial results ``x``, this rank's
    block along ``dim`` (rank r: the r-th of ``model_size`` equal chunks);
    its gradient is the blocks' gradients gathered over "model"."""
    return _ReduceScatterModel.apply(x, mesh, dim % x.dim())


def amax_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise max of ``x`` over the "model" ranks (forward only)."""
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(MP))
    return x


def reduce_grad(g: torch.Tensor, param_pls, block_pls, mesh) -> torch.Tensor:
    """A parameter's gradient at the parameter's placement, partial over the
    data axes where the parameter is replicated, summed over them onto its
    block placed by ``block_pls`` (ZeRO-1): reduce-scattered where the block
    is sharded, all-reduced where it is not (the major axis first).  Axes
    the parameter is sharded over were summed by ``gather``'s backward."""
    for i, axis in enumerate(mesh.mesh_dim_names):
        if axis == MP or isinstance(param_pls[i], Shard):
            continue
        if isinstance(block_pls[i], Shard):
            g = _reduce_scatter(g, mesh.get_group(axis), block_pls[i].dim)
        else:
            g = _all_reduce(g, mesh, (axis,))
    return g


def gather_block(x: torch.Tensor, block_pls, param_pls, mesh) -> torch.Tensor:
    """``reduce_grad``'s transpose for values: a block placed by ``block_pls``
    gathered over the data axes where the parameter (``param_pls``) is
    replicated, to the parameter's own block (the minor axis first)."""
    for i in reversed(range(len(mesh.mesh_dim_names))):
        if isinstance(block_pls[i], Shard) and not isinstance(param_pls[i], Shard):
            x = _all_gather(x, mesh.get_group(i), block_pls[i].dim)
    return x
