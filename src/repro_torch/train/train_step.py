"""The training step: loss -> grad -> clip -> AdamW.

Mirrors ``repro.train.train_step``.  Gradients come from
``torch.autograd.grad`` of ``api.loss`` on views of the parameters that
require grad; the parameters themselves stay leaf tensors and are updated
in place.  Remat inside the model keeps activations O(1) in depth.

Given DTensor params (``sharding.param_shardings``) and optimizer state
(``init_opt_state(..., sharding.opt_shardings(...))``), the same step runs
on the params' mesh, as the reference's jitted step does under its
shardings.  Each rank gathers the params whole, runs the loss SPMD on its
rows of the batch (tensor-parallel over "model", ``parallel.ctx``), and the
gradients are averaged over the data axes; clipping then sees the same
whole gradients on every rank, and the ZeRO-1 update leaves each param at
its placement and each moment and master leaf sharded over the data axes.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..models import get_model
from ..parallel import ctx, spmd
from . import optimizer as opt


def _local_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This data rank's rows of a batch leaf (a DTensor's own block, or a
    whole tensor's slice)."""
    if isinstance(x, DTensor):
        return x.to_local()
    idx, dp = spmd.data_index(mesh)
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split over {dp} data ranks")
    return x.chunk(dp, 0)[idx]


def make_train_step(cfg: ArchConfig, oc: opt.OptConfig):
    api = get_model(cfg)

    def grads_on_mesh(pairs, batch):
        mesh = pairs[0][1].device_mesh
        dp = spmd.data_index(mesh)[1]
        pairs = [(path, p.detach().full_tensor().detach().requires_grad_())
                 for path, p in pairs]
        batch = {k: _local_rows(v, mesh) for k, v in batch.items()}
        # the backward recomputes each checkpointed layer: under the mesh too
        with ctx.mesh_context(mesh), ctx.sharded_batch():
            loss = api.loss(opt.unflatten(pairs), batch)
            grads = torch.autograd.grad(loss, [p for _, p in pairs])
        grads = [spmd.all_reduce_data(g, mesh) for g in grads]
        loss = spmd.all_reduce_data(loss.detach(), mesh)
        if dp > 1:      # the mean over the data ranks' equal shares of the batch
            for x in (loss, *grads):
                x.div_(dp)
        return loss, pairs, grads

    def train_step(params: opt.Tree, opt_state: opt.OptState,
                   batch: Dict[str, torch.Tensor]):
        pairs = list(opt.flatten_with_paths(params))
        if isinstance(pairs[0][1], DTensor):
            loss, pairs, grads = grads_on_mesh(pairs, batch)
        else:
            pairs = [(path, p.detach().requires_grad_()) for path, p in pairs]
            loss = api.loss(opt.unflatten(pairs), batch)
            grads = torch.autograd.grad(loss, [p for _, p in pairs])
        grads = opt.unflatten((path, g) for (path, _), g in zip(pairs, grads))
        del pairs
        grads, gnorm = opt.clip_by_global_norm(grads, oc.clip_norm)
        new_params, new_state = opt.adamw_update(oc, params, grads, opt_state)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "lr": opt.schedule(oc, new_state.step)}
        return new_params, new_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig):
    api = get_model(cfg)

    def eval_step(params: opt.Tree, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            return api.loss(params, batch)

    return eval_step
