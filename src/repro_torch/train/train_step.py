"""The training step: loss -> grad -> clip -> AdamW.

Mirrors ``repro.train.train_step``.  Gradients come from
``torch.autograd.grad`` of ``api.loss`` on views of the parameters that
require grad; the parameters themselves stay leaf tensors and are updated
in place.  Remat inside the model keeps activations O(1) in depth.

Given DTensor params (``sharding.param_shardings``) and optimizer state
(``init_opt_state(..., sharding.opt_shardings(...))``), the same step runs
on the params' mesh, as the reference's jitted step does under its
shardings.  Each rank runs the loss SPMD on its rows of the batch
(tensor-parallel over "model", ``parallel.ctx``) on its own blocks of the
params (``ctx.placed_params``): each checkpointed layer gathers its blocks
over the data axes where they are sharded (FSDP) inside, and the
embedding, head and cross-entropy are split by the vocab over "model".
The gradients come out at each param's placement, already summed over the
data axes for an FSDP leaf (by its gather's backward); the rest are
reduce-scattered onto their ZeRO-1 blocks (the moments' placement), and
all are averaged over the data ranks.  Clipping takes the norm over those
blocks, each element once, and the ZeRO-1 update leaves each param at its
placement and each moment and master leaf sharded over the data axes.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor

from .. import obs
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

    def grads_on_mesh(pairs, mu, batch):
        """Loss and gradients on the params' mesh: each gradient a DTensor at
        its moments' (ZeRO-1) placement."""
        mesh = pairs[0][1].device_mesh
        dp = spmd.data_index(mesh)[1]
        placements = opt.unflatten((path, p.placements) for path, p in pairs)
        blocks = [p.to_local().detach().requires_grad_() for _, p in pairs]
        batch = {k: _local_rows(v, mesh) for k, v in batch.items()}
        # the backward recomputes each checkpointed layer: under the mesh too
        with ctx.mesh_context(mesh), ctx.sharded_batch(), ctx.placed_params(placements):
            with obs.span("train.forward"):
                loss = api.loss(opt.unflatten((path, b) for (path, _), b in zip(pairs, blocks)),
                                batch)
            with obs.span("train.backward"):
                grads = list(torch.autograd.grad(loss, blocks))
        del blocks
        loss = spmd.all_reduce_data(loss.detach(), mesh)
        out = []
        for i, (path, p) in enumerate(pairs):
            g = spmd.reduce_grad(grads[i], p.placements, mu[path].placements, mesh)
            grads[i] = None     # its block replaces it
            if dp > 1:      # the mean over the data ranks' equal shares of the batch
                g.div_(dp)
            out.append(DTensor.from_local(g, mesh, mu[path].placements, run_check=False,
                                          shape=p.shape, stride=p.stride()))
        if dp > 1:
            loss.div_(dp)
        return loss, out

    def train_step(params: opt.Tree, opt_state: opt.OptState,
                   batch: Dict[str, torch.Tensor]):
        pairs = list(opt.flatten_with_paths(params))
        if isinstance(pairs[0][1], DTensor):
            loss, grads = grads_on_mesh(pairs, dict(opt.flatten_with_paths(opt_state.mu)), batch)
        else:
            pairs = [(path, p.detach().requires_grad_()) for path, p in pairs]
            with obs.span("train.forward"):
                loss = api.loss(opt.unflatten(pairs), batch)
            with obs.span("train.backward"):
                grads = torch.autograd.grad(loss, [p for _, p in pairs])
        grads = opt.unflatten((path, g) for (path, _), g in zip(pairs, grads))
        del pairs
        with obs.span("train.optimizer"):
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
