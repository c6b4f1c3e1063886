"""The training step: loss -> grad -> clip -> AdamW.

Mirrors ``repro.train.train_step``.  Gradients come from
``torch.autograd.grad`` of ``api.loss`` on views of the parameters that
require grad; the parameters themselves stay leaf tensors and are updated
in place.  Remat inside the model keeps activations O(1) in depth.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..models import get_model
from . import optimizer as opt


def make_train_step(cfg: ArchConfig, oc: opt.OptConfig):
    api = get_model(cfg)

    def train_step(params: opt.Tree, opt_state: opt.OptState,
                   batch: Dict[str, torch.Tensor]):
        pairs = [(path, p.detach().requires_grad_())
                 for path, p in opt.flatten_with_paths(params)]
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
