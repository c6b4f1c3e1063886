"""Training steps of the reference: the loss, its gradients, clipping and AdamW.

The backward recomputes one block at a time from the block inputs the
forward kept, so only one block's activations are held.  The optimizer:
the global norm of the gradients clipped to ``clip_norm`` (scale
``min(1, clip / (norm + 1e-9))``); per leaf ``m = b1 m + (1 - b1) g``,
``v = b2 v + (1 - b2) g^2``, ``p -= lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)``
with ``c_i = 1 - b_i^step`` and ``wd`` on the decayed leaves only
(``layout.decayed``); the learning rate warms up linearly over
``warmup_steps``, then holds (WSD, until ``stable_frac`` of the steps, then
halves ten times over the rest) or follows the cosine from 1 to 0.1.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import model
from .layout import decayed
from .precision import FP32, Precision


def learning_rate(opt: Dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    total = float(opt["total_steps"])
    if opt["schedule"] == "wsd":
        end = total * opt["stable_frac"]
        frac = min(max((step - end) / max(total - end, 1.0), 0.0), 1.0)
        return opt["lr"] * warm * 0.5 ** (frac * 10.0)
    frac = min(max(step / total, 0.0), 1.0)
    return opt["lr"] * warm * (0.1 + 0.45 * (1 + math.cos(math.pi * frac)))


def loss_and_grads(arch: Dict, params: model.Weights, batch: Dict[str, torch.Tensor],
                   prec: Precision = FP32):
    """(loss, {path: gradient}) of the mean next-token cross-entropy."""
    tokens, labels = batch["tokens"], batch["labels"]
    grads = {path: torch.zeros_like(p) for path, p in params.items()}
    with torch.no_grad():
        h = params[("emb", "tok")][tokens]
        inputs = []
        for i in range(arch["n_layers"]):
            inputs.append(h)
            h = model.block(arch, model.block_params(params, i), h, prec)
    head = {k: params[k].detach().requires_grad_() for k in params if k[0] == "emb"}
    h = h.detach().requires_grad_()
    out = model.head_weight(head)
    loss = model.cross_entropy(model.logits(arch, head, h, prec, out), labels)
    loss.backward()
    for k, p in head.items():
        if p.grad is not None:
            grads[k] += p.grad
    dh = h.grad
    for i in reversed(range(arch["n_layers"])):
        hin = inputs[i].detach().requires_grad_()
        p = {k: w.detach().requires_grad_()
             for k, w in model.block_params(params, i).items()}
        with torch.enable_grad():
            model.block(arch, p, hin, prec).backward(dh)
        for name, w in p.items():
            grads[("layers", *name.split("/"))][i].add_(w.grad)
        dh = hin.grad
    grads[("emb", "tok")].index_add_(0, tokens.reshape(-1), dh.reshape(-1, dh.shape[-1]))
    return loss.detach(), grads


class AdamW:
    def __init__(self, opt: Dict, params: model.Weights):
        self.opt = opt
        self.step = 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def update(self, params: model.Weights, grads: model.Weights) -> Dict:
        """Clips ``grads`` in place and updates ``params``; returns the
        gradients' global norm before clipping and their leaf norms after."""
        o = self.opt
        gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = torch.clamp(o["clip_norm"] / (gnorm + 1e-9), max=1.0)
        self.step += 1
        lr = learning_rate(o, self.step)
        b1, b2 = o["betas"]
        c1, c2 = 1 - b1 ** self.step, 1 - b2 ** self.step
        leaf_norms = {}
        for k, p in params.items():
            g = grads[k].mul_(scale)
            leaf_norms[k] = float(g.norm())
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * g * g)
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + o["eps"])
            if decayed(k):
                upd.add_(o["weight_decay"] * p)
            p.sub_(lr * upd)
        return {"grad_norm": float(gnorm), "leaf_grad_norms": leaf_norms}


def train(arch: Dict, params: model.Weights, opt: Dict, batches: List[Dict[str, torch.Tensor]],
          prec: Precision = FP32) -> Dict:
    """Trains ``params`` (float32, updated in place) on ``batches`` in turn.
    Returns each step's loss and gradient norm, and the first step's leaf
    norms of the clipped gradient."""
    adam = AdamW(opt, params)
    losses, gnorms, first = [], [], None
    for batch in batches:
        loss, grads = loss_and_grads(arch, params, batch, prec)
        out = adam.update(params, grads)
        del grads
        losses.append(float(loss))
        gnorms.append(out["grad_norm"])
        first = first or out["leaf_grad_norms"]
    return {"loss": losses, "grad_norm": gnorms, "first_grad": first}
