"""Optimizer: AdamW with a configurable moment dtype, and LR schedules.

Mirrors ``repro.train.optimizer``:
  * moments in fp32 by default, bf16 where the config asks for it;
  * optional fp32 master weights;
  * WSD (warmup-stable-decay) for minicpm, cosine for the rest, or const;
  * global-norm gradient clipping.
Parameter trees are nested dicts, walked in sorted key order as JAX
flattens them.  One difference: the updates are made in place (grads in
``clip_by_global_norm``; params, moments and master weights in
``adamw_update``), and the same trees are returned.  At full width the
optimizer state is tens of GB, and a second copy of it would not fit the
card.

Under a mesh the parameters are DTensors placed by
``sharding.param_shardings``, and the moments and master weights DTensors
placed by ``sharding.opt_shardings`` (ZeRO-1: sharded over the data axes
too).  The gradients are then DTensors at the moments' placement (the
train step's): ``clip_by_global_norm`` sums their blocks over the mesh,
each element once, and in ``adamw_update`` each rank updates its block of
the parameter, moments and master weights, and gathers the updated block
over the data axes where the parameter is not split.  No rank holds a
whole parameter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig

Tree = Dict[str, Any]
Path = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"         # "cosine" | "wsd" | "const"
    stable_frac: float = 0.8         # WSD: fraction of steps at peak LR
    moment_dtype: Any = torch.float32
    master_weights: bool = False


def opt_config_for(cfg: ArchConfig, **overrides) -> OptConfig:
    base = OptConfig(
        schedule="wsd" if cfg.lr_schedule == "wsd" else "cosine",
        moment_dtype=(torch.bfloat16 if cfg.optimizer_moment_dtype == "bfloat16"
                      else torch.float32),
        master_weights=cfg.use_master_weights and
                       cfg.optimizer_moment_dtype == "float32",
    )
    return dataclasses.replace(base, **overrides)


class OptState(NamedTuple):
    step: torch.Tensor         # scalar int32, on the params' device
    mu: Tree                   # first moments (tree like params)
    nu: Tree                   # second moments
    master: Optional[Tree]     # fp32 master weights, or None


def flatten_with_paths(tree: Tree, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs of a nested dict, keys in sorted order (JAX's)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flatten_with_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def unflatten(pairs) -> Tree:
    """Inverse of :func:`flatten_with_paths`."""
    tree: Tree = {}
    for path, leaf in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def _leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.float()
    warm = torch.clamp(s / max(oc.warmup_steps, 1), max=1.0)
    if oc.schedule == "const":
        return oc.lr * warm
    total = float(oc.total_steps)
    if oc.schedule == "wsd":
        # warmup -> stable plateau -> inverse-exponential decay tail
        stable_end = total * oc.stable_frac
        in_decay = torch.clamp((s - stable_end) / max(total - stable_end, 1.0), 0.0, 1.0)
        decay = torch.pow(0.5, in_decay * 10.0)     # ~1000x down over the tail
        return oc.lr * warm * decay
    # cosine
    frac = torch.clamp(s / total, 0.0, 1.0)
    return oc.lr * warm * (0.1 + 0.45 * (1 + torch.cos(math.pi * frac)))


def init_opt_state(oc: OptConfig, params: Tree, shardings: Optional[Tree] = None) -> OptState:
    """Zero moments (and fp32 master weights) like ``params``.  For DTensor
    params, ``shardings`` (``sharding.opt_shardings``) places each moment and
    master leaf, and each rank allocates only its block, the master's made
    from its block of the param."""
    pairs = list(flatten_with_paths(params))
    if shardings is None:
        def leaf(path, p, dtype, values):
            if values:
                return p.detach().to(dtype, copy=True).contiguous()
            return torch.zeros((), dtype=dtype, device=p.device).expand(p.shape).contiguous()
    else:
        from ..parallel import sharding as shd
        specs = dict(flatten_with_paths(shardings))
        mesh = pairs[0][1].device_mesh

        def leaf(path, p, dtype, values):
            pls = shd.placements(specs[path], mesh)
            blk = shd.sub_block(p.to_local().detach(), p.placements, pls, mesh)
            out = torch.empty(blk.shape, dtype=dtype, device=blk.device)
            return shd.from_block(out.copy_(blk) if values else out.zero_(), pls, mesh, p)

    mu = unflatten((path, leaf(path, p, oc.moment_dtype, False)) for path, p in pairs)
    nu = unflatten((path, leaf(path, p, oc.moment_dtype, False)) for path, p in pairs)
    master = (unflatten((path, leaf(path, p, torch.float32, True)) for path, p in pairs)
              if oc.master_weights else None)
    step = torch.zeros((), dtype=torch.int32, device=pairs[0][1].device)
    return OptState(step, mu, nu, master)


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before scaling).  DTensor gradients: the norm
    of the whole gradients, from each rank's blocks (``_sharded_sq``)."""
    leaves = _leaves(grads)
    if leaves and isinstance(leaves[0], DTensor):
        sq = _sharded_sq(leaves)
        leaves = [g.to_local() for g in leaves]
    else:
        sq = sum((g.float() * g.float()).sum() for g in leaves)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in leaves:
        g.copy_(g.float() * scale)
    return grads, gnorm


def _sharded_sq(leaves: List[DTensor]) -> torch.Tensor:
    """The sum of squares of the whole tensors of DTensor ``leaves``: each
    rank's block sums are summed over the mesh, a block held by several
    ranks (replicated over a mesh dim) counted on the first of them only,
    and the leaves' sums added in order, as the mesh-free sum adds them."""
    mesh = leaves[0].device_mesh
    coord = mesh.get_coordinate()
    parts = []
    for g in leaves:
        s = (g.to_local().float() * g.to_local().float()).sum()
        copy = any(not pl.is_shard() and c for pl, c in zip(g.placements, coord))
        parts.append(torch.zeros_like(s) if copy else s)
    sums = torch.stack(parts)
    for i in range(mesh.ndim):
        torch.distributed.all_reduce(sums, group=mesh.get_group(i))
    return sum(sums.unbind())


def _decay_mask(path: Path) -> bool:
    """No weight decay on norms / biases, judged by the leaf's own name, as
    the reference does: any name starting with ``ln`` or ``b``, or holding
    ``norm``, is exempt."""
    leaf_name = str(path[-1]) if path else ""
    return not (leaf_name.startswith("ln") or leaf_name.startswith("b")
                or "norm" in leaf_name)


@torch.no_grad()
def _update_leaf(oc: OptConfig, decay: bool, p, g, mu, nu, master, lr, c1, c2) -> None:
    b1, b2 = oc.betas
    g32 = g.float()
    mu32, nu32 = mu.float(), nu.float()            # the tensors themselves when fp32
    mu32.mul_(b1).add_((1 - b1) * g32)
    nu32.mul_(b2).add_(((1 - b2) * g32).mul_(g32))
    del g32
    update = (mu32 / c1).div_(torch.sqrt(nu32 / c2).add_(oc.eps))
    base32 = master if master is not None else p.float()
    if decay:
        update.add_(oc.weight_decay * base32)
    base32.sub_(update.mul_(lr))                   # base32 - lr * update
    if base32 is not p:
        p.copy_(base32)
    for dst, src in ((mu, mu32), (nu, nu32)):
        if src is not dst:
            dst.copy_(src)


def adamw_update(oc: OptConfig, params: Tree, grads: Tree, state: OptState
                 ) -> Tuple[Tree, OptState]:
    """One AdamW step, in place on params, moments and master weights."""
    step = state.step + 1
    lr = schedule(oc, step)
    b1, b2 = oc.betas
    c1 = 1.0 - torch.pow(b1, step.float())
    c2 = 1.0 - torch.pow(b2, step.float())
    g_of = dict(flatten_with_paths(grads))
    mu_of = dict(flatten_with_paths(state.mu))
    nu_of = dict(flatten_with_paths(state.nu))
    ms_of = dict(flatten_with_paths(state.master)) if state.master is not None else {}
    for path, p in flatten_with_paths(params):
        update = _update_sharded if isinstance(p, DTensor) else _update_leaf
        update(oc, _decay_mask(path), p, g_of[path], mu_of[path], nu_of[path],
               ms_of.get(path), lr, c1, c2)
    return params, OptState(step, state.mu, state.nu, state.master)


@torch.no_grad()
def _update_sharded(oc: OptConfig, decay: bool, p, g, mu, nu, master, lr, c1, c2) -> None:
    """ZeRO-1 update of a DTensor param from its gradient block ``g`` (a
    DTensor at the moments' placement): this rank's block of p at that
    placement is updated against the gradient, moment and master blocks,
    then gathered over the data axes where p itself is not split."""
    from ..parallel import sharding as shd
    from ..parallel import spmd
    mesh, pl = mu.device_mesh, mu.placements
    local = p.to_local()
    blk = shd.sub_block(local, p.placements, pl, mesh)
    _update_leaf(oc, decay, blk, g.to_local(), mu.to_local(), nu.to_local(),
                 None if master is None else master.to_local(), lr, c1, c2)
    if tuple(pl) != tuple(p.placements):
        local.copy_(spmd.gather_block(blk, pl, p.placements, mesh))
