"""Mixture-of-Experts block: top-k routing with capacity, scatter dispatch.

Mirrors the local path of ``repro.models.moe`` (mixtral-8x22b: 8 experts
top-2; arctic-480b: 128 experts top-2 plus a dense residual MLP):

  1. router logits (fp32) -> top-k experts and renormalised weights per token;
  2. the position of each (token, choice) in its expert by a cumsum over the
     one-hot assignment, in token-major [ng * k] order within each group of
     tokens; those at or past the capacity C are DROPPED;
  3. scatter into an [E, G, C, d] buffer, one batched SwiGLU product per
     expert over its G * C rows;
  4. gather back and combine with the routing weights.

Capacity and drops are computed per group exactly as in the reference
(``groups`` halved until it divides B*T), since which tokens drop depends
on them.  A dropped slot points at (E-1, C-1) and contributes zero.  The
buffer is laid out expert-major, [E, G, C, d] where the reference has
[G, E, C, d], so that each expert's rows are one operand of a batched
matrix product; the values are the same.  The reference's expert-parallel
``moe_block_shard_map`` and its sharding hints have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import layers
from .layers import Params


def init_moe_block(cfg: ArchConfig, gen: torch.Generator, dtype) -> Params:
    d, E = cfg.d_model, cfg.n_experts
    fe = cfg.d_expert or cfg.d_ff
    std = (2.0 / (d + fe)) ** 0.5
    return {
        "router": layers._dense_init(gen, d, E, torch.float32),
        "w1": layers._normal(gen, (E, d, fe), std, dtype),
        "w3": layers._normal(gen, (E, d, fe), std, dtype),
        "w2": layers._normal(gen, (E, fe, d), std, dtype),
    }


def _top_k(cfg: ArchConfig, router: torch.Tensor, xg: torch.Tensor):
    """xg [G, ng, d] -> (probs [G, ng, E] (fp32), top_w, top_e [G, ng, k]); the
    top-k weights renormalised to sum to 1."""
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, top_w / top_w.sum(-1, keepdim=True), top_e


def _slots(cfg: ArchConfig, top_e: torch.Tensor, capacity: int):
    """Each (token, choice)'s slot in its expert, counted in token-major
    [ng * k] order within a group: top_e [G, ng, k] -> (scatter_e, scatter_p,
    keep) each [G, ng*k].  A choice at or past ``capacity`` is dropped and
    points at (E-1, capacity-1)."""
    E = cfg.n_experts
    G, ng, k = top_e.shape
    flat_e = top_e.reshape(G, ng * k)
    onehot = F.one_hot(flat_e, E)
    pos_in_e = torch.cumsum(onehot, dim=1) - onehot
    flat_pos = (pos_in_e * onehot).sum(-1)
    keep = flat_pos < capacity
    scatter_e = torch.where(keep, flat_e, E - 1)
    scatter_p = torch.where(keep, flat_pos, capacity - 1)
    return scatter_e, scatter_p, keep


def _route(cfg: ArchConfig, router: torch.Tensor, xg: torch.Tensor, capacity: int):
    """Group-local routing.  xg [G, ng, d] -> (scatter_e, scatter_p, keep)
    each [G, ng*k], and top_w [G, ng, k]."""
    _, top_w, top_e = _top_k(cfg, router, xg)
    return (*_slots(cfg, top_e, capacity), top_w)


def n_groups(n: int, groups: int = 16) -> int:
    """The reference's group count: ``groups`` halved until it divides n."""
    g = groups
    while n % g or n // g < 1:
        g //= 2
    return g


def moe_block(cfg: ArchConfig, p: Params, x: torch.Tensor, groups: int = 16,
              mlp: Params = None) -> torch.Tensor:
    """x [B, T, d] -> [B, T, d]; ``mlp``: arctic's dense residual branch."""
    b, t, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n = b * t
    G = n_groups(n, groups)
    ng = n // G
    xg = x.reshape(G, ng, d)
    capacity = int(ng * k / E * cfg.capacity_factor) + 1
    scatter_e, scatter_p, keep, top_w = _route(cfg, p["router"], xg, capacity)

    # scatter (token, choice) rows into [E, G, C, d]; kept slots are distinct
    src = xg.repeat_interleave(k, dim=1)                     # [G, ng*k, d]
    contrib = torch.where(keep[..., None], src, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    gidx = torch.arange(G, device=x.device)[:, None].expand_as(scatter_e)
    buf = x.new_zeros((E, G, capacity, d)).index_put(
        (scatter_e, gidx, scatter_p), contrib, accumulate=True)

    # batched expert SwiGLU: expert e's G*C rows against its weights
    rows = buf.reshape(E, G * capacity, d)
    gate = F.silu(layers._mm(rows, p["w1"]))
    out_buf = layers._mm(gate * layers._mm(rows, p["w3"]), p["w2"])
    out_buf = out_buf.reshape(E, G, capacity, d)

    # gather back and combine
    gathered = out_buf[scatter_e, gidx, scatter_p]           # [G, ng*k, d]
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=gathered.dtype, device=x.device))
    w = top_w.reshape(G, ng * k, 1).to(x.dtype)
    out = (gathered * w).reshape(G, ng, k, d).sum(2).reshape(b, t, d)
    if mlp is not None:
        out = out + layers.swiglu(mlp, x)
    return out


def load_balance_loss(cfg: ArchConfig, gate_probs: torch.Tensor,
                      top_e: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum(fraction routed first * mean
    probability), over dim 0.  No loss in the reference or here adds it."""
    E = cfg.n_experts
    me = F.one_hot(top_e[..., 0], E).float().mean(0)
    pe = gate_probs.mean(0)
    return E * (me * pe).sum()
