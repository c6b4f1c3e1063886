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
matrix product; the values are the same.

Under a mesh with a "model" axis, ``moe_block`` takes
``moe_block_shard_map``, the reference's expert-parallel path: each data
rank routes its own group of tokens, each model rank runs its share of the
experts (or of every expert's hidden dim) and one all-reduce over "model"
completes the block.  The reference's sharding hints (``_maybe_constrain``)
are no-ops without GSPMD and have no counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..parallel import ctx, spmd
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
    # F.one_hot, written out: its range check reads the indices back to the host
    onehot = (flat_e[..., None] == torch.arange(E, device=flat_e.device)).long()
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


def _dispatch(x: torch.Tensor, keep: torch.Tensor, scatter_e, scatter_p, k: int,
              n_experts: int, capacity: int):
    """Scatter each kept (token, choice) row of x [G, ng, d] into an
    [n_experts, G, C, d] buffer at (scatter_e, group, scatter_p); kept slots
    are distinct.  Returns (buffer, the group index of each row)."""
    G, _, d = x.shape
    src = x.repeat_interleave(k, dim=1)                      # [G, ng*k, d]
    contrib = torch.where(keep[..., None], src, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    gidx = torch.arange(G, device=x.device)[:, None].expand_as(scatter_e)
    buf = x.new_zeros((n_experts, G, capacity, d)).index_put(
        (scatter_e, gidx, scatter_p), contrib, accumulate=True)
    return buf, gidx


def _experts(buf: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """Batched expert SwiGLU: expert e's G*C rows of buf [E, G, C, d] against
    its weights."""
    E, G, C, d = buf.shape
    rows = buf.reshape(E, G * C, d)
    gate = F.silu(layers._mm(rows, w1))
    return layers._mm(gate * layers._mm(rows, w3), w2).reshape(E, G, C, -1)


def _combine(out_buf, scatter_e, gidx, scatter_p, keep, top_w, dtype) -> torch.Tensor:
    """Gather each kept (token, choice)'s expert output and sum a token's k
    choices with its routing weights -> [G, ng, d]."""
    G, ng, k = top_w.shape
    gathered = out_buf[scatter_e, gidx, scatter_p]           # [G, ng*k, d]
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=gathered.dtype, device=gathered.device))
    w = top_w.reshape(G, ng * k, 1).to(dtype)
    return (gathered * w).reshape(G, ng, k, -1).sum(2)


def moe_block_shard_map(cfg: ArchConfig, p: Params, x: torch.Tensor, mesh,
                        mlp: Params = None) -> torch.Tensor:
    """Expert-parallel MoE, SPMD over the mesh (the reference's ``shard_map``).

    Tokens are routed in G = dp groups, one a data rank (with
    ``ctx.batch_sharded()`` a rank's x is its group; otherwise every rank
    holds all B*T tokens and takes group number ``data index``).  Every
    model rank routes its group alike, then:
      * E % model == 0 (arctic): rank r keeps the slots of its experts
        [r E/model, (r+1) E/model) and runs only those;
      * otherwise (mixtral): every rank runs every expert on its share of
        the hidden dim.
    Each rank combines its partial outputs, arctic's dense residual MLP
    (hidden dim split likewise) is added to them, and one all-reduce over
    "model" completes the block.  The group's rows are then gathered over
    the data axes when x held the whole batch.  Under placed parameters a
    rank's expert weights arrive as its blocks, its own experts or its
    share of every expert's hidden dim, and are used as they are."""
    b, t, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    data_idx, dp = spmd.data_index(mesh)
    mp = mesh.size(mesh.mesh_dim_names.index("model"))
    ep = E % mp == 0          # expert-parallel (arctic) vs TP-in-expert (mixtral)
    e_loc = E // mp if ep else E
    if ctx.batch_sharded():
        xg = x.reshape(1, b * t, d)
    else:
        xg = x.reshape(dp, b * t // dp, d)[data_idx:data_idx + 1]
    ng = xg.shape[1]
    capacity = int(ng * k / E * cfg.capacity_factor) + 1
    xg = spmd.enter_model(xg, mesh)
    scatter_e, scatter_p, keep, top_w = _route(
        cfg, spmd.model_whole(p["router"], mesh), xg, capacity)
    if ep:
        lo = spmd.model_rank(mesh) * e_loc
        mine = keep & (scatter_e >= lo) & (scatter_e < lo + e_loc)
        slot_e = torch.clamp(scatter_e - lo, 0, e_loc - 1)
        w1, w3, w2 = (spmd.model_part(p[n], mesh, 0, e_loc) for n in ("w1", "w3", "w2"))
    else:
        fe = spmd.whole_size(p["w1"], 2, mesh)
        mine, slot_e = keep, scatter_e
        w1, w3, w2 = (spmd.model_part(p[n], mesh, dim, fe // mp)
                      for n, dim in (("w1", 2), ("w3", 2), ("w2", 1)))
    buf, gidx = _dispatch(xg, mine, slot_e, scatter_p, k, e_loc, capacity)
    out = _combine(_experts(buf, w1, w3, w2), slot_e, gidx, scatter_p, mine, top_w,
                   x.dtype)
    if mlp is not None:
        # arctic's dense residual MLP, hidden dim split over "model", folded
        # into the same all-reduce as the expert combine
        f = spmd.whole_size(mlp["w1"], 1, mesh) // mp
        m1, m3, m2 = (spmd.model_part(mlp[n], mesh, dim, f)
                      for n, dim in (("w1", 1), ("w3", 1), ("w2", 0)))
        out = out + layers._mm(F.silu(layers._mm(xg, m1)) * layers._mm(xg, m3), m2)
    out = spmd.reduce_model(out, mesh)
    if not ctx.batch_sharded():
        out = spmd.gather_data(out, mesh)
    return out.reshape(b, t, d)


def moe_block(cfg: ArchConfig, p: Params, x: torch.Tensor, groups: int = 16,
              mlp: Params = None) -> torch.Tensor:
    """x [B, T, d] -> [B, T, d]; ``mlp``: arctic's dense residual branch.

    Under a mesh with a "model" axis, the expert-parallel
    ``moe_block_shard_map`` when the tokens form one group a data rank (B*T
    a multiple of the data ranks, or ``ctx.batch_sharded()``); otherwise,
    and with no mesh, group-local dispatch in ``groups`` groups here."""
    b, t, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n = b * t
    mesh = layers.tp_mesh()
    if mesh is not None:
        dp = spmd.data_index(mesh)[1]
        if ctx.batch_sharded() or (n % dp == 0 and n >= dp):
            return moe_block_shard_map(cfg, p, x, mesh, mlp=mlp)
        # tiny token counts (batch-1 decode) can't form a group a data rank:
        # the local dispatch below
    G = n_groups(n, groups)
    ng = n // G
    xg = x.reshape(G, ng, d)
    capacity = int(ng * k / E * cfg.capacity_factor) + 1
    scatter_e, scatter_p, keep, top_w = _route(cfg, p["router"], xg, capacity)
    buf, gidx = _dispatch(xg, keep, scatter_e, scatter_p, k, E, capacity)
    out_buf = _experts(buf, p["w1"], p["w3"], p["w2"])
    out = _combine(out_buf, scatter_e, gidx, scatter_p, keep, top_w,
                   x.dtype).reshape(b, t, d)
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
