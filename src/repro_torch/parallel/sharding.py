"""Sharding rules: DP / TP / EP / SP / ZeRO-1 for every architecture.

Mirrors ``repro.parallel.sharding``, rule for rule:
  * batch dims           -> ("pod", "data") on the multi-pod mesh, ("data",)
                            on the single-pod mesh;
  * expanding matmuls    -> output dim over "model" (TP); contracting side
                            mirrored so wo/w2 reduce over "model";
  * embeddings           -> vocab over "model";
  * MoE experts          -> E over "model" when divisible (arctic 128/16);
                            otherwise TP inside the expert FFN (mixtral);
  * KV caches / states   -> batch over data axes, heads over "model";
  * FSDP archs (arctic, mixtral) -> parameters also sharded over the data
    axes on the marked dim; ZeRO-1 shards every arch's optimizer moments
    the same way.

Rules are (fnmatch pattern, per-dim axes) applied to the TRAILING dims, so
layer-stacked ([L, ...]) and unstacked parameters share one table.

A spec is a tuple with one entry per tensor dim (the reference's
``PartitionSpec``): None, an axis name, or a tuple of axis names; () is
replicated.  ``placements`` turns it into DTensor placements, one per mesh
dim.  The rules read only the mesh's axis names and sizes, so they take a
``DeviceMesh`` or a plain {axis name: size} dict in its place.
"""

from __future__ import annotations

import fnmatch
from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ArchConfig
from ..train.optimizer import flatten_with_paths, unflatten
from . import ctx

Spec = Tuple[Any, ...]

# sentinel resolved per-arch/per-mesh
FSDP = "__fsdp__"
MP = "model"

# (pattern, trailing dim axes)
_RULES: List[Tuple[str, Tuple]] = [
    ("*emb/tok", (MP, FSDP)),
    ("*emb/out", (FSDP, MP)),
    ("*emb/ln_f", (None,)),
    # attention
    ("*attn/wq", (FSDP, MP)),
    ("*attn/wk", (FSDP, MP)),
    ("*attn/wv", (FSDP, MP)),
    ("*attn/wo", (MP, FSDP)),
    ("*attn/b?", (MP,)),
    ("*attn/?_norm", (None,)),
    # dense mlp
    ("*mlp/w1", (FSDP, MP)),
    ("*mlp/w3", (FSDP, MP)),
    ("*mlp/w2", (MP, FSDP)),
    # moe (E-divisible case; the non-divisible case is rewritten below)
    ("*moe/router", (FSDP, None)),
    ("*moe/w1", (MP, FSDP, None)),
    ("*moe/w3", (MP, FSDP, None)),
    ("*moe/w2", (MP, None, FSDP)),
    # rwkv6
    ("*tmix/w[rkvg]", (FSDP, MP)),
    ("*tmix/wo", (MP, FSDP)),
    ("*tmix/ln_x", (MP,)),
    ("*tmix/decay", (MP,)),
    ("*tmix/decay_w1", (FSDP, None)),
    ("*tmix/decay_w2", (None, MP)),
    ("*tmix/u", (MP, None)),
    ("*tmix/maa_w1", (FSDP, None)),
    ("*tmix/maa_w2", (None, None, MP)),
    ("*tmix/maa*", (None,)),
    ("*cmix/wk", (FSDP, MP)),
    ("*cmix/wv", (MP, FSDP)),
    ("*cmix/wr", (FSDP, MP)),
    ("*cmix/maa*", (None,)),
    # mamba2 (split projections)
    ("*in_z", (FSDP, MP)),
    ("*in_x", (FSDP, MP)),
    ("*in_B", (FSDP, None)),
    ("*in_C", (FSDP, None)),
    ("*in_dt", (FSDP, None)),
    ("*conv_w", (None, MP)),
    ("*conv_b", (MP,)),
    ("*A_log", (None,)),
    ("*/D", (None,)),
    ("*dt_bias", (None,)),
    ("*/norm", (MP,)),
    ("*out_proj", (MP, FSDP)),
    # norms / everything else 1-D
    ("*ln*", (None,)),
]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size}, in the mesh's order, of a ``DeviceMesh`` or a dict."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def needs_fsdp(cfg: ArchConfig) -> bool:
    """Params too large to replicate across data shards: only arctic (960 GB)
    and mixtral (280 GB) of bf16."""
    return cfg.param_count() * 2 > 120e9


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _dsize(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= axis_sizes(mesh)[a]
    return n


def _daxis(mesh):
    d = data_axes(mesh)
    return d if len(d) > 1 else d[0]


def _resolve(rule: Tuple, shape: Tuple[int, ...], cfg: ArchConfig, mesh) -> Spec:
    entries: List[Any] = [None] * (len(shape) - len(rule)) + list(rule)
    dsize, msize = _dsize(mesh), axis_sizes(mesh)[MP]
    out: List[Any] = []
    for dim, e in zip(shape, entries):
        if e == FSDP:
            out.append(_daxis(mesh) if needs_fsdp(cfg) and dim % dsize == 0 else None)
        elif e == MP:
            out.append(MP if dim % msize == 0 else None)
        else:
            out.append(e)
    return tuple(out)


def path_str(path) -> str:
    return "/".join(str(p) for p in path)


def param_pspec(path: str, shape: Tuple[int, ...], cfg: ArchConfig, mesh) -> Spec:
    rules = _RULES
    msize = axis_sizes(mesh)[MP]
    if cfg.n_experts and cfg.n_experts % msize != 0:
        # mixtral-style: experts replicated, TP inside the expert FFN
        rules = [
            ("*moe/w1", (None, FSDP, MP)),
            ("*moe/w3", (None, FSDP, MP)),
            ("*moe/w2", (None, MP, FSDP)),
        ] + rules
    if cfg.n_kv_heads != cfg.n_heads and cfg.n_kv_heads % msize != 0:
        # GQA with kv heads that don't divide the TP axis: replicate the
        # (small) kv projections, so the per-q-head expansion in
        # layers._qkv(pad_tp=True) is local
        rules = [
            ("*attn/wk", (FSDP, None)),
            ("*attn/wv", (FSDP, None)),
            ("*attn/bk", (None,)),
            ("*attn/bv", (None,)),
        ] + rules
    for pat, rule in rules:
        if fnmatch.fnmatch(path, pat):
            return _resolve(rule, shape, cfg, mesh)
    return ()  # replicate


def _tree_map(fn, tree):
    """fn(path, leaf) over a nested dict's leaves."""
    return unflatten((path, fn(path, x)) for path, x in flatten_with_paths(tree))


def param_shardings(cfg: ArchConfig, params_tree, mesh):
    """Tree of specs, one a parameter (tensors, fake tensors or anything
    with ``.shape``)."""
    return _tree_map(lambda p, x: param_pspec(path_str(p), tuple(x.shape), cfg, mesh),
                     params_tree)


# ------------------------------------------------------------- activations

def batch_pspec(mesh) -> Spec:
    return (_daxis(mesh),)


def input_shardings(mesh, inputs_tree):
    dsize = _dsize(mesh)

    def leaf(_, x):
        # batch=1 (long-context decode) cannot shard over the data axes
        if x.shape[0] % dsize != 0:
            return (None,) * len(x.shape)
        return (_daxis(mesh),) + (None,) * (len(x.shape) - 1)
    return _tree_map(leaf, inputs_tree)


def logits_sharding(mesh, batch: int) -> Spec:
    return (_daxis(mesh) if batch % _dsize(mesh) == 0 else None, None, MP)


def cache_pspec(name: str, shape: Tuple[int, ...], mesh, cfg: ArchConfig) -> Spec:
    """KV caches and recurrent states: [L?, B, S, KV, hd]-style layouts.
    Batch over data axes, head-ish dim over model when divisible."""
    daxis, dsize, msize = _daxis(mesh), _dsize(mesh), axis_sizes(mesh)[MP]
    batch = daxis if shape[1] % dsize == 0 else None
    if name in ("k", "v", "k_scale", "v_scale"):
        # [L, B, S, KV, hd]: heads over model when divisible; otherwise the
        # sequence dim (context-parallel attention), as also where
        # ctx.force_sequence_split() says so
        if shape[-2] % msize == 0 and not ctx.sequence_split_forced():
            return (None, batch, None, MP, None)
        return (None, batch, MP if shape[2] % msize == 0 else None, None, None)
    if name == "conv":   # [L, B, C, K]
        return (None, batch, MP if shape[2] % msize == 0 else None, None)
    if name in ("ssd", "wkv"):  # [L, B, H, P, N]
        return (None, batch, MP if shape[2] % msize == 0 else None, None, None)
    if name in ("tmix_x", "cmix_x"):  # [L, B, d]
        return (None, batch, MP if shape[2] % msize == 0 else None)
    return ()


def cache_shardings(cfg: ArchConfig, cache_tree, mesh):
    return _tree_map(lambda p, x: cache_pspec(p[-1], tuple(x.shape), mesh, cfg),
                     cache_tree)


# ------------------------------------------------------------- optimizer

def zero1_pspec(pspec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """ZeRO-1: moments take the param spec + data sharding on the first
    still-unsharded divisible dim."""
    d, dsize = data_axes(mesh), _dsize(mesh)
    entries = list(pspec) + [None] * (len(shape) - len(pspec))
    if any(e in (d, d[0], "data", "pod") or isinstance(e, tuple) for e in entries if e):
        return tuple(entries)      # already data-sharded (FSDP arch)
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dsize == 0 and dim >= dsize:
            entries[i] = _daxis(mesh)
            return tuple(entries)
    return tuple(entries)


def opt_shardings(cfg: ArchConfig, params_tree, mesh):
    def leaf(path, x):
        shape = tuple(x.shape)
        return zero1_pspec(param_pspec(path_str(path), shape, cfg, mesh), shape, mesh)
    return _tree_map(leaf, params_tree)


# ------------------------------------------------------------- placement

def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` on each
    mesh dim that tensor dim d is split over, ``Replicate()`` elsewhere.  A
    dim split over two axes, ("pod", "data"), is ``Shard(d)`` on both, the
    first (pod) the major one."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_sizes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_block(full: torch.Tensor, pls, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under DTensor placements ``pls``: split
    along each sharded dim in mesh-dim order, as DTensor lays shards out
    (contiguous; ``full`` itself where nothing is split)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    t = full
    for i, pl in enumerate(pls):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(i), pl.dim)[coord[i]]
    return t.contiguous()


def sub_block(local: torch.Tensor, pls, block_pls, mesh) -> torch.Tensor:
    """This rank's block under ``block_pls`` of a tensor whose block under
    ``pls`` is ``local``, where ``block_pls`` only splits it further (ZeRO-1
    over the param's placement): a view of ``local``, split along each mesh
    dim that ``block_pls`` shards and ``pls`` does not."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    t = local
    for i, (pl, bpl) in enumerate(zip(pls, block_pls)):
        if isinstance(bpl, Shard) and not isinstance(pl, Shard):
            t = t.chunk(mesh.size(i), bpl.dim)[coord[i]]
        elif bpl != pl:
            raise ValueError(f"{block_pls} does not split {pls} further")
    return t


def from_block(block: torch.Tensor, pls, mesh, like):
    """``block`` as this rank's block of a DTensor placed by ``pls`` with the
    global shape of ``like`` (a DTensor)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(block, mesh, pls, run_check=False, shape=like.shape,
                              stride=like.stride())


def distribute(full: torch.Tensor, spec: Spec, mesh):
    """``full`` (the same on every rank) as a DTensor placed by ``spec``; each
    rank keeps its block, with no communication."""
    from torch.distributed.tensor import DTensor
    pls = placements(spec, mesh)
    stride, n = [], 1
    for d in reversed(full.shape):        # the whole tensor's, laid out contiguous
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(local_block(full, pls, mesh), mesh, pls,
                              run_check=False, shape=full.shape, stride=tuple(stride))


def distribute_tree(tree, specs, mesh):
    """A tree of full tensors placed leaf by leaf by a tree of specs."""
    spec_of = dict(flatten_with_paths(specs))
    return _tree_map(lambda p, x: distribute(x, spec_of[p], mesh), tree)
