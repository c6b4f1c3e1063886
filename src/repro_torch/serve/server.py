"""Batched serving through fixed batch slots: prefill, then cached decode.

The same semantics as ``repro.serve.server``: requests are served in waves
of ``batch`` slots, a short wave is filled with dummy requests, prompts are
left-padded with token 0 (and, as in the reference, no pad mask is applied,
so pad tokens are attended to), decoding is greedy over the real vocab, and
the cache length starts at the wave's longest prompt.  The cache is what
the model's ``prefill`` returns (a KV cache, or rwkv6's and zamba2's
recurrent state) and is handed back to ``decode`` unread.  On the card every
decode step of a wave but the first runs with the server's ``graphs.StepGraphs``
on, so the segments a model marks in its step are captured once a wave and
replayed (``serve.graphs``); a model that marks none runs as it would without.

``placed_prefill`` and ``placed_decode`` are the model's prefill and decode
on a mesh, on DTensors placed as the reference's dry run places its
jitted serving calls (``repro.launch.dryrun.lower_cell``): the params by
``param_shardings``, the tokens by ``input_shardings`` (rows over the data
axes), the cache by ``cache_shardings`` (rows over the data axes; the KV
heads over "model" where they divide it, else the sequence; rwkv6's and
zamba2's recurrent states by their heads or channels, the shift states by
d); they return the logits placed by ``logits_sharding`` (vocab over
"model") and the cache as it came in.  ``BatchServer`` stays mesh-free, as
the reference's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor

from .. import obs, resolve_device
from ..configs.base import ArchConfig
from ..models import get_model
from ..models.layers import padded_vocab
from ..parallel import ctx
from ..parallel import sharding as shd
from ..train.optimizer import flatten_with_paths, unflatten
from . import graphs


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: Optional[List[int]] = None


class BatchServer:
    """``temperature`` is accepted and never read, as in the reference:
    decoding is greedy."""

    def __init__(self, cfg: ArchConfig, params, batch: int = 4,
                 smax: int = 128, temperature: float = 0.0, device="cuda"):
        self.cfg = cfg
        self.api = get_model(cfg)
        self.params = params
        self.batch = batch
        self.smax = smax
        self.device = resolve_device(device)
        self.graphs = graphs.StepGraphs(self.device) if self.device.type == "cuda" else None

    @torch.inference_mode()
    def serve(self, requests: List[Request]) -> List[Request]:
        """Serve a queue of requests through fixed batch slots."""
        queue = list(requests)
        done: List[Request] = []
        vocab = self.cfg.vocab
        while queue:
            wave = queue[: self.batch]
            queue = queue[self.batch:]
            # pad the wave to full batch with a dummy
            while len(wave) < self.batch:
                wave.append(Request(rid=-1, prompt=[0], max_new=0))
            with obs.span("serve.wave"):
                max_p = max(len(r.prompt) for r in wave)
                toks = torch.zeros((self.batch, max_p), dtype=torch.long)
                for i, r in enumerate(wave):
                    toks[i, max_p - len(r.prompt):] = torch.tensor(r.prompt)  # left-pad
                with obs.span("serve.prefill"):
                    logits, cache = self.api.prefill(self.params, toks.to(self.device),
                                                     self.smax)
                    cur = logits[:, -1, :vocab].argmax(-1)
                    outs = [[t] for t in cur.tolist()]
                cache_len = max_p
                steps = max((r.max_new for r in wave), default=0)
                for i in range(max(steps - 1, 0)):
                    with self._graphed(i), obs.span("serve.decode"):
                        logits, cache = self.api.decode(self.params, cur[:, None], cache,
                                                        cache_len)
                        cache_len += 1
                        cur = logits[:, -1, :vocab].argmax(-1)
                        with obs.span("serve.tokens"):
                            new = cur.tolist()
                        for out, t in zip(outs, new):
                            out.append(t)
                del cache   # free this wave's cache before the next wave allocates one
                if self.graphs is not None:
                    self.graphs.reset()
            for i, r in enumerate(wave):
                if r.rid >= 0:
                    r.out = outs[i][: r.max_new]
                    done.append(r)
        return done

    def _graphed(self, step: int):
        """The context of a wave's decode step ``step``: its segments graphed on the
        card from the second step on."""
        if self.graphs is None or step == 0:
            return contextlib.nullcontext()
        return self.graphs.on()


# ------------------------------------------------------------------ on a mesh

def cache_specs(cfg: ArchConfig, shapes: Dict[str, tuple], mesh) -> Dict[str, tuple]:
    """Each cache leaf's spec in placed serving, from the leaves' whole
    shapes: ``sharding.cache_pspec``'s."""
    return {name: shd.cache_pspec(name, tuple(shape), mesh, cfg)
            for name, shape in shapes.items()}


def _kv_split(specs) -> Optional[str]:
    """How the cache placed by ``specs`` splits the K/V over "model" (``ctx.kv_split``)."""
    spec = specs.get("k")
    if spec and spec[3] == shd.MP:
        return "heads"
    if spec and spec[2] == shd.MP:
        return "sequence"
    return None


def _blocks(tree, specs, mesh, what: str):
    """Each DTensor leaf's own block, after checking that it is placed on
    ``mesh`` as its spec (a tree like ``tree``) says."""
    spec_of = dict(flatten_with_paths(specs))
    out = []
    for path, x in flatten_with_paths(tree):
        want = shd.placements(spec_of[path], mesh)
        got = (tuple(x.placements) if isinstance(x, DTensor) and x.device_mesh == mesh
               else "not a DTensor on the mesh")
        if got != want:
            raise ValueError(f"{what} {shd.path_str(path)}: placed {got}, expected {want} "
                             f"(spec {spec_of[path]})")
        out.append((path, x.to_local()))
    return unflatten(out)


def _dtensor(block: torch.Tensor, spec, mesh, shape) -> DTensor:
    """``block`` as this rank's block of a DTensor of the whole ``shape``
    placed by ``spec``."""
    return DTensor.from_local(block, mesh, shd.placements(spec, mesh), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _call(cfg: ArchConfig, fn, params, tokens, cache_shapes, mesh, cache=None):
    """``fn(params, tokens, cache)`` on the blocks of placed inputs; returns
    the logits and cache as DTensors."""
    b = tokens.shape[0]
    p_specs = shd.param_shardings(cfg, params, mesh)
    c_specs = cache_specs(cfg, cache_shapes, mesh)
    local = _blocks(params, p_specs, mesh, "params")
    toks = _blocks({"tokens": tokens}, shd.input_shardings(mesh, {"tokens": tokens}), mesh,
                   "tokens")["tokens"]
    if cache is not None:
        cache = _blocks(cache, c_specs, mesh, "cache")
    pls = unflatten((path, x.placements) for path, x in flatten_with_paths(params))
    with ctx.mesh_context(mesh), ctx.sharded_batch(), ctx.placed_params(pls), \
            ctx.placed_cache(_kv_split(c_specs)):
        logits, cache = fn(local, toks, cache)
    return (_dtensor(logits, shd.logits_sharding(mesh, b), mesh,
                     (b, logits.shape[1], padded_vocab(cfg))),
            {name: _dtensor(x, c_specs[name], mesh, cache_shapes[name])
             for name, x in cache.items()})


@torch.no_grad()
def placed_prefill(cfg: ArchConfig, params, tokens: DTensor, smax: int, kv_dtype: str,
                   mesh):
    """The model's prefill on ``mesh``: params placed by
    ``sharding.param_shardings``, tokens [B, T] by ``input_shardings``.
    Each rank runs its rows of the batch on its blocks (tensor-parallel over
    "model") and writes its block of the cache.  Returns (logits [B, 1,
    V_pad] placed by ``logits_sharding``, the cache placed by
    ``cache_specs``); raises ValueError on an input placed otherwise."""
    api = get_model(cfg)
    shapes = {name: shape for name, (shape, _) in
              api.cache_spec(tokens.shape[0], smax, kv_dtype).items()}
    return _call(cfg, lambda p, toks, _: api.prefill(p, toks, smax, kv_dtype), params, tokens,
                 shapes, mesh)


@torch.no_grad()
def placed_decode(cfg: ArchConfig, params, token: DTensor, cache, cache_len: int, mesh):
    """The model's decode step on ``mesh``: params and token [B, 1] as
    ``placed_prefill`` takes them, the cache as it returns it (written in
    place on each rank's block).  Returns (logits, cache) placed as
    ``placed_prefill`` returns them; raises ValueError on an input placed
    otherwise."""
    api = get_model(cfg)
    shapes = {name: tuple(x.shape) for name, x in cache.items()}
    return _call(cfg, lambda p, tok, c: api.decode(p, tok, c, cache_len), params, token,
                 shapes, mesh, cache)
