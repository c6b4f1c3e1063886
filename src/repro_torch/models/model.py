"""Uniform model API over the ported architectures.

    api = get_model(cfg)
    params = api.init(seed, dtype, device)
    logits = api.forward(params, tokens)
    loss   = api.loss(params, {"tokens", "labels"})
    logits, cache = api.prefill(params, tokens, smax, kv_dtype)
    logits, cache = api.decode(params, token, cache, cache_len)
    cache_spec    = api.cache_spec(batch, smax, kv_dtype)  # {name: (shape, dtype)}
    specs         = input_specs(cfg, shape)                # {name: (shape, dtype)}

musicgen-large and chameleon-34b reuse the dense backbone; their modality
frontends are stubs, as in the reference: the inputs are token ids.
mixtral-8x22b and arctic-480b (family ``moe``) use it too, with an MoE
block in place of the MLP; their load-balance loss is not part of
``loss``, as in the reference.  For rwkv6 (family ``ssm``) and zamba2
(``hybrid``) the cache is the model's recurrent state (and, for zamba2,
the shared block's K/V): a dict the server hands back to ``decode``
unread.  zamba2-7b-instruct, the published Zamba2-7B hybrid, is served only.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from . import rwkv6, transformer, zamba2

@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    cache_spec: Callable[..., Any]


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family == "ssm":          # rwkv6
        return ModelApi(
            cfg=cfg,
            init=lambda seed=0, dtype=torch.bfloat16, device="cuda":
                rwkv6.init_params(cfg, seed, dtype, device),
            forward=lambda p, toks: rwkv6.forward(cfg, p, toks)[0],
            loss=lambda p, b: rwkv6.loss_fn(cfg, p, b),
            prefill=lambda p, toks, smax=0, kv="bfloat16":
                rwkv6.prefill(cfg, p, toks, smax, kv),
            decode=lambda p, tok, cache, cache_len:
                rwkv6.decode_step(cfg, p, tok, cache, cache_len),
            cache_spec=lambda batch, smax=0, kv="bfloat16": rwkv6.state_spec(cfg, batch),
        )
    if cfg.family == "hybrid" and zamba2.published(cfg):     # the published Zamba2 block
        return ModelApi(
            cfg=cfg,
            init=lambda seed=0, dtype=torch.bfloat16, device="cuda":
                zamba2.init_pub_params(cfg, seed, dtype, device),
            forward=lambda p, toks: zamba2.pub_prefill(cfg, p, toks, toks.shape[1],
                                                       last_only=False)[0],
            loss=lambda p, b: zamba2.pub_loss_fn(cfg, p, b),
            prefill=lambda p, toks, smax, kv="bfloat16": zamba2.pub_prefill(cfg, p, toks, smax),
            decode=lambda p, tok, cache, cache_len:
                zamba2.pub_decode_step(cfg, p, tok, cache, cache_len),
            cache_spec=lambda batch, smax, kv="bfloat16": zamba2.pub_state_spec(cfg, batch, smax),
        )
    if cfg.family == "hybrid":       # zamba2
        return ModelApi(
            cfg=cfg,
            init=lambda seed=0, dtype=torch.bfloat16, device="cuda":
                zamba2.init_params(cfg, seed, dtype, device),
            forward=lambda p, toks: zamba2.forward(cfg, p, toks)[0],
            loss=lambda p, b: zamba2.loss_fn(cfg, p, b),
            prefill=lambda p, toks, smax, kv="bfloat16":
                zamba2.prefill(cfg, p, toks, smax, kv),
            decode=lambda p, tok, cache, cache_len:
                zamba2.decode_step(cfg, p, tok, cache, cache_len),
            cache_spec=lambda batch, smax, kv="bfloat16":
                zamba2.state_spec(cfg, batch, smax, kv),
        )
    # dense / moe / audio / vlm use the transformer backbone
    return ModelApi(
        cfg=cfg,
        init=lambda seed=0, dtype=torch.bfloat16, device="cuda":
            transformer.init_params(cfg, seed, dtype, device),
        forward=lambda p, toks: transformer.forward(cfg, p, toks),
        loss=lambda p, b: transformer.loss_fn(cfg, p, b),
        prefill=lambda p, toks, smax, kv="bfloat16":
            transformer.prefill(cfg, p, toks, smax, kv),
        decode=lambda p, tok, cache, cache_len:
            transformer.decode_step(cfg, p, tok, cache, cache_len),
        cache_spec=lambda batch, smax, kv="bfloat16":
            transformer.kv_cache_spec(cfg, batch, smax, kv),
    )


def input_specs(cfg: ArchConfig, shape, mode: Optional[str] = None
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input of one dry-run cell, as
    ``cache_spec`` gives the cache's.

    For the audio and vlm archs the frontend is a stub: the specs are the
    precomputed token stream the frontend would produce."""
    mode = mode or shape.kind
    b, t = shape.global_batch, shape.seq_len
    if mode == "train":
        return {"tokens": ((b, t), torch.int32), "labels": ((b, t), torch.int32)}
    if mode == "prefill":
        return {"tokens": ((b, t), torch.int32)}
    if mode == "decode":
        return {"token": ((b, 1), torch.int32)}
    raise ValueError(mode)


def kv_dtype_for_cell(cfg: ArchConfig, shape_name: str) -> str:
    """The KV cache's dtype name for a cell: the decode_32k override where the
    config has one."""
    if shape_name == "decode_32k" and cfg.kv_cache_dtype_decode_32k:
        return cfg.kv_cache_dtype_decode_32k
    return cfg.kv_cache_dtype
