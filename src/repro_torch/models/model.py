"""Uniform model API over the ported architectures.

    api = get_model(cfg)
    params = api.init(seed, dtype, device)
    logits = api.forward(params, tokens)
    logits, cache = api.prefill(params, tokens, smax, kv_dtype)
    logits, cache = api.decode(params, token, cache, cache_len)
    cache_spec    = api.cache_spec(batch, smax, kv_dtype)  # {name: (shape, dtype)}

musicgen-large and chameleon-34b reuse the dense backbone; their modality
frontends are stubs, as in the reference: the inputs are token ids.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig
from . import transformer

_NOT_PORTED = {
    "moe": "ROADMAP.md, open item 1.6 (models/moe.py)",
    "ssm": "ROADMAP.md, open item 1.7 (models/rwkv6.py)",
    "hybrid": "ROADMAP.md, open item 1.8 (models/zamba2.py)",
}


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ArchConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    cache_spec: Callable[..., Any]


def get_model(cfg: ArchConfig) -> ModelApi:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to PyTorch yet; "
            f"see {_NOT_PORTED[cfg.family]}")
    # dense / audio / vlm use the transformer backbone
    return ModelApi(
        cfg=cfg,
        init=lambda seed=0, dtype=torch.bfloat16, device="cuda":
            transformer.init_params(cfg, seed, dtype, device),
        forward=lambda p, toks: transformer.forward(cfg, p, toks),
        prefill=lambda p, toks, smax, kv="bfloat16":
            transformer.prefill(cfg, p, toks, smax, kv),
        decode=lambda p, tok, cache, cache_len:
            transformer.decode_step(cfg, p, tok, cache, cache_len),
        cache_spec=lambda batch, smax, kv="bfloat16":
            transformer.kv_cache_spec(cfg, batch, smax, kv),
    )
