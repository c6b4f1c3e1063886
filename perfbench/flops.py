"""Model flops: the parameters a token passes through, from a configuration's sizes.

``body`` counts every product a token meets between the embedding and the
head, each layer once; the embedding lookup is no product.
``head`` is the output projection over the real vocabulary.  A token costs
2 flops a parameter forward and 6 in a training step; attention's own
score and value products and the recompute of checkpointed layers are left
out, so the share of the peak that follows is a floor.
"""

from __future__ import annotations

from typing import Dict

from .reference.layout import head_dim


def _attention_block(a: Dict) -> int:
    d, hd = a["d_model"], head_dim(a)
    return (d * a["n_heads"] * hd * 2 + d * a["n_kv_heads"] * hd * 2 + 3 * d * a["d_ff"])


def body(a: Dict) -> int:
    if a["family"] != "dense":
        raise ValueError(f"no flop count for family {a['family']!r}")
    return a["n_layers"] * _attention_block(a)


def head(a: Dict) -> int:
    return a["d_model"] * a["vocab"]


def train_step(a: Dict, tokens: int) -> float:
    return 6.0 * (body(a) + head(a)) * tokens


def decode(a: Dict, tokens: int) -> float:
    return 2.0 * (body(a) + head(a)) * tokens
