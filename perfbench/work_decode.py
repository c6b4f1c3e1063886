"""K5's work, frozen: the decode kernel's flops and bytes from its call's shapes.

A copy of ``repro_torch/kernels/work.py``'s ``decode_attention_work`` as it
stood when ``decode_attn_roofline.decode`` was defined (``perfbench/work.py``
was frozen before the kernel existed), so a later change to the program's
count does not move the yardstick.
"""

from __future__ import annotations

from typing import Tuple


def decode_attention_work(b: int, n_valid: int, kv: int, g: int, hd: int,
                          q_itemsize: int) -> Tuple[int, int]:
    """K5: the plain path's score and value products over the slots the kernel reads,
    2 products of 2*hd flops per (query head, valid slot); the valid slots' bf16 K and V
    rows read once, q read and out written in q's dtype (the splits' scratch apart)."""
    flops = 4 * hd * b * kv * g * n_valid
    nbytes = 2 * b * n_valid * kv * hd * 2 + 2 * b * kv * g * hd * q_itemsize
    return flops, nbytes
