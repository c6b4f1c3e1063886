"""The work each hand-written kernel does: flops and bytes from its inputs' shapes.

One count per kernel, read by two callers: ``chip_smoke.py`` holds a
kernel's time to its bound with it, and ``launch.roofline`` adds it to a
whole step's count when the kernel's operator runs (``KERNEL_OPS``, filled
by each kernel module when it registers its operator).  So a kernel's bound
and a step's bound count the same work.

Flops are the function's own, counted on the rows a causal mask or a ragged
chunk leaves (exponentials and logarithms apart, returned beside them for
the scans); bytes are each input read once and each output written once,
the scans' workspaces apart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np


def visible_pairs(tq: int, tk: int, q_offset: int, window: int) -> int:
    """(query, key) pairs the causal/window mask lets through: the work this input needs."""
    pos = q_offset + np.arange(tq, dtype=np.int64)
    hi = np.minimum(pos + 1, tk)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros_like(pos)
    return int(np.maximum(hi - lo, 0).sum())


def flash_fwd_work(b: int, tq: int, tk: int, kv: int, g: int, hd: int, window: int,
                   q_offset: int, itemsize: int) -> Tuple[int, int]:
    """K1: 2 products of 2*hd flops per visible pair (q.k and p.v); q, k, v read and
    out written in the inputs' dtype, lse [B,KV,G,Tq] written in fp32."""
    flops = 4 * hd * b * kv * g * visible_pairs(tq, tk, q_offset, window)
    nbytes = (2 * b * tq * kv * g * hd + 2 * b * tk * kv * hd) * itemsize + b * kv * g * tq * 4
    return flops, nbytes


def flash_bwd_work(b: int, tq: int, tk: int, kv: int, g: int, hd: int, window: int,
                   q_offset: int, itemsize: int) -> Tuple[int, int]:
    """K1-bwd: 5 products of 2*hd flops per visible pair (q.k and do.v recomputed,
    dv, dk, dq); q, out, do, k, v read and dq, dk, dv written, lse read and
    delta written in fp32."""
    flops = 10 * hd * b * kv * g * visible_pairs(tq, tk, q_offset, window)
    nbytes = 4 * (b * tq * kv * g * hd + b * tk * kv * hd) * itemsize + 2 * b * kv * g * tq * 4
    return flops, nbytes


def _over_chunks(t: int, chunk: int, per_chunk: Callable[[int], Tuple[int, ...]]):
    """Sum of ``per_chunk(rows)`` over the chunks of a sequence of ``t`` rows: every
    whole chunk gives the same, and the last may be ragged."""
    full, tail = divmod(t, chunk)
    total = [full * x for x in per_chunk(chunk)]
    if tail:
        total = [a + x for a, x in zip(total, per_chunk(tail))]
    return total


def wkv6_work(b: int, t: int, h: int, d: int, chunk: int) -> Tuple[int, int, int]:
    """K4: flops (exponentials and logarithms apart), exponentials and bytes of
    ref.rwkv6_chunked on real rows; K = V = d."""
    def per_chunk(c):
        pairs = c * (c - 1) // 2
        flops = (2 * c * d                        # log-decay cumsum, r * e^cl_prev
                 + 2 * c * d * d                  # (r e^cl_prev) S
                 + 4 * pairs * d                  # att: cl_prev_i - cl_j, r*k*e, sum
                 + 3 * c * d                      # u-bonus diagonal
                 + 2 * (pairs + c) * d + 2 * c * d    # att v, diag v, the sum of terms
                 + 2 * c * d + 2 * c * d * d + 2 * d * d)   # state update
        trans = 3 * c * d + pairs * d + d         # log w, e^cl_prev, carry, pairs, e^cl_last
        return flops, trans
    flops, trans = _over_chunks(t, chunk, per_chunk)
    heads = b * h
    nbytes = 4 * (5 * b * t * h * d + h * d + 2 * b * h * d * d)
    return flops * heads, trans * heads, nbytes


def ssd_work(b: int, t: int, h: int, p: int, n: int, chunk: int,
             groups: int = 1) -> Tuple[int, int, int]:
    """K3: flops (exponentials apart), exponentials and bytes of ref.mamba2_ssd on real
    rows; C B^T is counted once per batch and group of B and C, as the function needs it."""
    def per_chunk(c):
        pairs = c * (c + 1) // 2
        shared = 2 * pairs * n                    # C B^T, causal half
        flops = (2 * c                            # A dt, cumsum
                 + 3 * pairs                      # cl_i - cl_j, G*L, *dt_j
                 + 2 * c * p * n + c * p          # e^cl (C S^T)
                 + 2 * pairs * p + c * p          # M x, the sum of terms
                 + 2 * c + c * p + 2 * c * p * n + 2 * p * n)   # state update
        trans = pairs + 2 * c + 1
        return flops, trans, shared
    flops, trans, shared = _over_chunks(t, chunk, per_chunk)
    nbytes = 4 * (2 * b * t * h * p + b * t * h + h + 2 * b * t * groups * n
                  + 2 * b * h * p * n)
    return flops * b * h + shared * b * groups, trans * b * h, nbytes


def wkv6_bwd_work(b: int, t: int, h: int, d: int, chunk: int) -> Tuple[int, int, int]:
    """K4-bwd: flops (exponentials and logarithms apart), exponentials and bytes of
    the WKV6 backward on real rows, K = V = d: its inputs r, k, v, w, u, the initial
    state, dy and the final state's cotangent read once, dr, dk, dv, dw, du and ds0
    written once."""
    def per_chunk(c):
        pairs = c * (c - 1) // 2
        flops = (2 * c * d * d + 2 * d * d      # the state pass: (r e^clp)^T dy, the decay
                 + 2 * c * d                    # log-decay cumsum, r e^clp
                 + 2 * (pairs + c) * d          # datt = dy v^T (j <= i)
                 + 4 * pairs * d + 3 * c * d    # att and the u bonus
                 + 2 * (pairs + c) * d + 2 * c * d * d + c * d   # dv
                 + 2 * c * d * d + 2 * c * d * d + 2 * c * d     # dy S^T, v dS^T, scaled
                 + 2 * 5 * pairs * d            # datt's terms of dr and dk
                 + 8 * c * d                    # dr, dk, dclp, dcl, du
                 + 2 * d * d + 4 * c * d)       # the last row's term, dlog w, dw
        trans = 2 * c * d + 3 * pairs * d + 2 * d
        return flops, trans
    flops, trans = _over_chunks(t, chunk, per_chunk)
    nbytes = 4 * (9 * b * t * h * d + 2 * h * d + 3 * b * h * d * d)
    return flops * b * h, trans * b * h, nbytes


def ssd_bwd_work(b: int, t: int, h: int, p: int, n: int, chunk: int) -> Tuple[int, int, int]:
    """K3-bwd: flops (exponentials apart), exponentials and bytes of the SSD backward
    on real rows; C B^T is counted once per batch.  Inputs x, dt, A, B, C, the
    initial state, dy and the final state's cotangent read once; dx, ddt, dA, dB, dC
    and ds0 written once."""
    def per_chunk(c):
        pairs = c * (c + 1) // 2
        shared = 2 * pairs * n                  # C B^T, causal half
        flops = (2 * c * p * n + 2 * p * n + 2 * c   # the state pass, cumsum
                 + 2 * pairs * p + c * p        # dy xs^T, xs
                 + 4 * pairs                    # L, M, dG
                 + 2 * pairs * p + 2 * c * n * p + 2 * c * p   # dxs, dx
                 + 2 * c * p * n + c * n + 2 * pairs * n       # dC
                 + 2 * pairs * n + 2 * c * p * n + c * n       # dB
                 + 4 * pairs + 6 * c * p + 2 * p * n + 6 * c)  # dcl, da, ddt, dA
        trans = pairs + 3 * c
        return flops, trans, shared
    flops, trans, shared = _over_chunks(t, chunk, per_chunk)
    nbytes = 4 * (3 * b * t * h * p + 2 * b * t * h + 2 * h + 4 * b * t * n + 3 * b * h * p * n)
    return flops * b * h + shared * b, trans * b * h, nbytes


def decode_attention_work(b: int, n_valid: int, kv: int, g: int, hd: int,
                          q_itemsize: int) -> Tuple[int, int]:
    """K5: the plain path's score and value products over the slots the kernel reads,
    2 products of 2*hd flops per (query head, valid slot); the valid slots' bf16 K and V
    rows read once, q read and out written in q's dtype (the splits' scratch apart)."""
    flops = 4 * hd * b * kv * g * n_valid
    nbytes = 2 * b * n_valid * kv * hd * 2 + 2 * b * kv * g * hd * q_itemsize
    return flops, nbytes


def mamba2_step_work(b: int, h: int, p: int, n: int, groups: int) -> Tuple[int, int]:
    """K6: one token of a Mamba2 layer, conv width 4 over din + 2 G N channels: the
    conv's 8 flops a channel, the state's decay, update and product with C (6 a state
    element), D x and the gated norm (8 a channel); the fp32 state read and written
    once, the in_proj's bf16 output read, the bf16 conv state read and written, the
    bf16 output written (weights, dt_bias, A and D apart)."""
    din, c = h * p, h * p + 2 * groups * n
    flops = b * (8 * c + 6 * h * p * n + 8 * din)
    nbytes = 2 * 4 * b * h * p * n + 2 * b * (din + c + h) + 2 * 2 * b * c * 3 + 2 * b * din
    return flops, nbytes


def checksum_work(n_words: int) -> Tuple[int, int]:
    """K2: no floating-point operation (two integer multiply-adds a word, which no
    rate of the table bounds); each word read once, the digest written."""
    return 0, 4 * n_words + 8


@dataclasses.dataclass(frozen=True)
class KernelWork:
    """How a kernel's operator counts: ``count(*args)`` gives (flops, bytes) from
    the operator's arguments, and ``peak(*args)`` the key of the rate in
    ``launch.roofline.PEAK_FLOPS`` that its flops run at (``None`` for a kernel
    that does no floating-point operation)."""
    count: Callable[..., Tuple[int, int]]
    peak: Optional[Callable[..., str]]


# operator (an OpOverloadPacket, torch.ops.repro_torch.<name>) -> its work
KERNEL_OPS: Dict[object, KernelWork] = {}


def register(op, count: Callable[..., Tuple[int, int]],
             peak: Optional[Callable[..., str]]) -> None:
    """Record a kernel operator's work here, and its flops with
    ``torch.utils.flop_counter`` (so that ``FlopCounterMode`` counts it too)."""
    from torch.utils.flop_counter import register_flop_formula
    KERNEL_OPS[op] = KernelWork(count, peak)
    register_flop_formula(op, get_raw=True)(
        lambda *args, out_val=None, **kwargs: count(*args, **kwargs)[0])
