"""Hand-written CUDA decode attention for Hopper (``csrc/decode_attention.cu``).

One query token of each batch row against the valid slots ``[0, n_valid)`` of a
bf16 K/V cache, GQA, read in the cache's own layout ``[B, Smax, KV, hd]``.  It
replaces no TPU kernel: the JAX package's ``repro.models.layers.attention_decode``
is plain ``jnp`` einsums.  Its plain counterpart is ``ref.decode_attention``; the
model's plain path (``layers.attention_decode``) keeps the CPU, an int8 cache and
a cache split by its sequence.  The library is built by ``nvcc`` at the first
launch (see ``_build``); the wrapper checks its inputs, picks the number of splits
of the valid slots from the call's shape (``splits``), allocates the output and
the splits' fp32 scratch, launches on PyTorch's current stream and counts its
calls in ``decode_attention.launches`` (one a call: the tiles kernel, and the
combine kernel where there are several splits).  It is also the operator
``torch.ops.repro_torch.decode_attention``, whose fake implementation gives the
output's shape, with its work (``work.decode_attention_work``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, work

HEAD_DIMS = (32, 64, 112, 128, 224)
MAX_G = 8
BLOCKS_PER_SM = 2       # the grid holds at least this many blocks for every SM


@functools.cache
def _kernel():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.decode_attention_tile.argtypes = [ctypes.c_int]
    lib.decode_attention_tile.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return fn, functools.cache(lib.decode_attention_tile), lib.decode_attention_error_string


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def splits(pairs: int, n_valid: int, tile: int, sms: int):
    """(number of splits, slots a split) of ``n_valid`` valid slots, for a grid of
    ``pairs`` (batch row, kv head) pairs on ``sms`` SMs: each split a run of whole
    ``tile``-slot tiles, the last one shorter, none empty; the runs as long as
    leaves the grid at least ``BLOCKS_PER_SM`` blocks for every SM, or one tile
    where there are too few tiles for that."""
    tiles = -(-n_valid // tile)
    want = -(-BLOCKS_PER_SM * sms // pairs)
    per = max(tiles // want, 1)
    return -(-tiles // per), per * tile


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_valid: int,
           scale: Optional[float] = None) -> None:
    name = "decode_attention"
    _build.refuse_dtensor(name, q, k, v)
    if scale is not None and not scale > 0:
        raise ValueError(f"the softmax scale must be positive; got {scale}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes a bf16 or fp32 q; got {q.dtype}")
    if k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes a bf16 K/V cache; got {k.dtype}, {v.dtype} (an int8 "
                         "or fp32 cache takes the model's plain path)")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,1,H,hd], k/v [B,Smax,KV,hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on batch or "
                         "head dim")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not compiled; the kernel takes {HEAD_DIMS}")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh or not 1 <= h // kvh <= MAX_G:
        raise ValueError(f"{name} takes H = G * KV query heads with 1 <= G <= {MAX_G}; got "
                         f"H {h}, KV {kvh}")
    if not 1 <= n_valid <= k.shape[1]:
        raise ValueError(f"n_valid {n_valid} outside [1, {k.shape[1]}]")
    if b == 0:
        raise ValueError(f"{name} takes a non-empty batch")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} takes 16-byte-aligned q, k, v (16-byte loads)")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} takes q, k, v on one CUDA device; got {q.device}, "
                         f"{k.device}, {v.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_valid: int, scale: Optional[float] = None) -> torch.Tensor:
    """Softmax(scale q k^T) v of one query token over slots [0, n_valid) of the
    cache, on the card, scores and sums in fp32; ``scale`` None is 1/sqrt(hd).

    q [B,1,H,hd] bf16 or fp32; k/v [B,Smax,KV,hd] bf16; H = G * KV, 1 <= G <= 8;
    hd in ``HEAD_DIMS``; all contiguous and 16-byte aligned.  Returns out
    [B,1,H,hd] in q's dtype; slots at or past n_valid are never read."""
    _check(q, k, v, n_valid, scale)
    b, _, h, hd = q.shape
    smax, kvh = k.shape[1], k.shape[2]
    fn, tile, err_str = _kernel()
    nsplit, per = splits(b * kvh, n_valid, tile(hd), _sm_count(q.device.index))
    out = torch.empty_like(q)
    part = (torch.empty((b, kvh, nsplit, h // kvh, hd + 2), dtype=torch.float32,
                        device=q.device) if nsplit > 1 else None)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(), int(q.dtype == torch.bfloat16), b,
                smax, kvh, h // kvh, hd, n_valid, nsplit, per, scale or 0.0,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention launch failed: cudaError {rc} "
                           f"({err_str(rc).decode()})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


_build.define_op("decode_attention(Tensor q, Tensor k, Tensor v, int n_valid, "
                 "float? scale=None) -> Tensor", decode_attention,
                 lambda q, k, v, n_valid, scale=None: torch.empty_like(q))


def _count(q, k, v, n_valid, scale=None):
    b, _, h, hd = q.shape
    return work.decode_attention_work(b, n_valid, k.shape[2], h // k.shape[2], hd,
                                      q.element_size())


work.register(torch.ops.repro_torch.decode_attention, _count, lambda *_: "fp32")
