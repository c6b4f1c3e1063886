"""Public entry points for the port's kernels.

Dispatch by where the tensors lie: a CUDA tensor launches the hand-written
kernel (which raises on what it does not take) through its operator
(``torch.ops.repro_torch.*``, which fake tensors pass through without a
launch), a CPU tensor takes the plain PyTorch version in ``ref``.  There
is no fallback from the one to the other.  Inside ``kernel_path()`` every
tensor takes the card's path: the dry run lowers a step so on fake CPU
tensors, which stand for the card's.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from . import _build, ref
from . import checksum as _checksum  # noqa: F401  (registers the operator)
from . import decode_attention as _decode_attention  # noqa: F401  (registers the operator)
from . import mamba2_step as _mamba2_step  # noqa: F401  (registers the operator)
from .flash_attention import FlashAttention
from .mamba2_ssd import SSD
from .rwkv6_scan import WKV6

_card_path = False


@contextlib.contextmanager
def kernel_path():
    """For the block, every call takes the card's path whatever its tensors'
    device: the kernels' autograd functions and operators.  On fake tensors
    the operators' fake implementations give the outputs and nothing
    launches; a real CPU tensor is refused by the kernel's wrapper."""
    global _card_path
    saved, _card_path = _card_path, True
    try:
        yield
    finally:
        _card_path = saved


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, differentiable: its
    backward is the flash backward kernel on the card, the plain recompute
    backward on the CPU.  q [B,Tq,KV,G,hd]; k/v [B,Tk,KV,hd] -> [B,Tq,KV,G,hd];
    ``scale`` the softmax scale (None: 1/sqrt(hd); the card's backward takes None only)."""
    if q.is_cuda or _card_path:
        return FlashAttention.apply(q, k, v, window, q_offset, scale)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, q_offset=q_offset, window=window, scale=scale)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor, chunk: int = 64):
    """Chunked RWKV6 WKV recurrence with a state in and out, differentiable: its
    backward is the WKV6 backward kernel on the card, autograd through the
    plain form on the CPU.
    r,k,w [B,T,H,K]; v [B,T,H,V]; u [H,K]; state [B,H,K,V] -> (y, state)."""
    if r.is_cuda or _card_path:
        return WKV6.apply(r, k, v, w, u, state, chunk)
    if r.device.type == "cpu":
        return ref.rwkv6_chunked(r, k, v, w, u, state, chunk)
    raise ValueError(f"wkv6: no kernel for device {r.device}")


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, state: torch.Tensor, chunk: int = 128):
    """Chunked Mamba2 SSD scan with a state in and out, differentiable: its
    backward is the SSD backward kernel on the card, autograd through the plain
    form on the CPU.
    x [Bt,T,H,P]; dt [Bt,T,H]; A [H]; B,C [Bt,T,N] or, in G groups, [Bt,T,G,N]
    (forward only on the card); state [Bt,H,P,N] -> (y, state)."""
    if x.is_cuda or _card_path:
        return SSD.apply(x, dt, A, B, C, state, chunk)
    if x.device.type == "cpu":
        return ref.mamba2_ssd(x, dt, A, B, C, state, chunk)
    raise ValueError(f"mamba2_ssd: no kernel for device {x.device}")


def takes_decode_attention(q: torch.Tensor, cache: torch.Tensor) -> bool:
    """Whether one-token decode attention of ``q`` over ``cache`` runs the decode
    kernel (``decode_attention``): the rule above sends ``q`` to the card and the
    cache is bf16.  An int8 or fp32 cache, and every CPU call, take the model's
    plain path (``models.layers.attention_decode``)."""
    return (q.is_cuda or _card_path) and cache.dtype == torch.bfloat16


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_valid: int, scale: Optional[float] = None) -> torch.Tensor:
    """One query token's GQA attention over slots [0, n_valid) of a K/V cache, softmax
    scale ``scale`` (None: 1/sqrt(hd)): the decode kernel through its operator where
    the rule above sends ``q`` to the card (it takes a bf16 cache only), the plain
    ``ref.decode_attention`` on the CPU.  q [B,1,H,hd]; k/v [B,Smax,KV,hd] ->
    [B,1,H,hd] in q's dtype."""
    _build.refuse_dtensor("decode_attention", q, k, v)
    if q.is_cuda or _card_path:
        return torch.ops.repro_torch.decode_attention(q, k, v, n_valid, scale)
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, n_valid, scale)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")


def mamba2_step(u: torch.Tensor, conv_state: torch.Tensor, conv_w: torch.Tensor,
                conv_b: torch.Tensor, dt_bias: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                state: torch.Tensor, norm_w: torch.Tensor, groups: int,
                eps: float) -> torch.Tensor:
    """One token of a Mamba2 layer after its in_proj (``ref.mamba2_step``'s function):
    the fused decode kernel through its operator where the rule above sends ``u`` to
    the card (it takes bf16 and the (P, N) it compiles only), the plain version on the
    CPU.  ``conv_state`` and ``state`` are updated in place; returns y [B, H*P] in u's
    dtype."""
    _build.refuse_dtensor("mamba2_step", u, conv_state, state)
    if u.is_cuda or _card_path:
        return torch.ops.repro_torch.mamba2_step(u, conv_state, conv_w, conv_b, dt_bias, A, D,
                                                 state, norm_w, groups, eps)
    if u.device.type == "cpu":
        return ref.mamba2_step(u, conv_state, conv_w, conv_b, dt_bias, A, D, state, norm_w,
                               groups, eps)
    raise ValueError(f"mamba2_step: no kernel for device {u.device}")


def tensor_checksum(data: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Integrity digest of a 1-D int32/uint32 tensor of 32-bit words:
    int64 [2] = (sum (i+1) x_i, sum x_i) mod 2^32, for any ``block``."""
    if data.is_cuda or _card_path:
        _build.refuse_dtensor("checksum", data)
        return torch.ops.repro_torch.checksum(data, block)
    if data.device.type == "cpu":
        return ref.checksum(data, block=block)
    raise ValueError(f"tensor_checksum: no kernel for device {data.device}")
