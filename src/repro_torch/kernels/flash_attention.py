"""Hand-written CUDA flash-attention forward for Hopper (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention_fwd``.
The library is built by ``nvcc`` at the first launch (see ``_build``); this
wrapper checks its inputs, allocates the outputs, launches on PyTorch's
current stream and counts its launches in ``flash_attention_fwd.launches``.
It takes CUDA tensors only: the plain version is ``ref._flash_fwd_impl``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIMS = (32, 64, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _kernel():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           q_offset: int) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_fwd takes q, k, v on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd takes fp32 or bf16 q/k/v of one dtype; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,Tq,KV,G,hd], k/v [B,Tk,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, kvh, _, hd = q.shape
    if k.shape[0] != b or k.shape[2] != kvh or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on "
                         "batch, kv heads or head dim")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not compiled; the kernel takes {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd takes contiguous q, k, v")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention_fwd takes non-empty q and k/v")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window ({window}) and q_offset ({q_offset}) must be >= 0")
    if max(q.shape[1], k.shape[1]) + q_offset >= 2 ** 31:
        raise ValueError("sequence positions must fit in int32")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0, q_offset: int = 0):
    """Causal GQA attention forward on the card.

    q [B,Tq,KV,G,hd]; k/v [B,Tk,KV,hd]; fp32 or bf16, contiguous, hd in
    ``HEAD_DIMS``.  Returns ``out`` (like q) and ``lse [B,KV,G,Tq]`` (fp32)."""
    _check(q, k, v, window, q_offset)
    b, tq, kvh, g, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, kvh, g, tq), dtype=torch.float32, device=q.device)
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), int(q.dtype == torch.bfloat16), b, tq,
                k.shape[1], kvh, g, hd, q_offset, window,
                *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {rc} "
                           f"({err_str(rc).decode()})")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
