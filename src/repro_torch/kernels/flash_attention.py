"""Hand-written CUDA flash attention for Hopper, forward and backward.

``flash_attention_fwd`` (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro.kernels.flash_attention.flash_attention_fwd``; ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``) replaces the reference's recompute
backward ``repro.kernels.ref._flash_bwd_impl``, which has no Pallas kernel.
Both take bf16 on the tensor cores (the forward by wgmma with TMA loads, the
backward by mma.sync) and fp32 on the CUDA cores (SIMT kernels, which the
fp32 consistency checks need: TF32 would not meet their tolerances); the
split is made by dtype inside each library.  Each library is built by ``nvcc`` at its first launch (see ``_build``); each
wrapper checks its inputs, allocates the outputs, launches on PyTorch's
current stream and counts its launches in ``<wrapper>.launches``.  They take
CUDA tensors only: the plain versions are ``ref._flash_fwd_impl`` and
``ref._flash_bwd_impl``.  Each wrapper is also an operator
(``torch.ops.repro_torch.flash_attention_fwd``/``_bwd``) whose real
implementation is the wrapper and whose fake one gives the outputs' shapes,
so that fake tensors pass through it and a launch is counted only where a
kernel runs; its work (``work.flash_fwd_work``, ``work.flash_bwd_work``)
is registered with it.  ``FlashAttention`` joins the two operators as an
autograd function, the counterpart of the reference's custom VJP on the card
(``ref.flash_attention`` is the one of the plain versions).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, work

HEAD_DIMS = (32, 64, 112, 128, 224)    # the forward's; 224 is Zamba2-7B's shared block
BWD_HEAD_DIMS = (32, 64, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _fwd_kernel():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float]
                   + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_error_string


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
           q_offset: int, name: str = "flash_attention_fwd", head_dims=HEAD_DIMS) -> None:
    _build.refuse_dtensor(name, q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name} takes q, k, v on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes fp32 or bf16 q/k/v of one dtype; "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 5 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q [B,Tq,KV,G,hd], k/v [B,Tk,KV,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, kvh, _, hd = q.shape
    if k.shape[0] != b or k.shape[2] != kvh or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree on "
                         "batch, kv heads or head dim")
    if hd not in head_dims:
        raise ValueError(f"head dim {hd} not compiled; {name} takes {head_dims}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} takes contiguous q, k, v")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} takes 16-byte-aligned bf16 q, k, v (TMA and cp.async)")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"{name} takes non-empty q and k/v")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window ({window}) and q_offset ({q_offset}) must be >= 0")
    if max(q.shape[1], k.shape[1]) + q_offset >= 2 ** 31:
        raise ValueError("sequence positions must fit in int32")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0, q_offset: int = 0, scale: Optional[float] = None):
    """Causal GQA attention forward on the card.

    q [B,Tq,KV,G,hd]; k/v [B,Tk,KV,hd]; fp32 or bf16, contiguous, hd in
    ``HEAD_DIMS``; ``scale`` the softmax scale (None: 1/sqrt(hd)).  Returns
    ``out`` (like q) and ``lse [B,KV,G,Tq]`` (fp32), the log-sum-exp of the
    scaled scores."""
    _check(q, k, v, window, q_offset)
    if scale is not None and not scale > 0:
        raise ValueError(f"the softmax scale must be positive; got {scale}")
    b, tq, kvh, g, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, kvh, g, tq), dtype=torch.float32, device=q.device)
    fn, err_str = _fwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), int(q.dtype == torch.bfloat16), b, tq,
                k.shape[1], kvh, g, hd, q_offset, window, scale or 0.0,
                *q.stride()[:4], *k.stride()[:3], *v.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {rc} "
                           f"({err_str(rc).decode()})")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


@functools.cache
def _bwd_kernel():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                   + [ctypes.c_longlong] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return fn, lib.flash_attention_bwd_error_string


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        window: int = 0, q_offset: int = 0):
    """Gradients of causal GQA attention on the card, recomputed from lse.

    q, k, v, window, q_offset as ``flash_attention_fwd`` takes them; ``out``
    and ``lse`` as it returned them; ``do`` the gradient of ``out`` (q's
    shape and dtype, contiguous).  Returns ``dq, dk, dv`` in the inputs'
    dtypes."""
    name = "flash_attention_bwd"
    _check(q, k, v, window, q_offset, name, BWD_HEAD_DIMS)
    _build.refuse_dtensor(name, out, lse, do)
    b, tq, kvh, g, hd = q.shape
    for t, what in ((out, "out"), (do, "do")):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {what} must have q's shape, dtype and device; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes a contiguous {what}")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} takes a 16-byte-aligned bf16 {what}")
    if (lse.shape != (b, kvh, g, tq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be a contiguous fp32 [B,KV,G,Tq] = "
                         f"{(b, kvh, g, tq)} on q's device; got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    fn, err_str = _bwd_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), int(q.dtype == torch.bfloat16), b, tq, k.shape[1], kvh,
                g, hd, q_offset, window, *q.stride()[:4], *k.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc} ({err_str(rc).decode()})")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def _fwd_fake(q, k, v, window, q_offset, scale=None):
    b, tq, kvh, g, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, kvh, g, tq), dtype=torch.float32)


def _bwd_fake(q, k, v, out, lse, do, window, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_build.define_op("flash_attention_fwd(Tensor q, Tensor k, Tensor v, int window, "
                 "int q_offset, float? scale=None) -> (Tensor, Tensor)", flash_attention_fwd,
                 _fwd_fake)
_build.define_op("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
                 "Tensor do, int window, int q_offset) -> (Tensor, Tensor, Tensor)",
                 flash_attention_bwd, _bwd_fake)


def _peak(q, *_):
    return "bf16" if q.dtype == torch.bfloat16 else "fp32"     # fp32: the SIMT kernels


def _fwd_count(q, k, v, window, q_offset, scale=None):
    b, tq, kvh, g, hd = q.shape
    return work.flash_fwd_work(b, tq, k.shape[1], kvh, g, hd, window, q_offset,
                               q.element_size())


def _bwd_count(q, k, v, out, lse, do, window, q_offset):
    b, tq, kvh, g, hd = q.shape
    return work.flash_bwd_work(b, tq, k.shape[1], kvh, g, hd, window, q_offset,
                               q.element_size())


work.register(torch.ops.repro_torch.flash_attention_fwd, _fwd_count, _peak)
work.register(torch.ops.repro_torch.flash_attention_bwd, _bwd_count, _peak)


class FlashAttention(torch.autograd.Function):
    """Causal GQA attention on the card with a flash backward: the forward
    is ``flash_attention_fwd``, the backward ``flash_attention_bwd`` (each
    through its operator), the counterpart of the reference's custom VJP
    (``repro.kernels.ref._flash``).  The forward saves q, k, v, out and lse;
    the backward recomputes the rest.  The backward kernel computes at the
    default scale only: a forward given another one refuses its backward."""

    @staticmethod
    def forward(ctx, q, k, v, window: int = 0, q_offset: int = 0,
                scale: Optional[float] = None):
        _build.refuse_dtensor("flash_attention_fwd", q, k, v)
        out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, window, q_offset, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.q_offset, ctx.scale = window, q_offset, scale
        return out

    @staticmethod
    def backward(ctx, do):
        if ctx.scale is not None:
            raise NotImplementedError("flash_attention_bwd computes at the default softmax "
                                      "scale 1/sqrt(hd) only")
        q, k, v, out, lse = ctx.saved_tensors
        grads = torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                                          ctx.window, ctx.q_offset)
        return (*grads, None, None, None)
