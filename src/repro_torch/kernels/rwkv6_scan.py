"""Hand-written CUDA WKV6 scan for Hopper, forward (``csrc/rwkv6_scan.cu``)
and backward (``csrc/rwkv6_scan_bwd.cu``).

Replaces the TPU kernel ``repro.kernels.rwkv6_scan.wkv6_fwd`` and, unlike
it, takes the initial state and returns the final one, as the model's
``ref.rwkv6_chunked`` does.  Its products run on the TF32 tensor cores,
split 3xTF32 (``csrc/scan_sm90.cuh``).  The library is built by ``nvcc`` at
the first launch (see ``_build``); this wrapper checks its inputs, allocates
the outputs and the workspace (the state at every chunk's start, written by
the state pass and read by the output pass), launches on PyTorch's current
stream and counts its launches in ``wkv6_fwd.launches``: one a call, though
a call runs two CUDA kernels.  It takes CUDA tensors only: the plain version
is ``ref.rwkv6_chunked``.

``wkv6_bwd`` is the backward (its plain version ``ref.rwkv6_chunked_bwd``),
which reads the forward's chunk states, and ``WKV6`` the autograd function
that joins the two; ``wkv6_bwd.launches`` counts its calls.  Each wrapper is
also an operator (``torch.ops.repro_torch.wkv6_fwd``/``wkv6_bwd``) whose
real implementation is the wrapper and whose fake one gives the outputs'
shapes, with its work (``work.wkv6_work``, ``work.wkv6_bwd_work``); ``WKV6``
calls the operators.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from . import _build, work

HEAD_DIMS = (32, 64)  # K = V, the compiled head sizes: every config's, full and reduced
CHUNKS = (64,)


@functools.cache
def _kernel():
    lib = _build.load("rwkv6_scan")
    fn = lib.wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.wkv6_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.wkv6_workspace_floats.restype = ctypes.c_longlong
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return fn, lib.wkv6_workspace_floats, lib.wkv6_error_string


@functools.cache
def _bwd_kernel():
    lib = _build.load("rwkv6_scan_bwd")
    fn = lib.wkv6_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.wkv6_bwd_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.wkv6_bwd_workspace_floats.restype = ctypes.c_longlong
    lib.wkv6_bwd_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_bwd_error_string.restype = ctypes.c_char_p
    return fn, lib.wkv6_bwd_workspace_floats, lib.wkv6_bwd_error_string


def _check(r, k, v, w, u, state, chunk: int, name: str = "wkv6_fwd", dy=None,
           ds_out=None) -> None:
    """The forward's inputs, or with ``dy`` the backward's: then ``state`` is the
    forward's chunk states [B, n_chunks, H, K, V] and ``ds_out`` may be None."""
    ts = tuple(x for x in (r, k, v, w, u, state, dy, ds_out) if x is not None)
    _build.refuse_dtensor(name, *ts)
    if not (r.is_cuda and all(t.device == r.device for t in ts)):
        raise ValueError(f"{name} takes r, k, v, w, u, state on one CUDA device; got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"{name} takes fp32 tensors; got {[t.dtype for t in ts]}")
    if r.dim() != 4:
        raise ValueError(f"expected r [B,T,H,K]; got {tuple(r.shape)}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} not compiled; the kernel takes {CHUNKS}")
    b, t, h, kd = r.shape
    s_shape = (b, h, kd, kd) if dy is None else (b, -(-t // chunk), h, kd, kd)
    if (k.shape != r.shape or w.shape != r.shape or v.shape != (b, t, h, kd)
            or u.shape != (h, kd) or state.shape != s_shape
            or (dy is not None and dy.shape != v.shape)
            or (ds_out is not None and ds_out.shape != (b, h, kd, kd))):
        want = "[B,H,K,K]" if dy is None else "chunk states [B,n_chunks,H,K,K]"
        raise ValueError(
            f"expected r/k/w/v [B,T,H,K], u [H,K], state {want}, dy [B,T,H,K], "
            f"ds_out [B,H,K,K]; got "
            f"r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}, "
            f"u {tuple(u.shape)}, state {tuple(state.shape)}"
            + ("" if dy is None else f", dy {tuple(dy.shape)}, ds_out "
               f"{None if ds_out is None else tuple(ds_out.shape)}"))
    if kd not in HEAD_DIMS:
        raise ValueError(f"head size {kd} not compiled; the kernel takes {HEAD_DIMS}")
    if not all(x.is_contiguous() for x in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in ts):
        raise ValueError(f"{name} takes 16-byte-aligned tensors (cp.async and float2 loads)")
    if r.numel() == 0:
        raise ValueError(f"{name} takes a non-empty sequence")


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor, chunk: int = 64, *,
             chunk_states: bool = False):
    """Chunked WKV6 recurrence on the card.

    r, k, w [B,T,H,K]; v [B,T,H,V]; u [H,K]; state [B,H,K,V]; fp32,
    contiguous, 16-byte-aligned, K = V in ``HEAD_DIMS``.  Returns
    ``y [B,T,H,V]`` and the final state ``[B,H,K,V]``; with ``chunk_states``
    also the state at every chunk's start ``[B, n_chunks, H, K, V]``, which
    ``wkv6_bwd`` reads."""
    _check(r, k, v, w, u, state, chunk)
    b, t, h, kd = r.shape
    y = torch.empty_like(v)
    s_out = torch.empty_like(state)
    fn, workspace_floats, err_str = _kernel()
    work = torch.empty(workspace_floats(b, t, h, kd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                state.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, t, h, kd, chunk,
                work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: cudaError {rc} ({err_str(rc).decode()})")
    wkv6_fwd.launches += 1
    return (y, s_out, work.view(b, -1, h, kd, kd)) if chunk_states else (y, s_out)


wkv6_fwd.launches = 0


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
             ds_out: Optional[torch.Tensor] = None, chunk: int = 64):
    """Gradients of the chunked WKV6 recurrence on the card.

    r, k, v, w, u and chunk as ``wkv6_fwd`` took them; ``states`` the chunk
    states it returned with ``chunk_states=True`` (their first is the initial
    state); ``dy [B,T,H,V]`` the cotangent of y and ``ds_out [B,H,K,V]`` that
    of the final state (``None``: zero, not read).  All fp32, contiguous,
    16-byte-aligned.  Returns ``dr, dk, dv, dw, du, ds0``; dw is 0 where
    w < 1e-30, the forward's clamp."""
    _check(r, k, v, w, u, states, chunk, "wkv6_bwd", dy, ds_out)
    b, t, h, kd = r.shape
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du = torch.empty_like(u)
    ds0 = torch.empty((b, h, kd, kd), dtype=torch.float32, device=r.device)
    fn, workspace_floats, err_str = _bwd_kernel()
    work = torch.empty(workspace_floats(b, t, h, kd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                states.data_ptr(), dy.data_ptr(), 0 if ds_out is None else ds_out.data_ptr(),
                dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
                ds0.data_ptr(), b, t, h, kd, chunk, work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_bwd launch failed: cudaError {rc} ({err_str(rc).decode()})")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


wkv6_bwd.launches = 0


def aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself if it is contiguous and 16-byte-aligned, else an aligned copy (an
    incoming gradient may be a strided view).  A fake tensor has no address: its
    storage offset stands for it (the allocator aligns every storage)."""
    offset = x.storage_offset() * x.element_size() if is_fake(x) else x.data_ptr()
    if x.is_contiguous() and offset % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _fwd_op(r, k, v, w, u, state, chunk, chunk_states):
    return list(wkv6_fwd(r, k, v, w, u, state, chunk, chunk_states=chunk_states))


def _fwd_fake(r, k, v, w, u, state, chunk, chunk_states):
    b, t, h, kd = r.shape
    states = [r.new_empty((b, -(-t // chunk), h, kd, kd))] if chunk_states else []
    return [torch.empty_like(v), torch.empty_like(state), *states]


def _bwd_fake(r, k, v, w, u, states, dy, ds_out, chunk):
    b, _, h, kd = r.shape
    return (*(torch.empty_like(x) for x in (r, k, v, w, u)),
            r.new_empty((b, h, kd, kd)))


_build.define_op("wkv6_fwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor state, "
                 "int chunk, bool chunk_states) -> Tensor[]", _fwd_op, _fwd_fake)
_build.define_op("wkv6_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor states, "
                 "Tensor dy, Tensor? ds_out, int chunk) -> (Tensor, Tensor, Tensor, Tensor, "
                 "Tensor, Tensor)", wkv6_bwd, _bwd_fake)


def _fwd_count(r, k, v, w, u, state, chunk, chunk_states):
    flops, _, nbytes = work.wkv6_work(*r.shape, chunk)
    return flops, nbytes


def _bwd_count(r, k, v, w, u, states, dy, ds_out, chunk):
    flops, _, nbytes = work.wkv6_bwd_work(*r.shape, chunk)
    return flops, nbytes


work.register(torch.ops.repro_torch.wkv6_fwd, _fwd_count, lambda *_: "tf32")
work.register(torch.ops.repro_torch.wkv6_bwd, _bwd_count, lambda *_: "tf32")


class WKV6(torch.autograd.Function):
    """The chunked WKV6 recurrence on the card, differentiable: the forward is
    ``wkv6_fwd`` (saving its chunk states), the backward ``wkv6_bwd``, each
    through its operator.  The
    gradient of the final state may be absent (a loss never reads it); it is
    then not materialised."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, chunk: int = 64):
        _build.refuse_dtensor("wkv6_fwd", r, k, v, w, u, state)
        y, s_out, states = torch.ops.repro_torch.wkv6_fwd(r, k, v, w, u, state, chunk, True)
        ctx.save_for_backward(r, k, v, w, u, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds_out):
        r, k, v, w, u, states = ctx.saved_tensors
        dy = torch.zeros_like(v) if dy is None else aligned(dy)
        grads = torch.ops.repro_torch.wkv6_bwd(r, k, v, w, u, states, dy,
                                               None if ds_out is None else aligned(ds_out),
                                               ctx.chunk)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)
