"""Hand-written CUDA WKV6 scan for Hopper (``csrc/rwkv6_scan.cu``).

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
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

HEAD_DIMS = (64,)     # K = V, the compiled head size
CHUNKS = (64,)


@functools.cache
def _kernel():
    lib = _build.load("rwkv6_scan")
    fn = lib.wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.wkv6_workspace_floats.argtypes = [ctypes.c_int] * 3
    lib.wkv6_workspace_floats.restype = ctypes.c_longlong
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return fn, lib.wkv6_workspace_floats, lib.wkv6_error_string


def _check(r, k, v, w, u, state, chunk: int) -> None:
    ts = (r, k, v, w, u, state)
    if not (r.is_cuda and all(t.device == r.device for t in ts)):
        raise ValueError("wkv6_fwd takes r, k, v, w, u, state on one CUDA device; got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"wkv6_fwd takes fp32 tensors; got {[t.dtype for t in ts]}")
    if r.dim() != 4:
        raise ValueError(f"expected r [B,T,H,K]; got {tuple(r.shape)}")
    b, t, h, kd = r.shape
    if (k.shape != r.shape or w.shape != r.shape or v.shape != (b, t, h, kd)
            or u.shape != (h, kd) or state.shape != (b, h, kd, kd)):
        raise ValueError(
            f"expected r/k/w/v [B,T,H,K], u [H,K], state [B,H,K,K]; got r {tuple(r.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}, "
            f"u {tuple(u.shape)}, state {tuple(state.shape)}")
    if kd not in HEAD_DIMS:
        raise ValueError(f"head size {kd} not compiled; the kernel takes {HEAD_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} not compiled; the kernel takes {CHUNKS}")
    if not all(x.is_contiguous() for x in ts):
        raise ValueError("wkv6_fwd takes contiguous tensors")
    if any(x.data_ptr() % 16 for x in ts):
        raise ValueError("wkv6_fwd takes 16-byte-aligned tensors (cp.async and float2 loads)")
    if r.numel() == 0:
        raise ValueError("wkv6_fwd takes a non-empty sequence")


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor, chunk: int = 64):
    """Chunked WKV6 recurrence on the card.

    r, k, w [B,T,H,K]; v [B,T,H,V]; u [H,K]; state [B,H,K,V]; fp32,
    contiguous, 16-byte-aligned, K = V in ``HEAD_DIMS``.  Returns
    ``y [B,T,H,V]`` and the final state ``[B,H,K,V]``."""
    _check(r, k, v, w, u, state, chunk)
    b, t, h, kd = r.shape
    y = torch.empty_like(v)
    s_out = torch.empty_like(state)
    fn, workspace_floats, err_str = _kernel()
    work = torch.empty(workspace_floats(b, t, h), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                state.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, t, h, kd, chunk,
                work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: cudaError {rc} ({err_str(rc).decode()})")
    wkv6_fwd.launches += 1
    return y, s_out


wkv6_fwd.launches = 0
