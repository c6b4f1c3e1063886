"""Hand-written CUDA Mamba2 SSD scan for Hopper (``csrc/mamba2_ssd.cu``).

Replaces the TPU kernel ``repro.kernels.mamba2_ssd.ssd_fwd`` and, unlike
it, takes the initial state and returns the final one, as the model's
``ref.mamba2_ssd`` does.  Its products run on the TF32 tensor cores, split
3xTF32 (``csrc/scan_sm90.cuh``).  The library is built by ``nvcc`` at the
first launch (see ``_build``); this wrapper checks its inputs, allocates the
outputs and the workspace (C B^T per batch and chunk), launches on PyTorch's
current stream and counts its launches in ``ssd_fwd.launches``: one a call,
though a call runs two CUDA kernels.  It takes CUDA tensors only: the plain
version is ``ref.mamba2_ssd``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

SHAPES = ((64, 64),)  # (P, N), the compiled head and state sizes
CHUNKS = (128,)


@functools.cache
def _kernel():
    lib = _build.load("mamba2_ssd")
    fn = lib.ssd_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.ssd_workspace_floats.argtypes = [ctypes.c_int] * 2
    lib.ssd_workspace_floats.restype = ctypes.c_longlong
    lib.ssd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return fn, lib.ssd_workspace_floats, lib.ssd_error_string


def _check(x, dt, A, B, C, state, chunk: int) -> None:
    ts = (x, dt, A, B, C, state)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError("ssd_fwd takes x, dt, A, B, C, state on one CUDA device; got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"ssd_fwd takes fp32 tensors; got {[t.dtype for t in ts]}")
    if x.dim() != 4 or B.dim() != 3:
        raise ValueError(f"expected x [Bt,T,H,P], B/C [Bt,T,N]; got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}")
    bt, t, h, p = x.shape
    n = B.shape[-1]
    if (dt.shape != (bt, t, h) or A.shape != (h,) or B.shape != (bt, t, n)
            or C.shape != B.shape or state.shape != (bt, h, p, n)):
        raise ValueError(
            f"expected x [Bt,T,H,P], dt [Bt,T,H], A [H], B/C [Bt,T,N], state [Bt,H,P,N]; "
            f"got x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(B.shape)}, C {tuple(C.shape)}, state {tuple(state.shape)}")
    if (p, n) not in SHAPES:
        raise ValueError(f"(P, N) = {(p, n)} not compiled; the kernel takes {SHAPES}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} not compiled; the kernel takes {CHUNKS}")
    if not all(a.is_contiguous() for a in ts):
        raise ValueError("ssd_fwd takes contiguous tensors")
    if any(a.data_ptr() % 16 for a in ts):
        raise ValueError("ssd_fwd takes 16-byte-aligned tensors (cp.async and float2 loads)")
    if x.numel() == 0:
        raise ValueError("ssd_fwd takes a non-empty sequence")


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, state: torch.Tensor, chunk: int = 128):
    """Chunked Mamba2 SSD scan on the card.

    x [Bt,T,H,P]; dt [Bt,T,H]; A [H]; B, C [Bt,T,N]; state [Bt,H,P,N];
    fp32, contiguous, 16-byte-aligned, (P, N) in ``SHAPES``.  Returns
    ``y [Bt,T,H,P]`` and the final state ``[Bt,H,P,N]``."""
    _check(x, dt, A, B, C, state, chunk)
    bt, t, h, p = x.shape
    y = torch.empty_like(x)
    s_out = torch.empty_like(state)
    fn, workspace_floats, err_str = _kernel()
    work = torch.empty(workspace_floats(bt, t), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                state.data_ptr(), y.data_ptr(), s_out.data_ptr(), bt, t, h, p,
                B.shape[-1], chunk, work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_fwd launch failed: cudaError {rc} ({err_str(rc).decode()})")
    ssd_fwd.launches += 1
    return y, s_out


ssd_fwd.launches = 0
