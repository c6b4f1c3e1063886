"""Hand-written CUDA Mamba2 SSD scan for Hopper, forward (``csrc/mamba2_ssd.cu``)
and backward (``csrc/mamba2_ssd_bwd.cu``).

Replaces the TPU kernel ``repro.kernels.mamba2_ssd.ssd_fwd`` and, unlike
it, takes the initial state and returns the final one, as the model's
``ref.mamba2_ssd`` does.  Its products run on the TF32 tensor cores, split
3xTF32 (``csrc/scan_sm90.cuh``).  The library is built by ``nvcc`` at the
first launch (see ``_build``); this wrapper checks its inputs, allocates the
outputs and the workspace (C B^T per batch and chunk), launches on PyTorch's
current stream and counts its launches in ``ssd_fwd.launches``: one a call,
though a call runs two CUDA kernels.  It takes CUDA tensors only: the plain
version is ``ref.mamba2_ssd``.

B and C come in G groups ``[Bt,T,G,N]``, head h reading group h // (H/G)
(``[Bt,T,N]`` is one group, launched as it always was); the backward takes one
group only.

``ssd_bwd`` is the backward (its plain version ``ref.mamba2_ssd_bwd``), which
reads the state at every 64 rows that the forward writes when asked, and
``SSD`` the autograd function that joins the two; ``ssd_bwd.launches``
counts its calls.  Each wrapper is also an operator
(``torch.ops.repro_torch.ssd_fwd``/``ssd_bwd``) whose real implementation is
the wrapper and whose fake one gives the outputs' shapes, with its work
(``work.ssd_work``, ``work.ssd_bwd_work``); ``SSD`` calls the operators.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build, work
from .rwkv6_scan import aligned

SHAPES = ((32, 16), (64, 64))  # (P, N), the compiled head and state sizes: every
                               # config's, full and reduced
GROUPS = (1, 2)                # the compiled groups of B and C
CHUNKS = (128,)
STATE_ROWS = 64       # rows between the chunk states the forward keeps for the backward


@functools.cache
def _kernel():
    lib = _build.load("mamba2_ssd")
    fn = lib.ssd_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.ssd_workspace_floats.argtypes = [ctypes.c_int] * 2
    lib.ssd_workspace_floats.restype = ctypes.c_longlong
    lib.ssd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return fn, lib.ssd_workspace_floats, lib.ssd_error_string


@functools.cache
def _bwd_kernel():
    lib = _build.load("mamba2_ssd_bwd")
    fn = lib.ssd_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    lib.ssd_bwd_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.ssd_bwd_workspace_floats.restype = ctypes.c_longlong
    lib.ssd_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_bwd_error_string.restype = ctypes.c_char_p
    return fn, lib.ssd_bwd_workspace_floats, lib.ssd_bwd_error_string


def _check(x, dt, A, B, C, state, chunk: int, name: str = "ssd_fwd", dy=None,
           ds_out=None) -> None:
    """The forward's inputs, or with ``dy`` the backward's: then ``state`` is the
    forward's chunk states [Bt, ceil(T / STATE_ROWS), H, P, N] and ``ds_out``
    may be None."""
    ts = tuple(a for a in (x, dt, A, B, C, state, dy, ds_out) if a is not None)
    _build.refuse_dtensor(name, *ts)
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError(f"{name} takes x, dt, A, B, C, state on one CUDA device; got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"{name} takes fp32 tensors; got {[t.dtype for t in ts]}")
    if x.dim() != 4 or B.dim() not in (3, 4) or (dy is not None and B.dim() != 3):
        raise ValueError(f"expected x [Bt,T,H,P], B/C [Bt,T,N]"
                         f"{'' if dy is not None else ' or [Bt,T,G,N]'}; got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}")
    bt, t, h, p = x.shape
    n = B.shape[-1]
    bc = (bt, t, n) if B.dim() == 3 else (bt, t, B.shape[2], n)
    if B.dim() == 4 and (B.shape[2] < 1 or h % B.shape[2]):
        raise ValueError(f"{B.shape[2]} groups of B/C do not divide {h} heads")
    if B.dim() == 4 and B.shape[2] not in GROUPS:
        raise ValueError(f"{B.shape[2]} groups of B/C not compiled; the kernel takes {GROUPS}")
    s_shape = (bt, h, p, n) if dy is None else (bt, -(-t // STATE_ROWS), h, p, n)
    if (dt.shape != (bt, t, h) or A.shape != (h,) or B.shape != bc
            or C.shape != B.shape or state.shape != s_shape
            or (dy is not None and dy.shape != x.shape)
            or (ds_out is not None and ds_out.shape != (bt, h, p, n))):
        want = "[Bt,H,P,N]" if dy is None else "chunk states [Bt,n,H,P,N]"
        raise ValueError(
            f"expected x [Bt,T,H,P], dt [Bt,T,H], A [H], B/C {list(bc)}, state {want}, "
            f"dy [Bt,T,H,P], "
            f"ds_out [Bt,H,P,N]; got x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
            f"state {tuple(state.shape)}"
            + ("" if dy is None else f", dy {tuple(dy.shape)}, ds_out "
               f"{None if ds_out is None else tuple(ds_out.shape)}"))
    if (p, n) not in SHAPES:
        raise ValueError(f"(P, N) = {(p, n)} not compiled; the kernel takes {SHAPES}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} not compiled; the kernel takes {CHUNKS}")
    if not all(a.is_contiguous() for a in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    if any(a.data_ptr() % 16 for a in ts):
        raise ValueError(f"{name} takes 16-byte-aligned tensors (cp.async and float2 loads)")
    if x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty sequence")


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, state: torch.Tensor, chunk: int = 128, *,
            chunk_states: bool = False):
    """Chunked Mamba2 SSD scan on the card.

    x [Bt,T,H,P]; dt [Bt,T,H]; A [H]; B, C [Bt,T,N] or [Bt,T,G,N]; state [Bt,H,P,N];
    fp32, contiguous, 16-byte-aligned, (P, N) in ``SHAPES``.  Returns
    ``y [Bt,T,H,P]`` and the final state ``[Bt,H,P,N]``; with
    ``chunk_states`` also the state before every ``STATE_ROWS`` rows
    ``[Bt, ceil(T / STATE_ROWS), H, P, N]``, which ``ssd_bwd`` reads."""
    _check(x, dt, A, B, C, state, chunk)
    bt, t, h, p = x.shape
    y = torch.empty_like(x)
    s_out = torch.empty_like(state)
    states = (torch.empty((bt, -(-t // STATE_ROWS), *state.shape[1:]), dtype=torch.float32,
                          device=x.device) if chunk_states else None)
    groups = B.shape[2] if B.dim() == 4 else 1
    fn, workspace_floats, err_str = _kernel()
    work = torch.empty(workspace_floats(bt * groups, t), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                state.data_ptr(), y.data_ptr(), s_out.data_ptr(),
                0 if states is None else states.data_ptr(), bt, t, h, p,
                B.shape[-1], chunk, groups, work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_fwd launch failed: cudaError {rc} ({err_str(rc).decode()})")
    ssd_fwd.launches += 1
    return (y, s_out, states) if chunk_states else (y, s_out)


ssd_fwd.launches = 0


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
            ds_out: Optional[torch.Tensor] = None, chunk: int = 128):
    """Gradients of the chunked Mamba2 SSD scan on the card.

    x, dt, A, B, C and chunk as ``ssd_fwd`` took them, B and C one group
    ``[Bt,T,N]``; ``states`` the chunk
    states it returned with ``chunk_states=True`` (their first is the initial
    state); ``dy [Bt,T,H,P]`` the cotangent of y and ``ds_out [Bt,H,P,N]`` that
    of the final state (``None``: zero, not read).  All fp32, contiguous,
    16-byte-aligned.  Returns ``dx, ddt, dA, dB, dC, ds0``: dA summed over
    batch and time, dB and dC over the heads."""
    _check(x, dt, A, B, C, states, chunk, "ssd_bwd", dy, ds_out)
    bt, t, h, p = x.shape
    n = B.shape[-1]
    dx, ddt, dA, dB, dC = (torch.empty_like(a) for a in (x, dt, A, B, C))
    ds0 = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    fn, workspace_floats, err_str = _bwd_kernel()
    work = torch.empty(workspace_floats(bt, t, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                states.data_ptr(), dy.data_ptr(), 0 if ds_out is None else ds_out.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                ds0.data_ptr(), bt, t, h, p, n, chunk, work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_bwd launch failed: cudaError {rc} ({err_str(rc).decode()})")
    ssd_bwd.launches += 1
    return dx, ddt, dA, dB, dC, ds0


ssd_bwd.launches = 0


def _fwd_op(x, dt, A, B, C, state, chunk, chunk_states):
    return list(ssd_fwd(x, dt, A, B, C, state, chunk, chunk_states=chunk_states))


def _fwd_fake(x, dt, A, B, C, state, chunk, chunk_states):
    bt, t = x.shape[:2]
    states = ([x.new_empty((bt, -(-t // STATE_ROWS), *state.shape[1:]))]
              if chunk_states else [])
    return [torch.empty_like(x), torch.empty_like(state), *states]


def _bwd_fake(x, dt, A, B, C, states, dy, ds_out, chunk):
    bt, _, h, p = x.shape
    return (*(torch.empty_like(a) for a in (x, dt, A, B, C)),
            x.new_empty((bt, h, p, B.shape[-1])))


_build.define_op("ssd_fwd(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor state, "
                 "int chunk, bool chunk_states) -> Tensor[]", _fwd_op, _fwd_fake)
_build.define_op("ssd_bwd(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, Tensor states, "
                 "Tensor dy, Tensor? ds_out, int chunk) -> (Tensor, Tensor, Tensor, Tensor, "
                 "Tensor, Tensor)", ssd_bwd, _bwd_fake)


def _fwd_count(x, dt, A, B, C, state, chunk, chunk_states):
    groups = B.shape[2] if B.dim() == 4 else 1
    flops, _, nbytes = work.ssd_work(*x.shape, B.shape[-1], chunk, groups)
    return flops, nbytes


def _bwd_count(x, dt, A, B, C, states, dy, ds_out, chunk):
    flops, _, nbytes = work.ssd_bwd_work(*x.shape, B.shape[-1], chunk)
    return flops, nbytes


work.register(torch.ops.repro_torch.ssd_fwd, _fwd_count, lambda *_: "tf32")
work.register(torch.ops.repro_torch.ssd_bwd, _bwd_count, lambda *_: "tf32")


class SSD(torch.autograd.Function):
    """The chunked Mamba2 SSD scan on the card, differentiable: the forward is
    ``ssd_fwd`` (keeping its chunk states when a gradient is wanted), the
    backward ``ssd_bwd``, each through its operator.  The gradient of the final state may be absent (a
    loss never reads it); it is then not materialised.  B and C in more than one group
    have a forward only: a gradient asked of such a call raises."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, state, chunk: int = 128):
        _build.refuse_dtensor("ssd_fwd", x, dt, A, B, C, state)
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        if not any(ctx.needs_input_grad):
            return tuple(torch.ops.repro_torch.ssd_fwd(x, dt, A, B, C, state, chunk, False))
        if B.dim() == 4 and B.shape[2] > 1:
            raise NotImplementedError("ssd_bwd takes one group of B/C; the SSD scan with "
                                      f"{B.shape[2]} groups has a forward only")
        y, s_out, states = torch.ops.repro_torch.ssd_fwd(x, dt, A, B, C, state, chunk, True)
        ctx.save_for_backward(x, dt, A, B, C, states)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds_out):
        x, dt, A, B, C, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else aligned(dy)
        grads = torch.ops.repro_torch.ssd_bwd(x, dt, A, B, C, states, dy,
                                              None if ds_out is None else aligned(ds_out),
                                              ctx.chunk)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)
