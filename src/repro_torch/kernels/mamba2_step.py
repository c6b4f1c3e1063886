"""Hand-written CUDA Mamba2 decode step for Hopper (``csrc/mamba2_step.cu``).

One token of a Mamba2 layer from its in_proj's output to its out_proj's input,
fused into one launch: the causal conv's update, SiLU, dt's softplus, the SSD
state's update, ``y = s C + D x`` and the gated group norm, with B and C in G
groups.  It replaces no TPU kernel (the JAX package's decode step is the per-step
recurrence ``ref.mamba2_naive`` in jnp); its plain version is ``ref.mamba2_step``,
which the published Zamba2 block's decode runs on the CPU.  The library
is built by ``nvcc`` at the first launch (see ``_build``); the wrapper checks its
inputs, allocates the output and the group norm's scratch, launches on PyTorch's
current stream and counts its calls in ``mamba2_step.launches``.  It is also the
operator ``torch.ops.repro_torch.mamba2_step``, whose fake implementation gives the
output's shape, with its work (``work.mamba2_step_work``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from . import _build, work

SHAPES = ((32, 16), (64, 64))     # (P, N): the published block's and its reduced form's
CONV_K = 4

_tickets: Dict[Tuple[int, int], torch.Tensor] = {}   # (device, B * G) -> zeros the kernel leaves 0


@functools.cache
def _kernel():
    lib = _build.load("mamba2_step")
    fn = lib.mamba2_step
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mamba2_step_error_string.argtypes = [ctypes.c_int]
    lib.mamba2_step_error_string.restype = ctypes.c_char_p
    return fn, lib.mamba2_step_error_string


def _check(u, conv_state, conv_w, conv_b, dt_bias, A, D, state, norm_w, groups) -> None:
    name = "mamba2_step"
    ts = (u, conv_state, conv_w, conv_b, dt_bias, A, D, state, norm_w)
    _build.refuse_dtensor(name, *ts)
    if not (u.is_cuda and all(t.device == u.device for t in ts)):
        raise ValueError(f"{name} takes its tensors on one CUDA device; got "
                         f"{sorted({str(t.device) for t in ts})}")
    if any(t.dtype != torch.bfloat16 for t in (u, conv_state, conv_w, conv_b, norm_w)) or \
            any(t.dtype != torch.float32 for t in (dt_bias, A, D, state)):
        raise ValueError(f"{name} takes bf16 u, conv state, conv weights and norm weight and "
                         f"fp32 dt_bias, A, D and state; got {[t.dtype for t in ts]}")
    if state.dim() != 4 or u.dim() != 2:
        raise ValueError(f"expected u [B,W] and state [B,H,P,N]; got {tuple(u.shape)}, "
                         f"{tuple(state.shape)}")
    b, h, p, n = state.shape
    din = h * p
    c = din + 2 * groups * n
    want = {"u": (b, din + c + h), "conv_state": (b, c, CONV_K - 1), "conv_w": (CONV_K, c),
            "conv_b": (c,), "dt_bias": (h,), "A": (h,), "D": (h,), "norm_w": (din,)}
    got = dict(zip(want, (u, conv_state, conv_w, conv_b, dt_bias, A, D, norm_w)))
    bad = {k: tuple(t.shape) for k, t in got.items() if tuple(t.shape) != want[k]}
    if groups < 1 or h % groups or din % (4 * groups) or bad:
        raise ValueError(f"{name}: with state {tuple(state.shape)} and {groups} groups "
                         f"expected {want}; got {bad or 'groups not dividing the heads'}")
    if (p, n) not in SHAPES:
        raise ValueError(f"(P, N) = {(p, n)} not compiled; {name} takes {SHAPES}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} takes contiguous tensors")
    if state.data_ptr() % 16:
        raise ValueError(f"{name} takes a 16-byte-aligned state (float4 rows)")


def mamba2_step(u: torch.Tensor, conv_state: torch.Tensor, conv_w: torch.Tensor,
                conv_b: torch.Tensor, dt_bias: torch.Tensor, A: torch.Tensor, D: torch.Tensor,
                state: torch.Tensor, norm_w: torch.Tensor, groups: int,
                eps: float) -> torch.Tensor:
    """One token of a Mamba2 layer on the card: ``u`` [B, W] the in_proj's output
    (z | x | B | C | dt), ``conv_state`` [B, C, 3] and ``state`` [B,H,P,N] updated
    in place; returns the gated, group-normed y [B, H*P] in bf16 (``ref.mamba2_step``)."""
    _check(u, conv_state, conv_w, conv_b, dt_bias, A, D, state, norm_w, groups)
    b, h, p, n = state.shape
    out = torch.empty((b, h * p), dtype=torch.bfloat16, device=u.device)
    scratch = torch.empty(b * h * p + b * h, dtype=torch.float32, device=u.device)
    key = (u.device.index, b * groups)
    if key not in _tickets:
        _tickets[key] = torch.zeros(b * groups, dtype=torch.int32, device=u.device)
    fn, err_str = _kernel()
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), conv_state.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(),
                dt_bias.data_ptr(), A.data_ptr(), D.data_ptr(), state.data_ptr(),
                norm_w.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                scratch.data_ptr() + 4 * b * h * p, _tickets[key].data_ptr(), b, h, groups,
                h * p, p, n, eps, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_step launch failed: cudaError {rc} ({err_str(rc).decode()})")
    mamba2_step.launches += 1
    return out


mamba2_step.launches = 0


def _fake(u, conv_state, conv_w, conv_b, dt_bias, A, D, state, norm_w, groups, eps):
    b, h, p, _ = state.shape
    return u.new_empty((b, h * p))


_build.define_op("mamba2_step(Tensor u, Tensor(a!) conv_state, Tensor conv_w, Tensor conv_b, "
                 "Tensor dt_bias, Tensor A, Tensor D, Tensor(b!) state, Tensor norm_w, "
                 "int groups, float eps) -> Tensor", mamba2_step, _fake)


def _count(u, conv_state, conv_w, conv_b, dt_bias, A, D, state, norm_w, groups, eps):
    return work.mamba2_step_work(*state.shape, groups)


work.register(torch.ops.repro_torch.mamba2_step, _count, lambda *_: "fp32")
