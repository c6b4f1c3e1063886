"""Hand-written CUDA checksum for Hopper (``csrc/checksum.cu``).

Replaces the TPU kernel ``repro.kernels.checksum.checksum``: the digest
(sum_i (i+1)*x_i, sum_i x_i) mod 2^32 of a buffer of 32-bit words, which is
the same for every block size.  The library is built by ``nvcc`` at the
first launch (see ``_build``); this wrapper checks its input, zeroes the
output, launches on PyTorch's current stream and counts its launches in
``checksum.launches``.  It takes CUDA tensors only: the plain version is
``ref.checksum``.  ``ops.tensor_checksum`` calls it through its operator,
``torch.ops.repro_torch.checksum``, whose fake implementation gives the
digest's shape, with its work (``work.checksum_work``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, work

_MASK32 = 0xFFFFFFFF


@functools.cache
def _kernel():
    lib = _build.load("checksum")
    fn = lib.tensor_checksum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.tensor_checksum_error_string.argtypes = [ctypes.c_int]
    lib.tensor_checksum_error_string.restype = ctypes.c_char_p
    return fn, lib.tensor_checksum_error_string


def checksum(data: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Digest of a 1-D contiguous int32 or uint32 CUDA tensor, read as
    unsigned 32-bit words.  Returns int64 [2] = (weighted, plain), each in
    [0, 2^32): the bits of the reference's uint32 [2].  ``block`` is
    checked and otherwise does not change the result."""
    _build.refuse_dtensor("checksum", data)
    if not data.is_cuda:
        raise ValueError(f"checksum takes a CUDA tensor; got one on {data.device}")
    if data.dtype not in (torch.int32, torch.uint32):
        raise ValueError(f"checksum takes int32 or uint32 words; got {data.dtype}")
    if data.dim() != 1 or not data.is_contiguous():
        raise ValueError(f"checksum takes a 1-D contiguous tensor; got shape "
                         f"{tuple(data.shape)}, strides {data.stride()}")
    if block <= 0:
        raise ValueError(f"block must be positive; got {block}")
    out = torch.zeros(2, dtype=torch.int32, device=data.device)
    if data.numel() == 0:
        return out.to(torch.int64)
    fn, err_str = _kernel()
    with torch.cuda.device(data.device):
        rc = fn(data.data_ptr(), data.numel(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"checksum launch failed: cudaError {rc} ({err_str(rc).decode()})")
    checksum.launches += 1
    return out.to(torch.int64) & _MASK32


checksum.launches = 0


_build.define_op("checksum(Tensor data, int block) -> Tensor", checksum,
                 lambda data, block: data.new_empty(2, dtype=torch.int64))

work.register(torch.ops.repro_torch.checksum,
              lambda data, block: work.checksum_work(data.numel()), peak=None)
