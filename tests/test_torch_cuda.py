"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These need an NVIDIA GPU and skip elsewhere.  They import neither JAX nor
the JAX package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels_pallas.py: 2e-3 for fp32, 2e-2
for bf16, whose 8-bit mantissa rounds the inputs and the output.
"""

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_fwd

TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _inputs(seed, b, tq, tk, kv, g, hd, dtype, device):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, tq, kv, g, hd), generator=gen)
    k = torch.randn((b, tk, kv, hd), generator=gen)
    v = torch.randn((b, tk, kv, hd), generator=gen)
    return tuple(x.to(dtype).to(device) for x in (q, k, v))


def _close(a, b, tol):
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,kv,g,hd,window,q_offset,dtype", [
    (2, 128, 128, 2, 1, 32, 0, 0, torch.float32),
    (2, 200, 200, 2, 2, 64, 0, 0, torch.float32),
    (1, 1000, 1000, 2, 4, 64, 256, 0, torch.float32),
    (1, 77, 300, 2, 4, 64, 100, 223, torch.float32),
    (2, 333, 333, 4, 1, 128, 0, 0, torch.bfloat16),
    (1, 64, 192, 1, 2, 128, 0, 128, torch.bfloat16),
    (2, 96, 96, 2, 2, 32, 40, 0, torch.bfloat16),
    (2, 1, 50, 2, 2, 64, 0, 49, torch.float32),      # one query, decode-like
    (3, 5, 5, 1, 1, 32, 0, 0, torch.bfloat16),       # smaller than one tile
    (1, 130, 130, 1, 1, 128, 1, 0, torch.float32),   # window 1: the diagonal only
])
def test_flash_kernel_matches_plain(cuda, b, tq, tk, kv, g, hd, window, q_offset,
                                    dtype):
    q, k, v = _inputs(3, b, tq, tk, kv, g, hd, dtype, cuda)
    out, lse = flash_attention_fwd(q, k, v, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    want, want_lse = ref._flash_fwd_impl(q, k, v, q_offset, window, 512, 1024)
    assert out.dtype == q.dtype and out.shape == q.shape
    _close(out, want, TOL[dtype])
    _close(lse, want_lse, 2e-3)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _inputs(4, 1, 64, 64, 2, 1, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, k, v)
    q, k, v = _inputs(4, 1, 64, 64, 2, 1, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention_fwd(q.half(), k.half(), v.half())


@pytest.mark.cuda
def test_ops_on_cuda_launches_the_kernel(cuda, monkeypatch):
    monkeypatch.setattr(flash_attention_fwd, "launches", 0)
    q, k, v = _inputs(5, 1, 64, 64, 2, 1, 32, torch.float32, cuda)
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.is_cuda and flash_attention_fwd.launches == 1
    _close(out, ref.flash_attention(q, k, v), TOL[torch.float32])
