"""Flash attention in the PyTorch port.

On the CPU: the port's plain version (``repro_torch.kernels.ref``) against
the JAX package's ``ref`` and its Pallas kernel in interpret mode, on the
same numpy inputs (the CUDA kernel's own tests are in test_torch_cuda.py).
Tolerances are the JAX package's own
(tests/test_kernels_pallas.py): 2e-3 for fp32, 2e-2 for bf16, whose 8-bit
mantissa rounds the inputs and the output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd as pallas_fwd
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def _inputs(seed, b, tq, tk, kv, g, hd, dtype):
    """The same q/k/v for both packages: numpy fp32, rounded to ``dtype`` by each."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((b, tq, kv, g, hd), dtype=np.float32),
            rng.standard_normal((b, tk, kv, hd), dtype=np.float32),
            rng.standard_normal((b, tk, kv, hd), dtype=np.float32))
    jx = tuple(jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    tx = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    return jx, tx


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("t,window,dtype", [
    (128, 0, "float32"), (256, 0, "float32"), (96, 0, "float32"),
    (128, 32, "float32"), (128, 0, "bfloat16"),
])
@pytest.mark.parametrize("kv,g", [(2, 1), (2, 2)])
def test_plain_flash_matches_jax_ref_and_pallas(t, window, dtype, kv, g):
    (jq, jk, jv), (q, k, v) = _inputs(0, 2, t, t, kv, g, 32, dtype)
    got = tref.flash_attention(q, k, v, window=window, block_q=64, block_k=64)
    tol = TOL[dtype]
    _close(got, pallas_fwd(jq, jk, jv, window=window, block_q=64, block_k=64,
                           interpret=True), tol)
    _close(got, jref.flash_attention(jq, jk, jv, window=window, block_q=64,
                                     block_k=64), tol)
    f32 = lambda x: x.astype(jnp.float32)
    _close(got, jref.attention_naive(f32(jq), f32(jk), f32(jv), window=window), tol)


@pytest.mark.parametrize("tq,tk,window,q_offset,block_q,block_k", [
    (64, 64, 0, 0, 32, 32), (128, 128, 0, 0, 32, 32), (100, 100, 0, 0, 32, 32),
    (128, 128, 32, 0, 32, 32), (256, 256, 64, 0, 32, 32),
    (32, 96, 0, 64, 16, 32),          # q is a suffix of the sequence
    (40, 100, 24, 60, 16, 32),        # suffix, windowed, ragged blocks
])
def test_plain_flash_fwd_out_and_lse_match_jax(tq, tk, window, q_offset,
                                               block_q, block_k):
    (jq, jk, jv), (q, k, v) = _inputs(1, 2, tq, tk, 2, 2, 16, "float32")
    out, lse = tref._flash_fwd_impl(q, k, v, q_offset, window, block_q, block_k)
    j_out, j_lse = jref._flash_fwd_impl(jq, jk, jv, q_offset, window, block_q,
                                        block_k)
    _close(out, j_out, 2e-3)
    _close(lse, np.asarray(j_lse)[..., :tq], 2e-3)
    _close(tref.attention_naive(q, k, v, q_offset=q_offset, window=window),
           jref.attention_naive(jq, jk, jv, q_offset=q_offset, window=window), 2e-3)


def test_plain_flash_bf16_matches_jax_ref():
    (jq, jk, jv), (q, k, v) = _inputs(2, 1, 80, 80, 2, 2, 32, "bfloat16")
    got = tref.flash_attention(q, k, v, window=16, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    _close(got, jref.flash_attention(jq, jk, jv, window=16, block_q=32,
                                     block_k=32), 2e-2)
