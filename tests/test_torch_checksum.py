"""The port's checksum (K2) against the JAX package, on the CPU.

The same numpy words go through the JAX ``ref.checksum``, the Pallas kernel
in interpret mode (as tests/test_kernels_pallas.py runs it) and the port's
plain ``ref.checksum`` / ``ops.tensor_checksum``.  The digest is integer
arithmetic mod 2^32, so every comparison is exact.  The CUDA kernel's own
tests are in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.checksum import checksum as checksum_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref


def _words(n, seed=0):
    """uint32 words spread over the whole range, the top values included, so
    the (i+1)*x products reach 2^64 and would overflow plain int64."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x[: min(n, 8)] = np.uint32(2 ** 32 - 1) - np.arange(min(n, 8), dtype=np.uint32)
    return x


def _torch_words(x: np.ndarray, dtype=torch.int32):
    t = torch.from_numpy(x.view(np.int32).copy())
    return t if dtype == torch.int32 else t.view(torch.uint32)


def _digest(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint64)


def _jax_digest(d) -> np.ndarray:
    return np.asarray(d).astype(np.uint64)


@pytest.mark.parametrize("n", [0, 1, 1000, 4096, 10000])
@pytest.mark.parametrize("block", [256, 512, 4096])
def test_plain_checksum_matches_jax_ref_bit_for_bit(n, block):
    x = _words(n, seed=n)
    want = _jax_digest(jref.checksum(jnp.asarray(x), block=block))
    got = tref.checksum(_torch_words(x), block=block)
    assert got.dtype == torch.int64 and got.shape == (2,)
    np.testing.assert_array_equal(_digest(got), want)
    np.testing.assert_array_equal(_digest(tref.checksum(_torch_words(x, torch.uint32),
                                                        block=block)), want)


@pytest.mark.parametrize("n,block", [(1, 256), (1000, 256), (4096, 4096), (10000, 512)])
def test_plain_checksum_matches_pallas_interpret(n, block):
    x = _words(n, seed=100 + n)
    want = _jax_digest(checksum_pallas(jnp.asarray(x), block=block, interpret=True))
    np.testing.assert_array_equal(_digest(ops.tensor_checksum(_torch_words(x), block)), want)
    # tests/test_kernels_pallas.py's data: i * 2654435761 mod 2^32
    x = (np.arange(n, dtype=np.uint64) * 2654435761 % 2 ** 32).astype(np.uint32)
    want = _jax_digest(checksum_pallas(jnp.asarray(x), block=block, interpret=True))
    np.testing.assert_array_equal(_digest(tref.checksum(_torch_words(x), 4096)), want)


def test_block_size_does_not_matter_and_changes_are_seen():
    """tests/test_kernel_refs.py::test_checksum_detects_corruption_and_reorder."""
    x = np.arange(10000, dtype=np.uint32)
    c0 = _digest(tref.checksum(_torch_words(x)))
    for block in (1, 7, 512, 4096, 16384):
        np.testing.assert_array_equal(_digest(tref.checksum(_torch_words(x), block)), c0)
    corrupted = x.copy()
    corrupted[1234] = 999999
    assert not np.array_equal(_digest(tref.checksum(_torch_words(corrupted))), c0)
    swapped = x.copy()
    swapped[[10, 20]] = swapped[[20, 10]]
    c_swap = _digest(tref.checksum(_torch_words(swapped)))
    assert not np.array_equal(c_swap, c0) and c_swap[1] == c0[1]   # plain sum is blind to order
    flipped = _words(5000, seed=3)
    c1 = _digest(tref.checksum(_torch_words(flipped)))
    flipped[777] ^= np.uint32(1 << 31)
    assert not np.array_equal(_digest(tref.checksum(_torch_words(flipped))), c1)


def test_ops_checksum_takes_words_where_jax_casts_values():
    """JAX's ops.tensor_checksum casts any dtype with astype(uint32) (a value
    cast); the port digests 32-bit words only and refuses other dtypes, so a
    bf16 tensor is digested through its int32 view."""
    x = np.array([1.5, -2.0, 3.0e9], np.float32)
    jax_digest = _jax_digest(jops.tensor_checksum(jnp.asarray(x)))
    np.testing.assert_array_equal(
        jax_digest, _jax_digest(jref.checksum(jnp.asarray(x).astype(jnp.uint32))))
    with pytest.raises(ValueError, match="int32 or uint32"):
        ops.tensor_checksum(torch.from_numpy(x))
    with pytest.raises(ValueError, match="int32 or uint32"):
        tref.checksum(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="1-D"):
        tref.checksum(torch.zeros((2, 2), dtype=torch.int32))
    words = torch.from_numpy(x).view(torch.int32)
    want = _jax_digest(jref.checksum(jnp.asarray(x.view(np.uint32))))
    np.testing.assert_array_equal(_digest(ops.tensor_checksum(words)), want)

