"""The port's int8 error-feedback gradient compression against the JAX package's.

``tests/test_compress.py``'s three properties, ported (the rounding noise
from a seeded ``torch.Generator``), and parity with
``repro.parallel.compress``: given JAX's own noise bits
(``jax.random.uniform(fold_in(key, i), padded shape) - 0.5``, as numpy),
the int8 values and the scales are equal bit for bit, and the dequantised
gradients and the new residuals exactly, on a tree of bf16 and fp32 leaves
whose sizes are not multiples of the 256-value block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.parallel import compress as jcompress
from repro_torch import interop
from repro_torch.parallel import compress


def test_quantize_roundtrip_error_bounded():
    gen = torch.Generator().manual_seed(0)
    g = torch.randn(1000, generator=gen) * 3.0
    q, scale = compress.quantize(g, gen)
    deq = compress.dequantize(q, scale, g.shape, torch.float32)
    # error <= 1 quantization step (= scale), stochastic rounding adds <= 1/2
    assert float((deq - g).abs().max()) <= float(scale.max()) * 1.51
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127


def test_error_feedback_preserves_convergence():
    """SGD on a quadratic: EF-compressed grads reach the optimum."""
    gen = torch.Generator().manual_seed(1)
    target = torch.randn(64, generator=gen)
    w = torch.zeros(64)
    res = None
    for _ in range(120):
        g_c, res = compress.compress_tree({"w": w - target}, res, gen)
        w = w - 0.2 * g_c["w"]
    assert float(torch.linalg.norm(w - target)) < 1e-2


def test_compression_ratio():
    g = torch.zeros(100_000)
    q, scale = compress.quantize(g, torch.Generator().manual_seed(2))
    raw = g.numel() * 4
    packed = q.numel() * 1 + scale.numel() * 4
    assert packed < raw / 3.5


def _jax_noise(key, n):
    blocks = -(-n // compress.BLOCK)
    return np.array(jax.random.uniform(key, (blocks, compress.BLOCK)) - 0.5).reshape(-1)


@pytest.mark.parametrize("n", [1000, 256, 7, 70_001])
def test_quantize_matches_jax_bit_for_bit(n):
    key = jax.random.PRNGKey(n)
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(n + 1), (n,)) * 3.0)
    qj, sj = jcompress.quantize(jnp.asarray(g), key)
    qt, st = compress.quantize(torch.from_numpy(g.copy()), torch.from_numpy(_jax_noise(key, n)))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.uint32), np.asarray(sj).view(np.uint32))
    deq_j = jcompress.dequantize(qj, sj, (n,), jnp.float32)
    np.testing.assert_array_equal(compress.dequantize(qt, st, (n,), torch.float32).numpy(),
                                  np.asarray(deq_j))


def test_compress_tree_matches_jax_exactly():
    """Two calls, the second carrying the first's residual, on bf16 and fp32
    leaves of sizes 3*5*7, 1000 and 257*3: dequantised grads (in each leaf's
    dtype) and residuals equal to the last bit."""
    shapes = {"a": ((3, 5, 7), jnp.bfloat16), "b": {"c": ((1000,), jnp.float32),
                                                    "d": ((257, 3), jnp.bfloat16)}}
    keys = iter(jax.random.split(jax.random.PRNGKey(7), 8))

    def leaf(spec):
        shape, dt = spec
        return (jax.random.normal(next(keys), shape) * 2.0).astype(dt)

    def tmap(fn, tree):
        return {k: tmap(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}

    grads = [tmap(leaf, shapes) for _ in range(2)]
    res_j = res_t = None
    for step, g in enumerate(grads):
        key = jax.random.PRNGKey(100 + step)
        out_j, res_j = jcompress.compress_tree(g, res_j, key)
        leaves = jax.tree_util.tree_leaves(g)
        noise = [torch.from_numpy(_jax_noise(jax.random.fold_in(key, i), x.size))
                 for i, x in enumerate(leaves)]
        out_t, res_t = compress.compress_tree(interop.to_torch(g, "cpu"), res_t, noise)
        for want, got in ((out_j, out_t), (res_j, res_t)):
            want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
            got = jax.tree_util.tree_leaves(interop.to_numpy(got))
            assert len(want) == len(got) == 3
            for w, t in zip(want, got):
                assert t.dtype == w.dtype
                bits = np.uint16 if w.dtype.itemsize == 2 else np.uint32
                np.testing.assert_array_equal(t.view(bits), w.view(bits))


def test_zero_residual_is_fp32_zeros_like_the_grads():
    grads = {"a": torch.ones(3, 4, dtype=torch.bfloat16), "b": {"c": torch.ones(5)}}
    res = compress.zero_residual(grads)
    assert res["a"].dtype == res["b"]["c"].dtype == torch.float32
    assert res["a"].shape == (3, 4) and not res["b"]["c"].any()
