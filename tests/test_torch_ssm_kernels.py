"""The WKV6 and SSD scans in the PyTorch port, on the CPU.

The port's plain versions (``repro_torch.kernels.ref``) against the JAX
package's ``ref`` (y and final state, from a nonzero initial state) and its
Pallas kernels in interpret mode (y, from the zero state the Pallas kernels
start from), on the same numpy inputs, in the value ranges and (t, chunk)
grid of tests/test_kernels_pallas.py, and with decays strong enough to
underflow within a chunk.  The CUDA kernels' own tests are in
test_torch_cuda.py.  Tolerance 3e-3, the JAX package's fp32 tolerance for
these scans.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.mamba2_ssd import ssd_fwd as pallas_ssd
from repro.kernels.rwkv6_scan import wkv6_fwd as pallas_wkv6
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = 3e-3


def _close(a, b, tol=TOL):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol, atol=tol)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _softplus(x):
    return np.log1p(np.exp(x))


def _wkv6_inputs(seed, t, b=2, h=2, kd=16, vd=16):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)
    arrs = (n(b, t, h, kd) * 0.5, n(b, t, h, kd) * 0.5, n(b, t, h, vd) * 0.5,
            _sigmoid(n(b, t, h, kd) - 1.0).astype(np.float32), n(h, kd) * 0.3,
            n(b, h, kd, vd) * 0.2)
    return tuple(map(jnp.asarray, arrs)), tuple(map(torch.from_numpy, arrs))


def _ssd_inputs(seed, t, bt=2, h=3, p=16, n=8):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s, dtype=np.float32)
    arrs = (r(bt, t, h, p) * 0.5, _softplus(r(bt, t, h) - 1.0).astype(np.float32),
            -np.abs(r(h)), r(bt, t, n) * 0.5, r(bt, t, n) * 0.5, r(bt, h, p, n) * 0.2)
    return tuple(map(jnp.asarray, arrs)), tuple(map(torch.from_numpy, arrs))


@pytest.mark.parametrize("t,chunk", [(64, 16), (128, 32), (100, 32), (20, 64)])
def test_plain_rwkv6_chunked_matches_jax_ref_and_pallas(t, chunk):
    (jr, jk, jv, jw, ju, js), (r, k, v, w, u, s) = _wkv6_inputs(t, t)
    y, state = tref.rwkv6_chunked(r, k, v, w, u, s, chunk=chunk)
    j_y, j_state = jref.rwkv6_chunked(jr, jk, jv, jw, ju, js, chunk=chunk)
    _close(y, j_y)
    _close(state, j_state)
    y0, _ = tref.rwkv6_chunked(r, k, v, w, u, torch.zeros_like(s), chunk=chunk)
    _close(y0, pallas_wkv6(jr, jk, jv, jw, ju, chunk=chunk, interpret=True))


@pytest.mark.parametrize("t", [1, 37])
def test_plain_rwkv6_naive_matches_jax(t):
    (jr, jk, jv, jw, ju, js), (r, k, v, w, u, s) = _wkv6_inputs(100 + t, t)
    y, state = tref.rwkv6_naive(r, k, v, w, u, s)
    j_y, j_state = jref.rwkv6_naive(jr, jk, jv, jw, ju, js)
    _close(y, j_y)
    _close(state, j_state)


@pytest.mark.parametrize("t,chunk", [(64, 16), (128, 64), (100, 32), (20, 128)])
def test_plain_mamba2_ssd_matches_jax_ref_and_pallas(t, chunk):
    (jx, jdt, jA, jB, jC, js), (x, dt, A, B, C, s) = _ssd_inputs(t, t)
    y, state = tref.mamba2_ssd(x, dt, A, B, C, s, chunk=chunk)
    j_y, j_state = jref.mamba2_ssd(jx, jdt, jA, jB, jC, js, chunk=chunk)
    _close(y, j_y)
    _close(state, j_state)
    y0, _ = tref.mamba2_ssd(x, dt, A, B, C, torch.zeros_like(s), chunk=chunk)
    _close(y0, pallas_ssd(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True))


@pytest.mark.parametrize("t", [1, 37])
def test_plain_mamba2_naive_matches_jax(t):
    (jx, jdt, jA, jB, jC, js), (x, dt, A, B, C, s) = _ssd_inputs(200 + t, t)
    y, state = tref.mamba2_naive(x, dt, A, B, C, s)
    j_y, j_state = jref.mamba2_naive(jx, jdt, jA, jB, jC, js)
    _close(y, j_y)
    _close(state, j_state)


def _wkv6_strong(seed, t):
    """Decays spread down to the 1e-30 clamp of both references (w = e^-U(0, 69)), and
    w = 0 in every 4th key column: where the CUDA kernel's factored decays underflow."""
    (_, _, _, _, ju, js), (r, k, v, w, u, s) = _wkv6_inputs(seed, t)
    rng = np.random.default_rng(seed + 1)
    w = np.exp(-69.0 * rng.random(tuple(w.shape))).astype(np.float32)
    w[..., ::4] = 0.0
    arrs = [a.numpy() for a in (r, k, v)] + [w, u.numpy(), s.numpy()]
    return tuple(map(jnp.asarray, arrs)), tuple(map(torch.from_numpy, arrs))


def _ssd_strong(seed, t):
    """A scaled by 50: e^cl and the pairwise decays underflow within a chunk."""
    _, (x, dt, A, B, C, s) = _ssd_inputs(seed, t)
    arrs = [x.numpy(), dt.numpy(), A.numpy() * 50.0, B.numpy(), C.numpy(), s.numpy()]
    return tuple(map(jnp.asarray, arrs)), tuple(map(torch.from_numpy, arrs))


@pytest.mark.parametrize("t,chunk", [(64, 16), (100, 32), (17, 64)])
def test_plain_rwkv6_chunked_with_strong_decays_matches_jax(t, chunk):
    (jr, jk, jv, jw, ju, js), (r, k, v, w, u, s) = _wkv6_strong(300 + t, t)
    y, state = tref.rwkv6_chunked(r, k, v, w, u, s, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    j_y, j_state = jref.rwkv6_chunked(jr, jk, jv, jw, ju, js, chunk=chunk)
    _close(y, j_y)
    _close(state, j_state)
    y0, _ = tref.rwkv6_chunked(r, k, v, w, u, torch.zeros_like(s), chunk=chunk)
    _close(y0, pallas_wkv6(jr, jk, jv, jw, ju, chunk=chunk, interpret=True))
    for got, want in zip((y, state), tref.rwkv6_naive(r, k, v, w, u, s)):
        _close(got, want.numpy())


@pytest.mark.parametrize("t,chunk", [(64, 16), (100, 32), (17, 128)])
def test_plain_mamba2_ssd_with_decays_that_underflow_matches_jax(t, chunk):
    (jx, jdt, jA, jB, jC, js), (x, dt, A, B, C, s) = _ssd_strong(400 + t, t)
    y, state = tref.mamba2_ssd(x, dt, A, B, C, s, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    j_y, j_state = jref.mamba2_ssd(jx, jdt, jA, jB, jC, js, chunk=chunk)
    _close(y, j_y)
    _close(state, j_state)
    y0, _ = tref.mamba2_ssd(x, dt, A, B, C, torch.zeros_like(s), chunk=chunk)
    _close(y0, pallas_ssd(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True))
    for got, want in zip((y, state), tref.mamba2_naive(x, dt, A, B, C, s)):
        _close(got, want.numpy())


def test_chunked_scans_match_their_naive_steps():
    """The chunked forms against the per-step oracles, ragged t, port only."""
    _, (r, k, v, w, u, s) = _wkv6_inputs(7, 77)
    for got, want in zip(tref.rwkv6_chunked(r, k, v, w, u, s, chunk=32),
                         tref.rwkv6_naive(r, k, v, w, u, s)):
        _close(got, want.numpy())
    _, (x, dt, A, B, C, s) = _ssd_inputs(8, 77)
    for got, want in zip(tref.mamba2_ssd(x, dt, A, B, C, s, chunk=32),
                         tref.mamba2_naive(x, dt, A, B, C, s)):
        _close(got, want.numpy())


def test_ops_on_cpu_is_the_plain_chunked_form():
    _, (r, k, v, w, u, s) = _wkv6_inputs(9, 50)
    for got, want in zip(ops.wkv6(r, k, v, w, u, s, chunk=16),
                         tref.rwkv6_chunked(r, k, v, w, u, s, chunk=16)):
        assert torch.equal(got, want)
    _, (x, dt, A, B, C, s) = _ssd_inputs(10, 50)
    for got, want in zip(ops.mamba2_ssd(x, dt, A, B, C, s, chunk=16),
                         tref.mamba2_ssd(x, dt, A, B, C, s, chunk=16)):
        assert torch.equal(got, want)


# ---------------------------------------------------------------- backward

def _cotangents(seed, y_shape, s_shape):
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal(y_shape, dtype=np.float32),
            rng.standard_normal(s_shape, dtype=np.float32) * 0.5)
    return tuple(map(jnp.asarray, arrs)), tuple(map(torch.from_numpy, arrs))


def _close_grad(got, want, tol=TOL):
    """|got - want| <= tol * (1 + |want|) elementwise: the measure of chip_smoke.py's
    _scan_errors for the kernels."""
    got, want = got.numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want) / (1 + np.abs(want))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.mark.parametrize("t,chunk,strong", [(64, 16, False), (100, 32, False),
                                            (37, 64, False), (100, 32, True), (17, 64, True)])
def test_plain_rwkv6_chunked_bwd_matches_jax_vjp(t, chunk, strong):
    """Every input's gradient from a nonzero initial state, for random cotangents of y
    and of the final state.  With strong decays, dw = dlog(w) / w multiplies the fp32
    rounding of dlog(w)'s cancelling sums by up to 1e30 wherever w is tiny, in JAX's
    autodiff as in torch's, so dw is held as w * dw there (the gradient of log w, which
    is well conditioned), and must be exactly 0 where the clamp at 1e-30 bites."""
    (jr, jk, jv, jw, ju, js), (r, k, v, w, u, s) = (
        _wkv6_strong(500 + t, t) if strong else _wkv6_inputs(500 + t, t))
    (jdy, jds), (dy, ds) = _cotangents(600 + t, tuple(r.shape), tuple(s.shape))
    _, vjp = jax.vjp(lambda *a: jref.rwkv6_chunked(*a, chunk=chunk), jr, jk, jv, jw, ju, js)
    want = vjp((jdy, jds))
    got = tref.rwkv6_chunked_bwd(r, k, v, w, u, s, dy, ds, chunk=chunk)
    for name, g, wnt in zip("r k v w u s".split(), got, want):
        assert torch.isfinite(g).all(), name
        if name == "w" and strong:
            _close_grad(g * w, np.asarray(wnt) * np.asarray(jw))
        else:
            _close_grad(g, wnt)
    if strong:
        clamped = w < 1e-30
        assert clamped.any() and (got[3][clamped] == 0).all()
        assert (np.asarray(want[3])[clamped.numpy()] == 0).all()
    # no cotangent for the final state: the gradients through y alone
    _, vjp_y = jax.vjp(lambda *a: jref.rwkv6_chunked(*a, chunk=chunk)[0], jr, jk, jv, jw, ju, js)
    for g, wnt in zip(tref.rwkv6_chunked_bwd(r, k, v, w, u, s, dy, None, chunk=chunk)[:3],
                      vjp_y(jdy)[:3]):
        _close_grad(g, wnt)


@pytest.mark.parametrize("t,chunk,strong", [(64, 16, False), (100, 32, False),
                                            (20, 128, False), (100, 32, True), (17, 128, True)])
def test_plain_mamba2_ssd_bwd_matches_jax_vjp(t, chunk, strong):
    """Every input's gradient (dA summed over batch and time, dB and dC over the heads)
    from a nonzero initial state, for random cotangents of y and of the final state;
    ``strong``: decays that underflow within a chunk."""
    (jx, jdt, jA, jB, jC, js), (x, dt, A, B, C, s) = (
        _ssd_strong(700 + t, t) if strong else _ssd_inputs(700 + t, t))
    (jdy, jds), (dy, ds) = _cotangents(800 + t, tuple(x.shape), tuple(s.shape))
    _, vjp = jax.vjp(lambda *a: jref.mamba2_ssd(*a, chunk=chunk), jx, jdt, jA, jB, jC, js)
    got = tref.mamba2_ssd_bwd(x, dt, A, B, C, s, dy, ds, chunk=chunk)
    for g, wnt in zip(got, vjp((jdy, jds))):
        assert torch.isfinite(g).all()
        _close_grad(g, wnt)
    _, vjp_y = jax.vjp(lambda *a: jref.mamba2_ssd(*a, chunk=chunk)[0], jx, jdt, jA, jB, jC, js)
    for g, wnt in zip(tref.mamba2_ssd_bwd(x, dt, A, B, C, s, dy, None, chunk=chunk),
                      vjp_y(jdy)):
        _close_grad(g, wnt)


def test_scan_kernels_are_compiled_for_every_configs_sizes():
    """The WKV6 kernels take the scan head size K = V, and the SSD kernels the head and
    state sizes (P, N), of every arch of the reference's registry, at its full and its
    reduced config: so the launchers run the reference's configs unchanged on the card."""
    from repro.configs import ARCH_NAMES, get_arch
    from repro_torch.kernels import mamba2_ssd, rwkv6_scan
    seen = set()
    for arch in ARCH_NAMES:
        for cfg in (get_arch(arch), get_arch(arch).reduced()):
            if cfg.family == "ssm":
                assert cfg.ssm_head_dim in rwkv6_scan.HEAD_DIMS, (arch, cfg.ssm_head_dim)
                seen.add(("K", cfg.ssm_head_dim))
            elif cfg.family == "hybrid":
                shape = (cfg.ssm_head_dim, cfg.ssm_state)
                assert shape in mamba2_ssd.SHAPES, (arch, shape)
                seen.add(("PN", shape))
    assert seen == {("K", 32), ("K", 64), ("PN", (32, 16)), ("PN", (64, 64))}
