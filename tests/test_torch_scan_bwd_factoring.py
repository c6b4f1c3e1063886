"""The scans' backward the way the CUDA kernels compute it, on the CPU.

``csrc/rwkv6_scan_bwd.cu`` (K4-bwd) factors WKV6's decay-weighted sums over
(i, j, k) through reference rows so that they run as tensor-core products.
Within a 64-row chunk, with cl the inclusive cumsum of log2 w down each key
column, clp the exclusive one and 16-row blocks I, J:

  att_IJ   = (r_I * 2^(clp_I - ref_I)) (k_J * 2^(ref_I - cl_J))^T          J < I
  dr_I    += 2^(clp_I - ref_I) * (datt_IJ (k_J * 2^(ref_I - cl_J)))      J < I
  dk_J    += 2^(ref'_J - cl_J) * (datt_IJ^T (r_I * 2^(clp_I - ref'_J)))  I > J

with ref_I = clp at I's first row and ref'_J = cl at J's last row; every
16 x 16 diagonal block splits at its middle row the same way, and only its two
8 x 8 diagonal sub-blocks keep one exponential per (i, j < i, k).  Here that
algorithm is written out in torch (``wkv6_factored_terms``) and held:

  * in float64 to the direct triple sums, to 1e-12 of the largest value:
    the factoring is exact up to rounding;
  * in fp32 to the direct sums in float64 on the same fp32 operands (the
    kernel holds cl in fp32), to 1e-5 of the largest value;
  * through the whole gradient (the reverse state pass, every chunk's dr, dk,
    dv, dw, du and ds0, ``wkv6_bwd_kernel_way``), in float64 and in fp32, to
    JAX's vjp of ``repro.kernels.ref.rwkv6_chunked`` on the same numpy
    inputs, within 3e-3 of 1 + |want| (``SCAN_TOL``, the kernels' tolerance);
    where decays reach the 1e-30 clamp, dw as w * dw, and 0 where w < 1e-30.

Every factor is <= 1 and finite, with normal decays and with strong ones
(w = e^-U(0,69), and w = 0 in every 16th key column).

``ssd_bwd_kernel_way`` writes out ``csrc/mamba2_ssd_bwd.cu``'s (K3-bwd)
gradient the same way, with its decay gradient summed from the per-row and
per-column partials the kernel forms, against JAX's vjp of
``repro.kernels.ref.mamba2_ssd``.  K3-bwd's products skip the 16 x 16 blocks
above the diagonal of M and dG, which hold exact zeros: the skip drops only
zero terms and changes no sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

SCAN_TOL = 3e-3
CH = 64        # rows of a chunk (the kernels' compiled size)
BLK = 16       # rows of a block
SUB = 8        # rows of a diagonal sub-block


# ---------------------------------------------------------------- WKV6


def _cumsums(w):
    """cl, clp down the rows of one chunk, in log2 units, as the kernel forms them:
    clp is cl shifted by a row (0 at the first)."""
    cl = torch.cumsum(torch.log2(torch.clamp(w, min=1e-30)), 0)
    return cl, torch.cat([torch.zeros_like(cl[:1]), cl[:-1]])


def _pow2(x, factors):
    """2^x, recorded in ``factors`` (every one must lie in [0, 1]); where x is -inf
    (above a diagonal sub-block's diagonal) no exponential is evaluated."""
    f = torch.exp2(x)
    factors.append(f[torch.isfinite(x)])
    return f


def wkv6_factored_terms(r, k, cl, clp, datt, factors):
    """att (j < i), and datt's terms of dr and dk of one chunk, as K4-bwd computes
    them: [CH, K] r, k, cl, clp and [CH, CH] datt -> att, dr_att, dk_att."""
    att = torch.zeros_like(datt)
    dr, dk = torch.zeros_like(r), torch.zeros_like(k)
    for i0 in range(0, CH, BLK):
        rows = slice(i0, i0 + BLK)
        if i0:                                       # the earlier blocks, through ref_I
            ref = cl[i0 - 1]
            rf = _pow2(clp[rows] - ref, factors)
            kq = k[:i0] * _pow2(ref - cl[:i0], factors)
            att[rows, :i0] = (r[rows] * rf) @ kq.T
            dr[rows] += rf * (datt[rows, :i0] @ kq)
        if i0 + BLK < CH:                            # the later blocks, through ref'_J
            ref = cl[i0 + BLK - 1]
            rq = r[i0 + BLK:] * _pow2(clp[i0 + BLK:] - ref, factors)
            dk[rows] += _pow2(ref - cl[rows], factors) * (datt[i0 + BLK:, rows].T @ rq)
        a, b = slice(i0, i0 + SUB), slice(i0 + SUB, i0 + BLK)   # the mid-row split
        ref = cl[i0 + SUB - 1]
        rf = _pow2(clp[b] - ref, factors)
        km = k[a] * _pow2(ref - cl[a], factors)
        rm = r[b] * rf
        att[b, a] = rm @ km.T
        dr[b] += rf * (datt[b, a] @ km)
        dk[a] += _pow2(ref - cl[a], factors) * (datt[b, a].T @ rm)
        for s in (i0, i0 + SUB):                     # the 8 x 8 diagonal sub-blocks
            sb = slice(s, s + SUB)
            lower = torch.tril(torch.ones(SUB, SUB, dtype=torch.bool), -1)[..., None]
            e = torch.where(lower, clp[sb, None] - cl[None, sb], -torch.inf)
            E = _pow2(e, factors)                    # [i, j, k], 0 on and above j = i
            att[sb, sb] = torch.einsum("ik,jk,ijk->ij", r[sb], k[sb], E)
            dr[sb] += torch.einsum("ij,jk,ijk->ik", datt[sb, sb], k[sb], E)
            dk[sb] += torch.einsum("ij,ik,ijk->jk", datt[sb, sb], r[sb], E)
    return att, dr, dk


def wkv6_direct_terms(r, k, cl, clp, datt):
    """The same three sums with one exponential per (i, j < i, k)."""
    lower = torch.tril(torch.ones(CH, CH, dtype=torch.bool), -1)[..., None]
    E = torch.where(lower, torch.exp2(clp[:, None] - cl[None]), 0.0)
    return (torch.einsum("ik,jk,ijk->ij", r, k, E),
            torch.einsum("ij,jk,ijk->ik", datt, k, E),
            torch.einsum("ij,ik,ijk->jk", datt, r, E))


def _wkv6_chunk_grads(r, k, v, w, u, S, dS, dy, factors):
    """One chunk's dr, dk, dv, dlog w and du partial from its initial state S and the
    gradient dS of its final state, as the chunk pass computes them."""
    cl, clp = _cumsums(w)
    clL = cl[-1]
    datt = dy @ v.T
    att, dr_att, dk_att = wkv6_factored_terms(r, k, cl, clp, datt, factors)
    bonus = (r * u * k).sum(-1)
    dd = torch.diagonal(datt)
    x1 = _pow2(clp, factors) * (dy @ S.T)
    dec = _pow2(clL - cl, factors)
    x2 = dec * (v @ dS.T)
    dv = (att + torch.diag(bonus)).T @ dy + (k * dec) @ dS
    drp, dkp = x1 + dr_att, x2 + dk_att
    dclp, dcl = r * drp, -k * dkp
    last = (S * dS).sum(-1) * _pow2(clL, factors) + (k * x2).sum(0)
    # dlog w_m = last + sum_{i >= m} dcl_i + sum_{i > m} dclp_i
    suffix = lambda x: torch.flip(torch.cumsum(torch.flip(x, [0]), 0), [0])
    dlw = last + suffix(dcl) + suffix(dclp) - dclp
    return (drp + dd[:, None] * u * k, dkp + dd[:, None] * u * r, dv, dlw,
            (dd[:, None] * r * k).sum(0))


def wkv6_bwd_kernel_way(r, k, v, w, u, s0, dy, ds_out, factors):
    """Every gradient of rwkv6_chunked the way K4-bwd computes it: the forward's state
    at every chunk's start, a reverse state pass for the gradient of every chunk's
    final state, then each chunk on its own.  Rows past T read as r = k = v = dy = 0,
    w = 1; dw = dlog w / w, 0 where w < 1e-30."""
    b, t, h, kd = r.shape
    n = -(-t // CH)
    pad = lambda x, fill=0.0: torch.cat(
        [x, x.new_full((b, n * CH - t, h, x.shape[-1]), fill)], 1)
    rp, kp, vp, dyp, wp = pad(r), pad(k), pad(v), pad(dy), pad(w, 1.0)
    dr, dk, dv, dlw = (torch.zeros_like(x) for x in (rp, kp, vp, wp))
    du, ds0 = torch.zeros_like(u), torch.zeros_like(s0)
    for bb in range(b):
        for hh in range(h):
            rows = lambda x, c: x[bb, c * CH:(c + 1) * CH, hh]
            states = [s0[bb, hh]]
            for c in range(n - 1):
                cl, _ = _cumsums(rows(wp, c))
                kdec = rows(kp, c) * torch.exp2(cl[-1] - cl)
                states.append(torch.exp2(cl[-1])[:, None] * states[-1] + kdec.T @ rows(vp, c))
            grad = ds_out[bb, hh] if ds_out is not None else torch.zeros_like(s0[bb, hh])
            dstates = [None] * n
            for c in reversed(range(n)):             # the reverse state pass
                dstates[c] = grad
                cl, clp = _cumsums(rows(wp, c))
                q = rows(rp, c) * _pow2(clp, factors)
                grad = _pow2(cl[-1], factors)[:, None] * grad + q.T @ rows(dyp, c)
            ds0[bb, hh] = grad
            for c in range(n):
                g = _wkv6_chunk_grads(rows(rp, c), rows(kp, c), rows(vp, c), rows(wp, c),
                                      u[hh], states[c], dstates[c], rows(dyp, c), factors)
                for out, x in zip((dr, dk, dv, dlw), g):
                    out[bb, c * CH:(c + 1) * CH, hh] = x
                du[hh] += g[4]
    dlw = dlw[:, :t]
    dw = torch.where(w >= 1e-30, dlw / w, torch.zeros_like(w))
    return dr[:, :t], dk[:, :t], dv[:, :t], dw, du, ds0


def _wkv6_inputs(seed, b, t, h, d, strong):
    """chip_smoke.wkv6_inputs's value ranges: r, k, v ~ N(0, 0.25), w = sigmoid(N - 1),
    u ~ N(0, 0.09), a nonzero state; ``strong``: w = e^-U(0,69), 0 in every 16th key
    column.  Cotangents of y and of the final state beside them."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)
    r, k, v = n(b, t, h, d) * 0.5, n(b, t, h, d) * 0.5, n(b, t, h, d) * 0.5
    w = (1.0 / (1.0 + np.exp(-(n(b, t, h, d) - 1.0)))).astype(np.float32)
    if strong:
        w = np.exp(-69.0 * rng.random((b, t, h, d))).astype(np.float32)
        w[..., ::16] = 0.0
    return (r, k, v, w, n(h, d) * 0.3, n(b, h, d, d) * 0.2,
            n(b, t, h, d), n(b, h, d, d) * 0.5)


def _chunk(seed, strong, dtype):
    """One chunk's r, k, cl, clp and datt."""
    r, k, v, w, _, _, dy, _ = (torch.from_numpy(a).to(dtype) for a in
                               _wkv6_inputs(seed, 1, CH, 1, 64, strong))
    r, k, v, w, dy = (x[0, :, 0] for x in (r, k, v, w, dy))
    cl, clp = _cumsums(w)
    return r, k, cl, clp, dy @ v.T


def _check_factors(factors):
    for f in factors:
        assert torch.isfinite(f).all() and float(f.max()) <= 1.0 and float(f.min()) >= 0.0


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_factored_sums_match_the_direct_triple_sums(seed, strong):
    r, k, cl, clp, datt = _chunk(seed, strong, torch.float64)
    want = wkv6_direct_terms(r, k, cl, clp, datt)
    factors = []
    got = wkv6_factored_terms(r, k, cl, clp, datt, factors)
    _check_factors(factors)
    for g, wnt in zip(got, want):
        assert torch.isfinite(g).all()
        scale = float(wnt.abs().max())
        assert float((g - wnt).abs().max()) <= 1e-12 * scale, (float((g - wnt).abs().max()),
                                                               scale)
    # the exponentials the factoring evaluates: under an eighth of the direct sums'
    # three per (i, j < i, k)
    n_exp = sum(f.numel() for f in factors)
    assert n_exp < 3 * CH * (CH - 1) // 2 * 64 // 8, n_exp


@pytest.mark.parametrize("strong", [False, True])
def test_factored_sums_in_fp32_match_float64(strong):
    chunk = tuple(x.float() for x in _chunk(7, strong, torch.float64))
    want = wkv6_direct_terms(*(x.double() for x in chunk))
    factors = []
    got = wkv6_factored_terms(*chunk, factors)
    _check_factors(factors)
    for g, wnt in zip(got, want):
        assert torch.isfinite(g).all()
        scale = float(wnt.abs().max())
        assert float((g.double() - wnt).abs().max()) <= 1e-5 * scale


def _close_grad(got, want):
    """|got - want| <= SCAN_TOL (1 + |want|) elementwise."""
    got, want = got.double().numpy(), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) / (1 + np.abs(want))
    assert float(err.max(initial=0.0)) <= SCAN_TOL, float(err.max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("t,strong,ds_out", [(150, False, True), (64, False, False),
                                             (100, True, True), (17, True, True)])
def test_wkv6_kernel_way_gradient_matches_jax_vjp(t, strong, ds_out, dtype):
    arrs = _wkv6_inputs(40 + t, 2, t, 2, 32, strong)
    jr, jk, jv, jw, ju, js, jdy, jds = map(jnp.asarray, arrs)
    r, k, v, w, u, s, dy, ds = (torch.from_numpy(a).to(dtype) for a in arrs)
    fn = lambda *a: jref.rwkv6_chunked(*a, chunk=CH)
    if ds_out:
        _, vjp = jax.vjp(fn, jr, jk, jv, jw, ju, js)
        want = vjp((jdy, jds))
    else:
        _, vjp = jax.vjp(lambda *a: fn(*a)[0], jr, jk, jv, jw, ju, js)
        want = vjp(jdy)
    factors = []
    got = wkv6_bwd_kernel_way(r, k, v, w, u, s, dy, ds if ds_out else None, factors)
    _check_factors(factors)
    for name, g, wnt in zip("r k v w u s".split(), got, want):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        if name == "w" and strong:
            _close_grad(g * w, np.asarray(wnt) * arrs[3])
        else:
            _close_grad(g, wnt)
    if strong:
        clamped = w < 1e-30
        assert clamped.any() and (got[3][clamped] == 0).all()


# ---------------------------------------------------------------- SSD


def ssd_bwd_kernel_way(x, dt, A, Bm, Cm, s0, dy, ds_out):
    """Every gradient of mamba2_ssd the way K3-bwd computes it, 64 rows at a time: the
    forward's state before every 64 rows, a reverse state pass, then per chunk and
    head the products and the decay gradient from its per-row and per-column
    partials (rows past T read as zeros).  dB and dC are summed over the heads, dA
    over batch and chunks."""
    bt, t, h, p = x.shape
    n = -(-t // CH)
    pad = lambda a: torch.cat([a, a.new_zeros((bt, n * CH - t) + a.shape[2:])], 1)
    xp, dtp, Bp, Cp, dyp = map(pad, (x, dt, Bm, Cm, dy))
    dx, ddt, dB, dC = (torch.zeros_like(a) for a in (xp, dtp, Bp, Cp))
    dA, ds0 = torch.zeros_like(A), torch.zeros_like(s0)
    mask = torch.tril(torch.ones(CH, CH, dtype=torch.bool))
    for bb in range(bt):
        for hh in range(h):
            sl = lambda c: slice(c * CH, (c + 1) * CH)
            cls, states = [], [s0[bb, hh]]
            for c in range(n):
                cl = torch.cumsum(A[hh] * dtp[bb, sl(c), hh], 0)
                cls.append(cl)
                xs = dtp[bb, sl(c), hh, None] * xp[bb, sl(c), hh]
                states.append(torch.exp(cl[-1]) * states[-1]
                              + (torch.exp(cl[-1] - cl)[:, None] * xs).T @ Bp[bb, sl(c)])
            grad = ds_out[bb, hh] if ds_out is not None else torch.zeros_like(s0[bb, hh])
            dstates = [None] * n
            for c in reversed(range(n)):
                dstates[c] = grad
                grad = (torch.exp(cls[c][-1]) * grad
                        + (torch.exp(cls[c])[:, None] * dyp[bb, sl(c), hh]).T @ Cp[bb, sl(c)])
            ds0[bb, hh] = grad
            for c in range(n):
                cl, S, dS = cls[c], states[c], dstates[c]
                xc, dtc, dyc = xp[bb, sl(c), hh], dtp[bb, sl(c), hh], dyp[bb, sl(c), hh]
                B_, C_ = Bp[bb, sl(c)], Cp[bb, sl(c)]
                e, dec = torch.exp(cl), torch.exp(cl[-1] - cl)
                xs = dtc[:, None] * xc
                L = torch.where(mask, torch.exp(cl[:, None] - cl[None]), 0.0)
                G = C_ @ B_.T
                M, dG = G * L, L * (dyc @ xs.T)
                st = dec[:, None] * (B_ @ dS.T)              # the state's part of dxs
                dxs = M.T @ dyc + st
                ys = e[:, None] * (dyc @ S)                  # the state's part of dC
                dC[bb, sl(c)] += ys + dG @ B_
                dB[bb, sl(c)] += dG.T @ C_ + dec[:, None] * (xs @ dS)
                dx[bb, sl(c), hh] = dtc[:, None] * dxs
                prow, pcol = (dG * G).sum(1), (dG * G).sum(0)   # per row, per column
                q = (xc * st).sum(1)
                dcl = (C_ * ys).sum(1) + prow - pcol - dtc * q
                last = (S * dS).sum() * e[-1] + (dtc * q).sum()
                da = last + torch.flip(torch.cumsum(torch.flip(dcl, [0]), 0), [0])
                ddt[bb, sl(c), hh] = (xc * dxs).sum(1) + A[hh] * da
                dA[hh] += (dtc * da).sum()
    return dx[:, :t], ddt[:, :t], dA, dB[:, :t], dC[:, :t], ds0


def _ssd_inputs(seed, bt, t, h, p, n, strong):
    """chip_smoke.ssd_inputs's value ranges; ``strong``: A scaled by 50."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s, dtype=np.float32)
    A = -np.abs(r(h)) * (50.0 if strong else 1.0)
    return (r(bt, t, h, p) * 0.5, np.log1p(np.exp(r(bt, t, h) - 1.0)).astype(np.float32),
            A.astype(np.float32), r(bt, t, n) * 0.5, r(bt, t, n) * 0.5,
            r(bt, h, p, n) * 0.2, r(bt, t, h, p), r(bt, h, p, n) * 0.5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("t,strong,ds_out", [(150, False, True), (100, False, False),
                                             (100, True, True)])
def test_ssd_kernel_way_gradient_matches_jax_vjp(t, strong, ds_out, dtype):
    arrs = _ssd_inputs(60 + t, 2, t, 3, 16, 8, strong)
    jx, jdt, jA, jB, jC, js, jdy, jds = map(jnp.asarray, arrs)
    fn = lambda *a: jref.mamba2_ssd(*a, chunk=128)
    if ds_out:
        _, vjp = jax.vjp(fn, jx, jdt, jA, jB, jC, js)
        want = vjp((jdy, jds))
    else:
        _, vjp = jax.vjp(lambda *a: fn(*a)[0], jx, jdt, jA, jB, jC, js)
        want = vjp(jdy)
    x, dt, A, B, C, s, dy, ds = (torch.from_numpy(a).to(dtype) for a in arrs)
    got = ssd_bwd_kernel_way(x, dt, A, B, C, s, dy, ds if ds_out else None)
    for g, wnt in zip(got, want):
        assert g.dtype == dtype and torch.isfinite(g).all()
        _close_grad(g, wnt)
