"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These need an NVIDIA GPU and skip elsewhere.  They import neither JAX nor
the JAX package, so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of tests/test_kernels_pallas.py: 2e-3 for fp32, 2e-2
for bf16, whose 8-bit mantissa rounds the inputs and the output, and 3e-3
for the fp32 WKV6 and SSD scans, whose products run on the TF32 tensor cores
split 3xTF32.  The flash backward is held to the same
2e-3 / 2e-2 (its fp32 sums run in another order than the plain version's,
and in bf16 its D = rowsum(do * out) reads the bf16 output where the plain
version recomputes it in fp32); the checksum is integer arithmetic and
must be equal bit for bit.  The flash kernels take bf16 on the tensor cores and
fp32 on the CUDA cores, so each feature is tested in both dtypes.  The decode
kernel reads a bf16 cache and is held to the plain version computed in fp32 on
the same bf16 values: 2e-2 for a bf16 q (its output is rounded to bf16), 2e-3
for an fp32 q.
"""

import ctypes
import math

import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.checksum import checksum as checksum_kernel
from repro_torch.kernels.decode_attention import decode_attention as decode_kernel
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.mamba2_ssd import ssd_bwd, ssd_fwd
from repro_torch.kernels.mamba2_step import mamba2_step as step_kernel
from repro_torch.kernels.rwkv6_scan import wkv6_bwd, wkv6_fwd

TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
SCAN_TOL = 3e-3


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
    # bf16 runs the tensor-core kernel, fp32 the SIMT one: bf16 twins of the fp32 cases
    (2, 200, 200, 2, 2, 64, 0, 0, torch.bfloat16),
    (1, 1000, 1000, 2, 4, 64, 256, 0, torch.bfloat16),
    (1, 77, 300, 2, 4, 64, 100, 223, torch.bfloat16),
    (2, 1, 50, 2, 2, 64, 0, 49, torch.bfloat16),
    (1, 130, 130, 1, 1, 128, 1, 0, torch.bfloat16),
    (1, 200, 260, 2, 2, 112, 64, 60, torch.bfloat16),  # hd 112 at 128, window and offset
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
def test_bf16_flash_kernels_run_on_the_tensor_cores(cuda):
    """The bf16 forward issues wgmma (HGMMA), the bf16 backward mma.sync (HMMA);
    the fp32 kernels stay on the CUDA cores."""
    fwd, bwd = _build.sass_counts("flash_attention"), _build.sass_counts("flash_attention_bwd")
    def total(counts, kernel, op):
        return sum(c[op] for name, c in counts.items() if kernel in name)
    assert total(fwd, "flash_fwd_sm90", "HGMMA") > 0
    assert total(bwd, "dkdv_mma", "HMMA") > 0 and total(bwd, "dq_mma", "HMMA") > 0
    for counts, kernel in ((fwd, "flash_fwd_kernel"), (bwd, "dkdv_kernel"), (bwd, "dq_kernel")):
        assert total(counts, kernel, "HMMA") + total(counts, kernel, "HGMMA") == 0


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


@pytest.mark.cuda
def test_flash_kernel_at_head_dim_112(cuda):
    """zamba2-7b's shared attention block: 32 heads of 112, bf16."""
    q, k, v = _inputs(6, 2, 300, 300, 4, 1, 112, torch.bfloat16, cuda)
    out, lse = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    want, want_lse = ref._flash_fwd_impl(q, k, v, 0, 0, 512, 1024)
    _close(out, want, TOL[torch.bfloat16])
    _close(lse, want_lse, 2e-3)


def _wkv6_inputs(seed, b, t, h, device, d=64):
    """tests/test_kernels_pallas.py's value ranges, and a nonzero state."""
    gen = torch.Generator().manual_seed(seed)
    n = lambda *shape: torch.randn(shape, generator=gen)
    xs = (n(b, t, h, d) * 0.5, n(b, t, h, d) * 0.5, n(b, t, h, d) * 0.5,
          torch.sigmoid(n(b, t, h, d) - 1.0), n(h, d) * 0.3, n(b, h, d, d) * 0.2)
    return tuple(x.to(device) for x in xs)


def _ssd_inputs(seed, b, t, h, device, p=64, n=64):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen)
    xs = (r(b, t, h, p) * 0.5, torch.nn.functional.softplus(r(b, t, h) - 1.0),
          -r(h).abs(), r(b, t, n) * 0.5, r(b, t, n) * 0.5, r(b, h, p, n) * 0.2)
    return tuple(x.to(device) for x in xs)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", [
    (2, 1, 2),          # one step
    (2, 37, 3),         # shorter than a chunk
    (1, 200, 2),        # ragged: 3 chunks and 8 rows
    (3, 128, 4),        # whole chunks
    (4, 2048, 32),      # rwkv6-1.6b prefill: B=4, H=32
    # T at the borders of the kernel's 16-row sub-chunks and 64-row chunks
    *((2, t, 3) for t in (15, 16, 17, 63, 65, 127, 129, 2049)),
])
def test_wkv6_kernel_matches_plain(cuda, b, t, h):
    xs = _wkv6_inputs(7, b, t, h, cuda)
    y, state = wkv6_fwd(*xs)
    torch.cuda.synchronize()
    want_y, want_state = ref.rwkv6_chunked(*xs, chunk=64)
    _close(y, want_y, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", [
    (2, 1, 2), (2, 37, 3), (1, 200, 2), (3, 256, 4),
    (4, 2048, 112),     # zamba2-7b prefill: Bt=4, H=112
    # T at the borders of the kernel's 32-row chunks and the wrapper's chunk of 128
    *((2, t, 3) for t in (15, 16, 17, 33, 63, 65, 127, 129, 2049)),
])
def test_ssd_kernel_matches_plain(cuda, b, t, h):
    xs = _ssd_inputs(8, b, t, h, cuda)
    y, state = ssd_fwd(*xs)
    torch.cuda.synchronize()
    want_y, want_state = ref.mamba2_ssd(*xs, chunk=128)
    _close(y, want_y, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)


@pytest.mark.cuda
def test_scan_kernels_reject_what_they_do_not_take(cuda):
    xs = _wkv6_inputs(9, 1, 64, 2, cuda, d=48)
    with pytest.raises(ValueError, match="head size"):
        wkv6_fwd(*xs)
    xs = _wkv6_inputs(9, 1, 64, 2, cuda)
    with pytest.raises(ValueError, match="chunk"):
        wkv6_fwd(*xs, chunk=32)
    with pytest.raises(ValueError, match="fp32"):
        wkv6_fwd(*(x.double() for x in xs))
    xs = _ssd_inputs(9, 1, 64, 2, cuda, p=32)
    with pytest.raises(ValueError, match="not compiled"):
        ssd_fwd(*xs)
    x, dt, A, B, C, s = _ssd_inputs(9, 1, 64, 2, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B, C, s)


@pytest.mark.cuda
def test_scan_ops_on_cuda_launch_their_kernels(cuda, monkeypatch):
    monkeypatch.setattr(wkv6_fwd, "launches", 0)
    monkeypatch.setattr(ssd_fwd, "launches", 0)
    xs = _wkv6_inputs(10, 1, 100, 2, cuda)
    y, state = ops.wkv6(*xs)
    torch.cuda.synchronize()
    assert y.is_cuda and wkv6_fwd.launches == 1
    _close(y, ref.rwkv6_chunked(*xs)[0], SCAN_TOL)
    xs = _ssd_inputs(11, 1, 100, 2, cuda)
    y, state = ops.mamba2_ssd(*xs)
    torch.cuda.synchronize()
    assert y.is_cuda and ssd_fwd.launches == 1
    _close(state, ref.mamba2_ssd(*xs)[1], SCAN_TOL)


def _wkv6_strong(seed, b, t, h, device, d=64):
    """Decays spread down to the reference's 1e-30 clamp (w = e^-U(0, 69)), and w = 0
    in every 16th key column: a chunk's decay factors underflow."""
    r, k, v, w, u, s = _wkv6_inputs(seed, b, t, h, "cpu", d)
    w = torch.exp(-69.0 * torch.rand(w.shape, generator=torch.Generator().manual_seed(seed)))
    w[..., ::16] = 0.0
    return tuple(x.to(device) for x in (r, k, v, w, u, s))


def _ssd_strong(seed, b, t, h, device, p=64, n=64):
    """A scaled by 50: e^cl and the pairwise decays underflow within a chunk."""
    x, dt, A, B, C, s = _ssd_inputs(seed, b, t, h, "cpu", p, n)
    return tuple(a.to(device) for a in (x, dt, A * 50.0, B, C, s))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 300])
def test_wkv6_kernel_with_strong_decays(cuda, t):
    xs = _wkv6_strong(50 + t, 2, t, 3, cuda)
    y, state = wkv6_fwd(*xs)
    torch.cuda.synchronize()
    want_y, want_state = ref.rwkv6_chunked(*xs, chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    _close(y, want_y, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 300])
def test_ssd_kernel_with_decays_that_underflow(cuda, t):
    xs = _ssd_strong(60 + t, 2, t, 3, cuda)
    y, state = ssd_fwd(*xs)
    torch.cuda.synchronize()
    want_y, want_state = ref.mamba2_ssd(*xs, chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    _close(y, want_y, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_scan_kernel_reruns_are_bit_identical(cuda, scan):
    """No atomics and a fixed order of every sum."""
    kernel, xs = ((wkv6_fwd, _wkv6_inputs(70, 2, 1000, 4, cuda)) if scan == "wkv6"
                  else (ssd_fwd, _ssd_inputs(71, 2, 1000, 4, cuda)))
    first = kernel(*xs)
    for _ in range(2):
        assert all(torch.equal(a, b) for a, b in zip(first, kernel(*xs)))


@pytest.mark.cuda
def test_scan_kernels_run_on_the_tensor_cores(cuda):
    """Every kernel of both scans, forward and backward, that computes products issues
    mma.sync or wgmma (HMMA/HGMMA, TF32), and none spills (the backward's sums over
    partials have no products)."""
    for source, kernels in (("rwkv6_scan", ("wkv6_state_kernel", "wkv6_out_kernel")),
                            ("mamba2_ssd", ("ssd_gram_kernel", "ssd_scan_kernel")),
                            ("rwkv6_scan_bwd", ("wkv6_bwd_state_kernel", "wkv6_bwd_chunk_kernel")),
                            ("mamba2_ssd_bwd", ("ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel"))):
        counts, usage = _build.sass_counts(source), _build.ptxas_usage(source)
        for kernel in kernels:
            names = [n for n in counts if kernel in n]
            assert names, f"{kernel} not in {source}'s library"
            assert sum(counts[n]["HMMA"] + counts[n]["HGMMA"] for n in names) > 0, kernel
            assert all(usage.get(n, {}).get("spill_stores", 0) == 0 for n in names), usage
        assert all(u.get("spill_stores", 0) == 0 for u in usage.values()), usage


@pytest.mark.cuda
def test_scan_bwd_kernels_hold_their_blocks_per_sm(cuda):
    """The backward kernels' designs count on their occupancy (``<name>_occupancy`` in
    each source, at each compiled size): both reverse state passes and K4-bwd's chunk
    pass hold two blocks an SM, K3-bwd's chunk pass, whose head tiles are
    double-buffered in 230.7 KB, one; an uncompiled size is refused."""
    for name, source, sizes, blocks in (
            ("wkv6_bwd", "rwkv6_scan_bwd", ((64,), (32,)), {0: 2, 1: 2}),
            ("ssd_bwd", "mamba2_ssd_bwd", ((64, 64), (32, 16)), {0: 2, 1: 1})):
        fn = getattr(_build.load(source), f"{name}_occupancy")
        fn.argtypes = [ctypes.c_int] * (1 + len(sizes[0])) + [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
        for size in sizes:
            for kernel, want in blocks.items():
                vals = [ctypes.c_int() for _ in range(3)]
                assert fn(*size, kernel, *(ctypes.byref(v) for v in vals)) == 0
                assert vals[2].value >= want, (name, size, kernel, [v.value for v in vals])
        vals = [ctypes.c_int() for _ in range(3)]
        assert fn(*(48,) * len(sizes[0]), 0, *(ctypes.byref(v) for v in vals)) != 0


def _offset_copy(x):
    """A contiguous copy of x whose storage starts one float past a 16-byte boundary."""
    out = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:].view(x.shape)
    return out.copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_scan_kernels_reject_unaligned_views(cuda, scan):
    """The kernels load 16 bytes at a time (cp.async) and the state two floats at a time:
    a contiguous view at a 4-byte offset is refused, for every input, and the card
    stays usable."""
    kernel, plain, xs = ((wkv6_fwd, ref.rwkv6_chunked, _wkv6_inputs(90, 1, 100, 2, cuda))
                         if scan == "wkv6" else
                         (ssd_fwd, ref.mamba2_ssd, _ssd_inputs(91, 1, 100, 2, cuda)))
    for i in range(len(xs)):
        shifted = list(xs)
        shifted[i] = _offset_copy(xs[i])
        assert shifted[i].is_contiguous() and shifted[i].data_ptr() % 16 == 4
        with pytest.raises(ValueError, match="16-byte-aligned"):
            kernel(*shifted)
    for got, want in zip(kernel(*xs), plain(*xs)):
        _close(got, want, SCAN_TOL)


# ---------------------------------------------------------------- scan backward

SCANS = {"wkv6": (wkv6_fwd, wkv6_bwd, ref.rwkv6_chunked_bwd),
         "ssd": (ssd_fwd, ssd_bwd, ref.mamba2_ssd_bwd)}


def _bwd_case(scan, xs, ds_out=True, seed=0):
    """The backward kernel's and the plain backward's gradients for random
    cotangents of y (x's or v's shape) and of the final state (or none)."""
    fwd, bwd, plain = SCANS[scan]
    state = xs[5]
    gen = torch.Generator().manual_seed(seed)
    dy = torch.randn(xs[2 if scan == "wkv6" else 0].shape, generator=gen).to(state.device)
    ds = torch.randn(state.shape, generator=gen).to(state.device) * 0.5 if ds_out else None
    _, _, states = fwd(*xs, chunk_states=True)
    got = bwd(*xs[:5], states, dy, ds)
    torch.cuda.synchronize()
    return got, plain(*xs, dy, ds), (states, dy, ds)


def _close_grads(got, want, xs, w_index=None):
    """Each gradient against the plain one within SCAN_TOL of 1 + |want|; with
    ``w_index``, that input's gradient as w * dw (strong decays: dw = dlog w / w
    carries the rounding of dlog w times up to 1e30)."""
    for i, (a, b, x) in enumerate(zip(got, want, xs)):
        assert a.shape == x.shape and a.dtype == x.dtype and torch.isfinite(a).all(), i
        if i == w_index:
            a, b = a * x, b * x
        _close(a, b, SCAN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,ds_out", [
    (2, 1, 2, True), (2, 37, 3, True), (1, 200, 2, True), (2, 128, 3, False),
    (2, 2048, 32, True),       # rwkv6-1.6b's training shape: B=2, H=32
    *((2, t, 3, True) for t in (63, 65, 129, 1000)),
])
def test_wkv6_bwd_kernel_matches_plain(cuda, b, t, h, ds_out):
    xs = _wkv6_inputs(80 + t, b, t, h, cuda)
    got, want, _ = _bwd_case("wkv6", xs, ds_out, seed=t)
    _close_grads(got, want, xs)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,ds_out", [
    (2, 1, 2, True), (2, 37, 3, True), (1, 200, 2, True), (2, 256, 9, False),
    (2, 2048, 112, True),      # zamba2-7b's training shape: Bt=2, H=112
    *((2, t, 11, True) for t in (63, 65, 129, 1000)),   # 11 heads: a partial group of 8
])
def test_ssd_bwd_kernel_matches_plain(cuda, b, t, h, ds_out):
    xs = _ssd_inputs(90 + t, b, t, h, cuda)
    got, want, _ = _bwd_case("ssd", xs, ds_out, seed=t)
    _close_grads(got, want, xs)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", [
    (2, 1, 4), (2, 32, 4),     # launch.train's reduced rwkv6-1.6b: 4 heads of 32, T=32
    (2, 37, 4), (1, 200, 4), (2, 1000, 4), (2, 2049, 4), (2, 129, 5),
])
def test_wkv6_kernels_at_the_reduced_head_size(cuda, b, t, h):
    """K4 and K4-bwd at K = V = 32 (rwkv6-1.6b's reduced config), against the plain
    forward and backward, and with decays down to the 1e-30 clamp."""
    xs = _wkv6_inputs(150 + t, b, t, h, cuda, d=32)
    y, state = wkv6_fwd(*xs)
    torch.cuda.synchronize()
    for a, w in zip((y, state), ref.rwkv6_chunked(*xs, chunk=64)):
        _close(a, w, SCAN_TOL)
    got, want, _ = _bwd_case("wkv6", xs, seed=t)
    _close_grads(got, want, xs)
    xs = _wkv6_strong(160 + t, b, t, h, cuda, d=32)
    got, want, _ = _bwd_case("wkv6", xs, seed=t)
    _close_grads(got, want, xs, w_index=3)
    assert (got[3][xs[3] < 1e-30] == 0).all()
    for a, w in zip(wkv6_fwd(*xs), ref.rwkv6_chunked(*xs, chunk=64)):
        _close(a, w, SCAN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h", [
    (2, 1, 8), (2, 32, 8),     # launch.train's reduced zamba2-7b: 8 heads of 32, N=16
    (2, 33, 8), (1, 200, 8), (2, 1000, 8), (2, 129, 11), (2, 2049, 3),
])
def test_ssd_kernels_at_the_reduced_sizes(cuda, b, t, h):
    """K3 and K3-bwd at (P, N) = (32, 16) (zamba2-7b's reduced config), against the plain
    forward and backward, with a head count that is not a multiple of the backward's
    group of 8, and with decays that underflow within a chunk."""
    for xs in (_ssd_inputs(170 + t, b, t, h, cuda, p=32, n=16),
               _ssd_strong(180 + t, b, t, h, cuda, p=32, n=16)):
        y, state = ssd_fwd(*xs)
        torch.cuda.synchronize()
        for a, w in zip((y, state), ref.mamba2_ssd(*xs, chunk=128)):
            _close(a, w, SCAN_TOL)
        got, want, _ = _bwd_case("ssd", xs, seed=t)
        _close_grads(got, want, xs)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_launchers_run_the_reduced_ssm_configs_on_the_card(cuda, arch, monkeypatch,
                                                           tmp_path):
    """``launch.train`` and ``launch.serve`` on the card take the reference's reduced
    config (scan head 32; zamba2-7b's SSD state 16) through the scan kernels: their
    forward and backward launches rise, and the trained config is the reduced one."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    monkeypatch.chdir(tmp_path)
    fwd, bwd = (wkv6_fwd, wkv6_bwd) if arch == "rwkv6-1.6b" else (ssd_fwd, ssd_bwd)
    monkeypatch.setattr(fwd, "launches", 0)
    monkeypatch.setattr(bwd, "launches", 0)
    trainer = launch_train.main(["--arch", arch, "--steps", "3", "--ckpt-every", "1",
                                 "--crash-at", "2"])
    assert trainer.cfg == get_arch(arch).reduced()
    assert trainer.cfg.ssm_head_dim == 32 and trainer.step == 3
    assert all(math.isfinite(h["loss"]) for h in trainer.history)
    assert fwd.launches >= 2 * trainer.cfg.n_layers and bwd.launches >= trainer.cfg.n_layers
    before = fwd.launches
    launch_serve.main(["--arch", arch, "--requests", "2", "--max-new", "3"])
    assert fwd.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 300])
def test_scan_bwd_kernels_with_strong_decays(cuda, t):
    """dw is exactly 0 where w < 1e-30, the forward's clamp, and w * dw agrees."""
    xs = _wkv6_strong(100 + t, 2, t, 3, cuda)
    got, want, _ = _bwd_case("wkv6", xs, seed=t)
    _close_grads(got, want, xs, w_index=3)
    clamped = xs[3] < 1e-30
    assert clamped.any() and (got[3][clamped] == 0).all()
    xs = _ssd_strong(110 + t, 2, t, 3, cuda)
    got, want, _ = _bwd_case("ssd", xs, seed=t)
    _close_grads(got, want, xs)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_scan_bwd_kernel_reruns_are_bit_identical(cuda, scan):
    """No atomics and a fixed order of every sum, the head sums of dB and dC too."""
    xs = (_wkv6_inputs(120, 2, 1000, 4, cuda) if scan == "wkv6"
          else _ssd_inputs(121, 2, 1000, 20, cuda))
    got, _, (states, dy, ds) = _bwd_case(scan, xs)
    again = SCANS[scan][1](*xs[:5], states, dy, ds)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_scan_bwd_kernels_reject_what_they_do_not_take(cuda, scan):
    """Unaligned and strided inputs, a wrong state shape and an uncompiled chunk are
    refused before a launch; the card stays usable."""
    xs = (_wkv6_inputs(130, 1, 100, 2, cuda) if scan == "wkv6"
          else _ssd_inputs(131, 1, 100, 2, cuda))
    fwd, bwd, plain = SCANS[scan]
    _, _, states = fwd(*xs, chunk_states=True)
    dy = torch.randn(xs[0].shape[:3] + (64,), device=cuda)
    args = [*xs[:5], states, dy]
    for i in range(len(args)):
        shifted = list(args)
        shifted[i] = _offset_copy(args[i])
        with pytest.raises(ValueError, match="16-byte-aligned"):
            bwd(*shifted)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(*args[:6], dy.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="chunk states"):
        bwd(*args[:5], states[:, :1], dy)
    with pytest.raises(ValueError, match="chunk"):
        bwd(*args, None, 32)
    with pytest.raises(ValueError, match="fp32"):
        bwd(*args[:6], dy.double())
    for a, b in zip(bwd(*args), plain(*xs, dy)):
        _close(a, b, SCAN_TOL)


@pytest.mark.cuda
def test_scan_ops_backward_on_cuda_launch_their_kernels(cuda, monkeypatch):
    """Autograd through ops.wkv6 / ops.mamba2_ssd on the card: one forward and one
    backward launch each, a strided incoming gradient made aligned, no gradient for
    an initial state that does not need one, and the final state's unread."""
    for fn in (wkv6_fwd, wkv6_bwd, ssd_fwd, ssd_bwd):
        monkeypatch.setattr(fn, "launches", 0)
    for op, plain, xs in ((ops.wkv6, ref.rwkv6_chunked, _wkv6_inputs(140, 2, 150, 3, cuda)),
                          (ops.mamba2_ssd, ref.mamba2_ssd, _ssd_inputs(141, 2, 150, 3, cuda))):
        leaves = [x.clone().requires_grad_() for x in xs[:5]]
        y, _ = op(*leaves, xs[5])
        co = torch.randn(y.shape[:2] + (y.shape[3], y.shape[2]), device=cuda).transpose(2, 3)
        got = torch.autograd.grad((y * co).sum(), leaves)
        cpu = [x.detach().cpu().requires_grad_() for x in xs[:5]]
        want = torch.autograd.grad((plain(*cpu, xs[5].cpu())[0] * co.cpu()).sum(), cpu)
        for a, b in zip(got, want):
            _close(a.cpu(), b, SCAN_TOL)
    assert (wkv6_fwd.launches, wkv6_bwd.launches, ssd_fwd.launches, ssd_bwd.launches) == (1,) * 4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_ssm_and_hybrid_loss_and_grads_on_cuda(cuda, arch, monkeypatch):
    """fp32 reduced rwkv6 / zamba2 at the full configs' scan sizes of 64 (zamba2 with 7
    layers: a tail after its 3 sites): the loss and every gradient leaf on the card
    (scans forward twice a layer with the recompute, backward once) within 2e-3 of
    their largest value against the CPU's plain path."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt
    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, d_model=256, ssm_head_dim=64,
                              **({"ssm_state": 64, "n_layers": 7} if arch == "zamba2-7b" else {}))
    api = get_model(cfg)
    params = api.init(0, torch.float32, cuda)
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (2, 161), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fwd, bwd = (wkv6_fwd, wkv6_bwd) if arch == "rwkv6-1.6b" else (ssd_fwd, ssd_bwd)
    monkeypatch.setattr(fwd, "launches", 0)
    monkeypatch.setattr(bwd, "launches", 0)
    results = []
    for dev in (cuda, torch.device("cpu")):
        pairs = [(path, p.detach().to(dev).requires_grad_())
                 for path, p in opt.flatten_with_paths(params)]
        loss = api.loss(opt.unflatten(pairs), {k: v.to(dev) for k, v in batch.items()})
        results.append((loss.detach().cpu(), [g.cpu() for g in torch.autograd.grad(
            loss, [p for _, p in pairs])]))
    assert (fwd.launches, bwd.launches) == (2 * cfg.n_layers, cfg.n_layers)
    (loss_k, grads_k), (loss_p, grads_p) = results
    _close(loss_k, loss_p, 1e-4)
    for a, b in zip(grads_k, grads_p):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max().clamp(min=1e-30))


# ---------------------------------------------------------------- flash backward

def _bwd_inputs(seed, b, tq, tk, kv, g, hd, dtype, device, window, q_offset):
    q, k, v = _inputs(seed, b, tq, tk, kv, g, hd, dtype, device)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(seed + 1))
    do = do.to(dtype).to(device)
    out, lse = flash_attention_fwd(q, k, v, window=window, q_offset=q_offset)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,kv,g,hd,window,q_offset,dtype", [
    (2, 128, 128, 2, 1, 32, 0, 0, torch.float32),
    (2, 200, 200, 2, 2, 64, 0, 0, torch.float32),
    (1, 300, 300, 2, 2, 128, 0, 0, torch.float32),
    (1, 1000, 1000, 2, 2, 64, 256, 0, torch.float32),    # window, ragged T
    (1, 77, 300, 2, 2, 64, 100, 223, torch.float32),     # q_offset and window
    (2, 333, 333, 4, 1, 128, 0, 0, torch.bfloat16),
    (1, 64, 192, 1, 2, 128, 0, 128, torch.bfloat16),     # q is a suffix
    (2, 250, 250, 2, 1, 112, 0, 0, torch.bfloat16),
    (2, 96, 96, 2, 2, 32, 40, 0, torch.bfloat16),
    (1, 512, 512, 4, 1, 64, 0, 0, torch.bfloat16),       # minicpm-2b's head dim
    (3, 5, 5, 1, 1, 32, 0, 0, torch.float32),            # smaller than one tile
    # bf16 runs the tensor-core kernels, fp32 the SIMT ones: bf16 twins of the fp32 cases
    (2, 200, 200, 2, 2, 64, 0, 0, torch.bfloat16),
    (1, 300, 300, 2, 2, 128, 0, 0, torch.bfloat16),
    (1, 1000, 1000, 2, 2, 64, 256, 0, torch.bfloat16),
    (1, 77, 300, 2, 4, 64, 100, 223, torch.bfloat16),
    (2, 1, 50, 2, 2, 64, 0, 49, torch.bfloat16),
    (1, 130, 130, 1, 1, 128, 1, 0, torch.bfloat16),
    (3, 5, 5, 1, 1, 32, 0, 0, torch.bfloat16),
    # the group sizes the trained attention archs give K1-bwd at hd 128: phi3-medium-14b
    # (40 heads over 10), mixtral-8x22b (48 over 8), arctic-480b (56 over 8, at a ragged
    # T) and chameleon-34b (64 over 8)
    (1, 1024, 1024, 10, 4, 128, 0, 0, torch.bfloat16),
    (1, 1024, 1024, 8, 6, 128, 0, 0, torch.bfloat16),
    (1, 1100, 1100, 8, 7, 128, 0, 0, torch.bfloat16),
    (1, 1024, 1024, 8, 8, 128, 0, 0, torch.bfloat16),
])
def test_flash_bwd_kernel_matches_plain(cuda, b, tq, tk, kv, g, hd, window, q_offset,
                                        dtype):
    q, k, v, out, lse, do = _bwd_inputs(20, b, tq, tk, kv, g, hd, dtype, cuda, window,
                                        q_offset)
    got = flash_attention_bwd(q, k, v, out, lse, do, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    want = ref._flash_bwd_impl(q, k, v, lse, do, q_offset, window, 512, 1024)
    for a, w, x in zip(got, want, (q, k, v)):
        assert a.dtype == x.dtype and a.shape == x.shape
        _close(a, w, TOL[dtype])
    again = flash_attention_bwd(q, k, v, out, lse, do, window=window, q_offset=q_offset)
    for a, a2 in zip(got, again):                   # no atomics: bit-identical reruns
        assert torch.equal(a, a2)


@pytest.mark.cuda
def test_flash_bwd_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, out, lse, do = _bwd_inputs(21, 1, 64, 64, 2, 1, 64, torch.float32, cuda, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bwd(q, k, v, out, lse, do.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, out, lse[..., :32], do)
    with pytest.raises(ValueError, match="shape, dtype"):
        flash_attention_bwd(q, k, v, out.bfloat16(), lse, do)
    q, k, v = _inputs(21, 1, 64, 64, 2, 1, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q, k, v, q, lse, q)


@pytest.mark.cuda
def test_ops_flash_backward_on_cuda_launches_the_kernel(cuda, monkeypatch):
    monkeypatch.setattr(flash_attention_fwd, "launches", 0)
    monkeypatch.setattr(flash_attention_bwd, "launches", 0)
    q, k, v = (x.requires_grad_() for x in _inputs(22, 1, 100, 100, 2, 2, 64,
                                                   torch.float32, cuda))
    co = torch.randn(q.shape, device=cuda)
    grads = torch.autograd.grad((ops.flash_attention(q, k, v) * co).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == 1 and flash_attention_bwd.launches == 1
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad((ref.flash_attention(*xs) * co).sum(), xs)
    for a, w in zip(grads, want):
        _close(a, w, TOL[torch.float32])


# ---------------------------------------------------------------- checksum

@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 1000, 4096, 10000, 1 << 20])
def test_checksum_kernel_matches_plain_bit_for_bit(cuda, n):
    gen = torch.Generator().manual_seed(n)
    words = torch.randint(-2 ** 31, 2 ** 31, (n,), dtype=torch.int64, generator=gen)
    words = words.to(torch.int32)
    want = ref.checksum(words, block=512)
    for x in (words, words.view(torch.uint32)):
        got = checksum_kernel(x.to(cuda), block=4096)
        assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)
    if n > 8:       # not 16-byte aligned: the scalar head and tail paths
        assert torch.equal(checksum_kernel(words.to(cuda)[1:]).cpu(),
                           ref.checksum(words[1:]))
        corrupted = words.clone()
        corrupted[n // 2] ^= 1
        assert not torch.equal(checksum_kernel(corrupted.to(cuda)).cpu(), want)


@pytest.mark.cuda
def test_checksum_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="int32 or uint32"):
        checksum_kernel(torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="1-D"):
        checksum_kernel(torch.zeros((2, 4), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="1-D contiguous"):
        checksum_kernel(torch.zeros(8, dtype=torch.int32, device=cuda)[::2])


@pytest.mark.cuda
def test_ops_checksum_on_cuda_launches_the_kernel(cuda, monkeypatch):
    monkeypatch.setattr(checksum_kernel, "launches", 0)
    x = torch.randn(4097, device=cuda).view(torch.int32)
    got = ops.tensor_checksum(x)
    assert checksum_kernel.launches == 1
    assert torch.equal(got.cpu(), ref.checksum(x.cpu()))


# ---------------------------------------------------------------- trainer, checkpoints, MoE

def _trainer(root, device, base="/ckpt", ckpt_every=2):
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import write_dataset
    from repro_torch.storage.datapipe import ShardReader
    from repro_torch.storage.volume import LocalMount
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_arch("minicpm-2b").reduced()
    mnt = LocalMount(root)
    if not mnt.exists("/data"):
        write_dataset(mnt, cfg.vocab)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=2, total_steps=10)
    reader = ShardReader(mnt, "/data", rank=0, world=1, batch=2, seq_len=64)
    return Trainer(cfg, oc, TrainerConfig(ckpt_every=ckpt_every, ckpt_base=base), mnt, reader,
                   seed=0, param_dtype=torch.bfloat16, device=device)


def _state_equal(a, b):
    from repro_torch.train import optimizer as opt
    pa = list(opt.flatten_with_paths({k: v for k, v in a.items() if v is not None}))
    pb = list(opt.flatten_with_paths({k: v for k, v in b.items() if v is not None}))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(pa, pb))


@pytest.mark.cuda
def test_trainer_crash_and_resume_on_cuda_is_bit_exact(cuda, tmp_path, monkeypatch):
    """Reduced minicpm-2b in bf16 on the card: 5 steps straight, against 4 steps
    with a checkpoint at 2 and a crash after 3, then a resume from 2.  The flash
    kernels run forward and backward, and reruns are bit-identical."""
    monkeypatch.setattr(flash_attention_bwd, "launches", 0)
    whole = _trainer(tmp_path, cuda, base="/whole", ckpt_every=100)
    whole.train(5)
    assert flash_attention_bwd.launches == 5 * whole.cfg.n_layers
    crashed = _trainer(tmp_path, cuda)
    with pytest.raises(RuntimeError, match="injected trainer crash at step 3"):
        crashed.train(5, crash_at=3)
    resumed = _trainer(tmp_path, cuda)
    assert resumed.resume() and resumed.step == 2
    assert resumed.params["layers"]["mlp"]["w1"].is_cuda
    resumed.train(3)
    assert resumed.step == 5
    assert _state_equal(resumed.state_tree(), whole.state_tree())
    assert resumed.history == whole.history[2:]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "rwkv6-1.6b", "zamba2-7b"])
def test_launch_train_crash_and_resume_on_cuda(cuda, capsys, arch, monkeypatch):
    """The training launcher on the card, every family, each run on a CFS
    cluster of its own: a crash after step 3 and a resume from the step-2
    checkpoint match a straight run bit for bit (rwkv6 and zamba2 train through
    the scans' backward kernels, at their head size of 64; 5 steps straight, 3
    crashed and 3 resumed: 11 backward launches a layer)."""
    from repro_torch.launch import train as launch_train
    for fn in (wkv6_bwd, ssd_bwd):
        monkeypatch.setattr(fn, "launches", 0)
    common = ["--device", "cuda", "--steps", "5", "--ckpt-every", "2", "--seq", "64",
              "--arch", arch]
    whole = launch_train.main(common)
    resumed = launch_train.main(common + ["--crash-at", "3"])
    out = capsys.readouterr().out
    assert "injected trainer crash at step 3" in out and "resumed at step 2" in out
    assert resumed.history == whole.history[2:]
    assert _state_equal(resumed.state_tree(), whole.state_tree())
    L = whole.cfg.n_layers
    assert (wkv6_bwd.launches, ssd_bwd.launches) == {
        "minicpm-2b": (0, 0), "rwkv6-1.6b": (11 * L, 0), "zamba2-7b": (0, 11 * L)}[arch]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_launch_serve_ssm_and_hybrid_on_cuda(cuda, capsys, arch):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--device", "cuda", "--arch", arch, "--requests", "3",
                       "--max-new", "3"])
    assert "served 3 requests" in capsys.readouterr().out


@pytest.mark.cuda
def test_checkpoint_of_cuda_tensors_restores_onto_cuda(cuda, tmp_path):
    from repro_torch.storage.checkpoint import CheckpointManager
    from repro_torch.storage.volume import LocalMount
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn((6, 5), generator=gen, device=cuda).to(torch.bfloat16),
            "m": {"a": torch.randn((4, 3, 2), generator=gen, device=cuda)},
            "step": torch.tensor(9, dtype=torch.int32, device=cuda)}
    cm = CheckpointManager(LocalMount(tmp_path), "/ck", shards=2)
    cm.save(9, tree)
    like = {"w": torch.zeros_like(tree["w"]), "m": {"a": torch.zeros_like(tree["m"]["a"])},
            "step": torch.zeros_like(tree["step"])}
    got, step = cm.restore(like)
    assert step == 9 and got["w"].is_cuda and got["w"].dtype == torch.bfloat16
    assert _state_equal(got, tree)
    on_cpu, _ = cm.restore({"w": torch.zeros((6, 5), dtype=torch.bfloat16),
                            "m": {"a": torch.zeros((4, 3, 2))},
                            "step": torch.zeros((), dtype=torch.int32)})
    assert _state_equal(on_cpu, {k: v.cpu() if torch.is_tensor(v) else
                                 {n: w.cpu() for n, w in v.items()} for k, v in tree.items()})


@pytest.mark.cuda
def test_reduced_mixtral_serves_on_cuda(cuda, monkeypatch):
    """fp32 reduced mixtral, a prompt past its 64-token window: one windowed
    flash launch per layer a wave, logits within 2e-3 of the CPU's plain path."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.serve.server import BatchServer, Request
    cfg = get_arch("mixtral-8x22b").reduced()
    api = get_model(cfg)
    params = api.init(0, torch.float32, cuda)
    monkeypatch.setattr(flash_attention_fwd, "launches", 0)
    reqs = [Request(rid=i, prompt=[(5 * i + j) % cfg.vocab for j in range(n)], max_new=6)
            for i, n in enumerate((90, 7, 70))]
    done = BatchServer(cfg, params, batch=2, smax=128, device=cuda).serve(reqs)
    assert flash_attention_fwd.launches == 2 * cfg.n_layers
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out) == 6 and all(0 <= t < cfg.vocab for t in r.out) for r in done)
    toks = torch.tensor([reqs[0].prompt], device=cuda)
    got, _ = api.prefill(params, toks, 128)
    cpu_params = {k: (v.cpu() if torch.is_tensor(v) else
                      {n: (w.cpu() if torch.is_tensor(w) else {m: x.cpu() for m, x in w.items()})
                       for n, w in v.items()}) for k, v in params.items()}
    want, _ = get_model(dataclasses.replace(cfg)).prefill(cpu_params, toks.cpu(), 128)
    _close(got.cpu(), want, TOL[torch.float32])


# ------------------------------------------------------- the mesh paths on one NCCL rank

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A world of one NCCL rank (rendezvous file, no network) and its 1 x 1
    ("data", "model") mesh, for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    init_process_group(str(tmp_path_factory.mktemp("pg") / "pg"), 0, 1, "nccl")
    yield make_host_mesh(1, 1, "cuda")
    dist.destroy_process_group()


def _mesh_train(cfg, params, oc, batches, mesh=None):
    from repro_torch.parallel import sharding as shd
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    if mesh is None:
        state = opt.init_opt_state(oc, params)
    else:
        whole = params
        params = shd.distribute_tree(whole, shd.param_shardings(cfg, whole, mesh), mesh)
        state = opt.init_opt_state(oc, params, shd.opt_shardings(cfg, whole, mesh))
    step = make_train_step(cfg, oc)
    for b in batches:
        params, state, _ = step(params, state, b)
    return {path: (p.full_tensor() if mesh is not None else p)
            for path, p in opt.flatten_with_paths(params)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mesh_train_step_on_one_nccl_rank_equals_mesh_free(cuda, nccl_mesh, dtype, monkeypatch):
    """Reduced minicpm-2b, 2 steps on DTensor params and ZeRO-1 state against 2
    mesh-free steps from the same weights: every leaf bit for bit, and the
    flash kernels launched on the mesh path."""
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt
    cfg = get_arch("minicpm-2b").reduced()
    api = get_model(cfg)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=1)
    batches = [{"tokens": t, "labels": t.roll(-1, 1)} for t in
               (torch.randint(0, cfg.vocab, (2, 64), generator=torch.Generator().manual_seed(s))
                .to(cuda) for s in (1, 2))]
    want = _mesh_train(cfg, api.init(0, dtype, cuda), oc, batches)
    monkeypatch.setattr(flash_attention_fwd, "launches", 0)
    monkeypatch.setattr(flash_attention_bwd, "launches", 0)
    got = _mesh_train(cfg, api.init(0, dtype, cuda), oc, batches, nccl_mesh)
    assert flash_attention_fwd.launches == 2 * 2 * cfg.n_layers
    assert flash_attention_bwd.launches == 2 * cfg.n_layers
    for path, w in want.items():
        assert torch.equal(got[path], w), path


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ep_moe_on_one_nccl_rank_equals_local(cuda, nccl_mesh, arch, dtype):
    """moe_block under a 1 x 1 mesh takes moe_block_shard_map (all experts on
    the rank), against the local dispatch in groups = dp = 1, with arctic's
    dense residual: tokens drop at the default capacity factor."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers, moe
    from repro_torch.parallel import ctx
    cfg = get_arch(arch).reduced()
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = moe.init_moe_block(cfg, gen, dtype)
    mlp = layers.init_mlp(cfg.d_model, cfg.d_ff, gen, dtype) if cfg.dense_residual else None
    x = (torch.randn((2, 48, cfg.d_model), generator=gen, device=cuda)
         + torch.randn(cfg.d_model, generator=gen, device=cuda)).to(dtype)
    want = moe.moe_block(cfg, p, x, groups=1, mlp=mlp)
    with ctx.mesh_context(nccl_mesh):
        got = moe.moe_block(cfg, p, x, mlp=mlp)
    _close(got, want, TOL[dtype] if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.cuda
def test_compress_on_cuda_matches_cpu_bit_for_bit(cuda):
    from repro_torch.parallel import compress
    gen = torch.Generator().manual_seed(4)
    grads = {"a": torch.randn((3, 1000), generator=gen).to(torch.bfloat16),
             "b": torch.randn(70_001, generator=gen)}
    noise = [compress.noise_like(g.numel(), gen) for g in (grads["a"], grads["b"])]
    res_c = res_g = None
    for _ in range(2):
        out_c, res_c = compress.compress_tree(grads, res_c, noise)
        out_g, res_g = compress.compress_tree({k: v.to(cuda) for k, v in grads.items()}, res_g,
                                              [n.to(cuda) for n in noise])
        for k in grads:
            assert torch.equal(out_g[k].cpu(), out_c[k]) and torch.equal(res_g[k].cpu(), res_c[k])
    q_c, s_c = compress.quantize(grads["b"], noise[1])
    q_g, s_g = compress.quantize(grads["b"].to(cuda), noise[1].to(cuda))
    assert torch.equal(q_g.cpu(), q_c) and torch.equal(s_g.cpu(), s_c)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_dtensors_on_cuda(cuda, nccl_mesh):
    from repro_torch.parallel import sharding as shd
    q = shd.distribute(torch.zeros((1, 64, 2, 1, 64), device=cuda), (), nccl_mesh)
    kv = shd.distribute(torch.zeros((1, 64, 2, 64), device=cuda), (), nccl_mesh)
    words = shd.distribute(torch.zeros(64, dtype=torch.int32, device=cuda), (), nccl_mesh)
    with pytest.raises(TypeError, match="DTensor"):
        flash_attention_fwd(q, kv, kv)
    with pytest.raises(TypeError, match="DTensor"):
        ops.flash_attention(q, kv, kv)
    with pytest.raises(TypeError, match="DTensor"):
        checksum_kernel(words)
    with pytest.raises(TypeError, match="DTensor"):
        ops.tensor_checksum(words)
    q1 = shd.distribute(torch.zeros((1, 1, 2, 64), device=cuda, dtype=torch.bfloat16), (),
                        nccl_mesh)
    cache = shd.distribute(torch.zeros((1, 64, 2, 64), device=cuda, dtype=torch.bfloat16), (),
                           nccl_mesh)
    with pytest.raises(TypeError, match="DTensor"):
        decode_kernel(q1, cache, cache, 8)
    with pytest.raises(TypeError, match="DTensor"):
        ops.decode_attention(q1, cache, cache, 8)


# ------------------------------------------------------------------ the kernels' operators

def _op_calls(cuda):
    """(operator, wrapper, arguments) for each of the eight kernel operators, at small
    shapes the kernels take."""
    from repro_torch.kernels import mamba2_ssd, rwkv6_scan
    gen = torch.Generator().manual_seed(9)
    n = lambda *s: (torch.randn(s, generator=gen) * 0.5).to(cuda)  # noqa: E731
    q, k, v = _inputs(9, 2, 100, 100, 2, 2, 64, torch.bfloat16, cuda)
    out, lse = flash_attention_fwd(q, k, v)
    r, v6, st, u = n(2, 100, 4, 64), n(2, 100, 4, 64), n(2, 4, 64, 64), n(4, 64)
    w = torch.sigmoid(n(2, 100, 4, 64))
    _, _, w_states = wkv6_fwd(r, r, v6, w, u, st, 64, chunk_states=True)
    x, dt, A, Bm = n(2, 150, 4, 64), torch.nn.functional.softplus(n(2, 150, 4)), -n(4).abs(), n(2, 150, 64)
    _, _, s_states = ssd_fwd(x, dt, A, Bm, Bm, st, 128, chunk_states=True)
    o = torch.ops.repro_torch
    words = torch.randint(-2 ** 31, 2 ** 31 - 1, (1000,), generator=gen, dtype=torch.int32).to(cuda)
    return [
        (o.flash_attention_fwd, flash_attention_fwd, (q, k, v, 0, 0), {}),
        (o.flash_attention_bwd, flash_attention_bwd, (q, k, v, out, lse, q, 0, 0), {}),
        (o.wkv6_fwd, rwkv6_scan.wkv6_fwd, (r, r, v6, w, u, st, 64, True), {}),
        (o.wkv6_bwd, wkv6_bwd, (r, r, v6, w, u, w_states, v6, st, 64), {}),
        (o.ssd_fwd, mamba2_ssd.ssd_fwd, (x, dt, A, Bm, Bm, st, 128, False), {}),
        (o.ssd_bwd, ssd_bwd, (x, dt, A, Bm, Bm, s_states, x, st, 128), {}),
        (o.checksum, checksum_kernel, (words, 4096), {}),
        (o.decode_attention, decode_kernel, (q[:, -1:].reshape(2, 1, 4, 64).contiguous(), k, v,
                                             77), {}),
    ]


def _outs(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


@pytest.mark.cuda
def test_kernel_operators_launch_count_and_match_the_wrappers(cuda):
    """Each operator's real implementation is its wrapper: the same outputs, bit for
    bit, and one launch a call; its fake implementation gives the same shapes,
    dtypes and strides, and launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    for op, wrapper, args, _ in _op_calls(cuda):
        chunk_states = {torch.ops.repro_torch.wkv6_fwd: True,
                        torch.ops.repro_torch.ssd_fwd: False}
        if op in chunk_states:
            want = wrapper(*args[:-1], chunk_states=args[-1])
        else:
            want = wrapper(*args)
        before = wrapper.launches
        got = op(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, op
        assert all(torch.equal(a, b) for a, b in zip(_outs(got), _outs(want))), op
        with FakeTensorMode() as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                        for a in args))
        assert wrapper.launches == before + 1, op
        assert [(x.shape, x.dtype, x.stride(), x.device) for x in _outs(fake)] == \
            [(x.shape, x.dtype, x.stride(), x.device) for x in _outs(got)], op


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["minicpm-2b", "rwkv6-1.6b", "zamba2-7b"])
def test_counts_on_the_card_equal_fake_counts(cuda, arch, kind):
    """A reduced model's train step or prefill counted on the card (the kernels
    launch), on fake CUDA twins and on fake CPU twins through the kernels'
    operators (the dry run's lowering): the same flops and bytes, exactly, the
    lowering's peak of live bytes within 1%, and the fake lowerings launch nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    cfg = get_arch(arch).reduced()
    api = get_model(cfg)
    params = api.init(0, torch.bfloat16, "cuda")
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (2, 96), generator=gen).to(cuda)
    if kind == "train":
        oc = opt.opt_config_for(cfg, warmup_steps=2, total_steps=4)
        fn, args = make_train_step(cfg, oc), (params, opt.init_opt_state(oc, params),
                                              {"tokens": toks, "labels": toks.roll(-1, 1)})
    else:
        fn, args = (lambda p, x: api.prefill(p, x, 128)), (params, toks)

    def counted(a, device):
        count = roofline.Count(device)
        with torch.set_grad_enabled(kind == "train"), count:
            fn(*a)
        return count
    real = counted(args, "cuda")
    launched = [w.launches for w in (flash_attention_fwd, flash_attention_bwd, wkv6_fwd,
                                     wkv6_bwd, ssd_fwd, ssd_bwd)]
    with FakeTensorMode():
        fake = counted(dryrun.fake_twin(args, "cuda"), "cuda")
    with FakeTensorMode(), ops.kernel_path():
        lowered = counted(dryrun.fake_twin(args, "cpu"), "cpu")
    assert launched == [w.launches for w in (flash_attention_fwd, flash_attention_bwd,
                                             wkv6_fwd, wkv6_bwd, ssd_fwd, ssd_bwd)]
    work = lambda c: {k: v for k, v in c.totals().items() if k != "copy_bytes"}  # noqa: E731
    assert real.kernel_calls and dict(fake.kernel_calls) == dict(real.kernel_calls) \
        == dict(lowered.kernel_calls)
    assert work(fake) == work(real) and work(lowered) == work(real)
    # the dry run's memory column: its peak of live bytes within 1% of the card's
    # count (a copy that one run makes and the other does not may be live at the peak)
    peak = real.memory()["peak_bytes"]
    assert peak > 0 and abs(lowered.memory()["peak_bytes"] / peak - 1) <= 0.01


# ------------------------------------------------------ the decode kernel (K5)

def _decode_inputs(seed, b, smax, kv, g, hd, q_dtype, device, n_valid):
    """q [B,1,KV*G,hd] and a bf16 cache whose slots at or past n_valid hold NaN,
    with the cache's clean copy (zeros there) for the plain version."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, kv * g, hd), generator=gen).to(q_dtype).to(device)
    k, v = (torch.randn((b, smax, kv, hd), generator=gen).to(torch.bfloat16).to(device)
            for _ in range(2))
    clean = [x.clone() for x in (k, v)]
    for x, c in zip((k, v), clean):
        x[:, n_valid:] = float("nan")
        c[:, n_valid:] = 0
    return q, k, v, clean


@pytest.mark.cuda
@pytest.mark.parametrize("b,smax,kv,g,hd,n_valid,q_dtype", [
    (32, 2304, 36, 1, 64, 2100, torch.bfloat16),     # minicpm-2b's decode cell
    (32, 2304, 36, 1, 64, 2304, torch.bfloat16),
    (32, 2304, 36, 1, 64, 1, torch.bfloat16),
    (2, 700, 8, 8, 128, 333, torch.bfloat16),        # chameleon-34b: G 8, hd 128
    (2, 700, 8, 7, 128, 700, torch.bfloat16),        # arctic-480b: G 7
    (2, 4096, 8, 6, 128, 4000, torch.bfloat16),      # mixtral-8x22b: G 6, its 4096 window
    (3, 515, 10, 4, 128, 1, torch.bfloat16),         # phi3-medium-14b: G 4
    (3, 515, 10, 4, 128, 259, torch.float32),
    (4, 4096, 32, 1, 112, 1795, torch.bfloat16),     # zamba2-7b's shared block: hd 112
    (1, 300, 2, 1, 112, 300, torch.float32),
    (2, 300, 4, 1, 128, 97, torch.bfloat16),         # codeqwen1.5-7b: G 1, hd 128
    (1, 150, 1, 4, 32, 149, torch.bfloat16),         # the reduced configs: hd 32, G 4
    (1, 150, 1, 4, 32, 150, torch.float32),
    (1, 5000, 2, 2, 64, 4999, torch.float32),        # one row, many splits
])
def test_decode_kernel_matches_plain(cuda, b, smax, kv, g, hd, n_valid, q_dtype):
    """n_valid at 1, off every tile and split boundary, and at Smax; the slots
    past n_valid hold NaN, so a read of one would show in the output."""
    q, k, v, (kc, vc) = _decode_inputs(11, b, smax, kv, g, hd, q_dtype, cuda, n_valid)
    out = decode_kernel(q, k, v, n_valid)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out).all()
    want = ref.decode_attention(q.float(), kc.float(), vc.float(), n_valid)
    _close(out, want, TOL[q_dtype])


@pytest.mark.cuda
def test_decode_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, _ = _decode_inputs(12, 2, 64, 2, 2, 64, torch.bfloat16, cuda, 64)
    with pytest.raises(ValueError, match="n_valid"):
        decode_kernel(q, k, v, 65)
    with pytest.raises(ValueError, match="bf16 K/V cache"):
        decode_kernel(q, k.float(), v.float(), 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        decode_kernel(q.cpu(), k, v, 8)


@pytest.mark.cuda
def test_decode_step_launches_the_kernel_once_a_layer(cuda, monkeypatch):
    """minicpm-2b at full width and 4 of its 40 layers, bf16, on the card: one
    decode step after a prefill launches the decode kernel once a layer, and its
    logits match the same step with the plain version in the kernel's place
    (``ref.decode_attention`` in fp32, rounded to bf16) within the bf16 tolerance,
    closer than the model's plain path (the einsums, which round the scores and
    the probabilities to bf16: 0.047 off at most on an H100); the same step over
    an int8 cache launches none."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    cfg = dataclasses.replace(get_arch("minicpm-2b"), n_layers=4)
    api = get_model(cfg)
    params = api.init(0, torch.bfloat16, "cuda")
    gen = torch.Generator().manual_seed(13)
    toks = torch.randint(0, cfg.vocab, (2, 300), generator=gen).to(cuda)

    def fp32_version(q, k, v, n_valid):
        return ref.decode_attention(q.float(), k.float(), v.float(), n_valid).to(q.dtype)

    def err(a, b):
        return ((a.float() - b.float()).abs() / (1 + b.float().abs())).max().item()

    with torch.no_grad():
        _, cache = api.prefill(params, toks, 320)
        caches = [{name: x.clone() for name, x in cache.items()} for _ in range(2)]
        nxt = toks[:, -1:]
        monkeypatch.setattr(decode_kernel, "launches", 0)
        logits, _ = api.decode(params, nxt, cache, 300)
        torch.cuda.synchronize()
        assert decode_kernel.launches == cfg.n_layers
        with monkeypatch.context() as m:
            m.setattr(ops, "decode_attention", fp32_version)
            want, _ = api.decode(params, nxt, caches[0], 300)
            m.setattr(ops, "takes_decode_attention", lambda q, c: False)
            plain, _ = api.decode(params, nxt, caches[1], 300)
        assert decode_kernel.launches == cfg.n_layers
        _close(logits, want, TOL[torch.bfloat16])
        assert err(logits, want) <= err(plain, want)
        _, cache8 = api.prefill(params, toks, 320, "int8")
        api.decode(params, nxt, cache8, 300)
        assert decode_kernel.launches == cfg.n_layers


# ------------------------------------------------------------------ Zamba2-7B's sizes

ZAMBA2_SCALE = (224 / 2) ** -0.5    # the published shared block's softmax scale


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,kv,g,window,q_offset,dtype,scale", [
    (2, 300, 300, 4, 1, 0, 0, torch.bfloat16, ZAMBA2_SCALE),
    (1, 200, 260, 2, 2, 64, 60, torch.bfloat16, ZAMBA2_SCALE),   # window, offset, G 2
    (2, 130, 130, 2, 1, 0, 0, torch.bfloat16, None),             # the default scale
    (1, 70, 70, 2, 1, 0, 0, torch.float32, ZAMBA2_SCALE),
    (1, 77, 300, 2, 2, 100, 223, torch.float32, None),
])
def test_flash_kernel_at_head_dim_224(cuda, b, tq, tk, kv, g, window, q_offset, dtype, scale):
    """Zamba2-7B's shared block: heads of 224 (bf16 on the tensor cores in 32-column
    panels and 64-key tiles, fp32 on the CUDA cores), with its softmax scale."""
    q, k, v = _inputs(21, b, tq, tk, kv, g, 224, dtype, cuda)
    out, lse = flash_attention_fwd(q, k, v, window=window, q_offset=q_offset, scale=scale)
    torch.cuda.synchronize()
    want, want_lse = ref._flash_fwd_impl(q, k, v, q_offset, window, 512, 1024, scale)
    _close(out, want, TOL[dtype])
    _close(lse, want_lse, 2e-3)


@pytest.mark.cuda
def test_head_dim_224_and_a_scale_have_a_forward_only(cuda):
    q, k, v = _inputs(22, 1, 64, 64, 2, 1, 224, torch.bfloat16, cuda)
    out, lse = flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q, k, v, out, lse, out)
    with pytest.raises(ValueError, match="scale"):
        flash_attention_fwd(q, k, v, scale=0.0)
    q, k, v = _inputs(22, 1, 64, 64, 2, 1, 64, torch.bfloat16, cuda)
    out = ops.flash_attention(q.requires_grad_(), k, v, scale=0.1)
    with pytest.raises(NotImplementedError, match="scale"):
        out.sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("b,smax,kv,g,n_valid,q_dtype,scale", [
    (32, 2304, 32, 1, 2100, torch.bfloat16, ZAMBA2_SCALE),   # the Zamba2-7B decode cell
    (32, 2304, 32, 1, 1, torch.bfloat16, ZAMBA2_SCALE),
    (2, 300, 4, 2, 300, torch.float32, ZAMBA2_SCALE),        # several splits, G 2
    (2, 300, 4, 1, 150, torch.bfloat16, None),
])
def test_decode_kernel_at_head_dim_224(cuda, b, smax, kv, g, n_valid, q_dtype, scale):
    q, k, v, (kc, vc) = _decode_inputs(23, b, smax, kv, g, 224, q_dtype, cuda, n_valid)
    out = decode_kernel(q, k, v, n_valid, scale)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    want = ref.decode_attention(q.float(), kc.float(), vc.float(), n_valid, scale)
    _close(out, want, TOL[q_dtype])


def _grouped_ssd_inputs(seed, b, t, h, groups, device):
    x, dt, A, _, _, s = _ssd_inputs(seed, b, t, h, device)
    gen = torch.Generator().manual_seed(seed + 1)
    B, C = ((torch.randn((b, t, groups, 64), generator=gen) * 0.5).to(device) for _ in range(2))
    return x, dt, A, B, C, s


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,groups", [
    (2, 300, 4, 2), (1, 129, 6, 2), (2, 2049, 4, 2), (3, 65, 2, 2),
    (4, 2048, 112, 2),      # Zamba2-7B's prefill: 112 heads, 2 groups of B and C
])
def test_ssd_kernel_with_grouped_b_and_c(cuda, b, t, h, groups):
    xs = _grouped_ssd_inputs(24, b, t, h, groups, cuda)
    y, state = ssd_fwd(*xs)
    torch.cuda.synchronize()
    want_y, want_state = ref.mamba2_ssd(*xs, chunk=128)
    _close(y, want_y, SCAN_TOL)
    _close(state, want_state, SCAN_TOL)


@pytest.mark.cuda
def test_ssd_kernel_takes_one_group_as_it_always_did(cuda):
    """B and C [Bt,T,1,N] launch what [Bt,T,N] does, bit for bit; a gradient asked of
    a grouped call raises."""
    x, dt, A, B, C, s = _ssd_inputs(25, 2, 300, 4, cuda)
    one = ssd_fwd(x, dt, A, B, C, s)
    grouped = ssd_fwd(x, dt, A, B[:, :, None].contiguous(), C[:, :, None].contiguous(), s)
    assert all(torch.equal(a, b) for a, b in zip(one, grouped))
    x, dt, A, B, C, s = _grouped_ssd_inputs(25, 1, 64, 4, 2, cuda)
    with pytest.raises(NotImplementedError, match="groups"):
        ops.mamba2_ssd(x.requires_grad_(), dt, A, B, C, s)
    with pytest.raises(ValueError, match="do not divide"):
        ssd_fwd(*_grouped_ssd_inputs(25, 1, 64, 4, 3, cuda))


@pytest.mark.cuda
def test_published_zamba2_serves_through_the_kernels(cuda, monkeypatch):
    """Zamba2-7B at its published widths, cut to 4 layers with a site of each shared
    block: a bf16 prefill and three decode steps through K1 (hd 224), K3 (2 groups),
    K5 (hd 224) and K6, each the expected number of times (the second step captures
    its segments as CUDA graphs and the third replays them, as ``BatchServer`` runs a
    wave's steps: a replay counts the launches it holds), bit for bit the steps run
    eagerly, and no further from the same model in fp32 on the plain paths (``ref``)
    than twice the bf16 plain paths are.  The fp32 model on the card is refused by
    the kernels, not sent to the plain paths."""
    import contextlib
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import mamba2_ssd
    from repro_torch.models import get_model
    from repro_torch.serve import graphs
    cfg = dataclasses.replace(get_arch("zamba2-7b-instruct"), n_layers=4,
                              hybrid_layer_ids=(1, 3), vocab=4096)
    api = get_model(cfg)
    params = api.init(0, torch.bfloat16, "cuda")
    params32 = {k: (v.float() if isinstance(v, torch.Tensor) else
                    {n: w.float() for n, w in v.items()}) for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab, (2, 300), generator=torch.Generator().manual_seed(26))

    def serve(p, graphed=False):
        steps = graphs.StepGraphs(cuda)
        with torch.no_grad():
            logits, cache = api.prefill(p, toks[:, :297].to(cuda), 320)
            out = [logits[:, -1]]
            for i in range(297, 300):
                with steps.on() if graphed and i > 297 else contextlib.nullcontext():
                    logits, cache = api.decode(p, toks[:, i:i + 1].to(cuda), cache, i)
                out.append(logits[:, -1])
        return torch.stack(out, 1).float()

    def err(a, b):
        return ((a - b).abs() / (1 + b.abs())).max().item()

    for fn in (flash_attention_fwd, mamba2_ssd.ssd_fwd, decode_kernel, step_kernel):
        monkeypatch.setattr(fn, "launches", 0)
    got = serve(params, graphed=True)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.launches, mamba2_ssd.ssd_fwd.launches,
            decode_kernel.launches, step_kernel.launches) == (2, 4, 6, 12)
    assert torch.equal(serve(params), got)
    with pytest.raises(ValueError, match="bf16"):
        serve(params32)
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, window=0, q_offset=0,
                        scale=None: ref.flash_attention(q, k, v, q_offset, window, scale=scale))
    monkeypatch.setattr(ops, "mamba2_ssd", lambda *a, chunk=128: ref.mamba2_ssd(*a, chunk=chunk))
    monkeypatch.setattr(ops, "decode_attention", ref.decode_attention)
    monkeypatch.setattr(ops, "mamba2_step", ref.mamba2_step)
    plain = serve(params)
    want = serve(params32)
    assert torch.isfinite(got).all()
    assert err(got, want) <= 2 * err(plain, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen1.5-32b", "chameleon-34b"])
def test_dense_decode_steps_replay_as_graphs_bit_for_bit(arch, cuda, monkeypatch):
    """A dense model at its widths (tied head and depth-scaled residual; q/k/v bias;
    qk-norm), cut to 2 layers: a bf16 prefill and four decode steps, the second
    capturing its segments as CUDA graphs and the later ones replaying them, as
    ``BatchServer`` runs a wave's steps, give the eager steps' logits and cache bit
    for bit, with the decode kernel once a layer a step."""
    import contextlib
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    from repro_torch.serve import graphs
    cfg = dataclasses.replace(get_arch(arch), n_layers=2, vocab=4096)
    api = get_model(cfg)
    params = api.init(0, torch.bfloat16, "cuda")
    toks = torch.randint(0, cfg.vocab, (4, 301), generator=torch.Generator().manual_seed(30))

    def serve(graphed):
        steps = graphs.StepGraphs(cuda)
        with torch.no_grad():
            logits, cache = api.prefill(params, toks[:, :297].to(cuda), 320)
            out = [logits[:, -1]]
            for i in range(297, 301):
                with steps.on() if graphed and i > 297 else contextlib.nullcontext():
                    logits, cache = api.decode(params, toks[:, i:i + 1].to(cuda), cache, i)
                out.append(logits[:, -1].clone())       # a replay overwrites its output
        return torch.stack(out, 1), cache

    monkeypatch.setattr(decode_kernel, "launches", 0)
    got, got_cache = serve(graphed=True)
    torch.cuda.synchronize()
    assert decode_kernel.launches == 2 * 4
    want, want_cache = serve(graphed=False)
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, want)
    assert all(torch.equal(got_cache[n], want_cache[n]) for n in want_cache)


def _step_inputs(seed, b, h, p, n, groups, device):
    """One token's in_proj output, conv tail and weights (bf16) and the fp32 state and
    per-head parameters of a Mamba2 layer, at the published block's scales."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    din, c = h * p, h * p + 2 * groups * n
    bf = torch.bfloat16
    xs = (r(b, din + c + h).to(bf), r(b, c, 3).to(bf), (r(4, c) * 0.2).to(bf),
          (r(c) * 0.02).to(bf), r(h) - 4.0, -torch.arange(1, h + 1, dtype=torch.float32),
          torch.ones(h), r(b, h, p, n) * 0.2, (1 + 0.1 * r(din)).to(bf))
    return [x.to(device) for x in xs] + [groups, 1e-5]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,p,n,groups", [
    (32, 112, 64, 64, 2),       # Zamba2-7B's decode cell: a wave of 32, 112 heads, 2 groups
    (3, 8, 64, 64, 1), (2, 8, 32, 16, 2),
])
def test_decode_step_kernel_matches_plain(cuda, b, h, p, n, groups):
    """K6 against ``ref.mamba2_step`` on the same inputs, two steps running (the group
    tickets left at 0 after each): the output within the bf16 tolerance, the state
    within it, the conv tail bit for bit; a rerun bit for bit."""
    xs = _step_inputs(31, b, h, p, n, groups, cuda)
    mine = [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]
    again = [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]
    for step in range(2):
        out = step_kernel(*mine)
        want = ref.mamba2_step(*xs)
        torch.cuda.synchronize()
        _close(out, want, TOL[torch.bfloat16])
        _close(mine[7], xs[7], TOL[torch.bfloat16])
        assert torch.equal(mine[1], xs[1]), step
    first = step_kernel(*again)
    assert torch.equal(first, step_kernel(*[x.clone() if isinstance(x, torch.Tensor) else x
                                            for x in _step_inputs(31, b, h, p, n, groups, cuda)]))
