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
fp32 on the CUDA cores, so each feature is tested in both dtypes.
"""

import ctypes

import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.checksum import checksum as checksum_kernel
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.mamba2_ssd import ssd_bwd, ssd_fwd
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
    xs = _wkv6_inputs(9, 1, 64, 2, cuda, d=32)
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


def _wkv6_strong(seed, b, t, h, device):
    """Decays spread down to the reference's 1e-30 clamp (w = e^-U(0, 69)), and w = 0
    in every 16th key column: a chunk's decay factors underflow."""
    r, k, v, w, u, s = _wkv6_inputs(seed, b, t, h, "cpu")
    w = torch.exp(-69.0 * torch.rand(w.shape, generator=torch.Generator().manual_seed(seed)))
    w[..., ::16] = 0.0
    return tuple(x.to(device) for x in (r, k, v, w, u, s))


def _ssd_strong(seed, b, t, h, device):
    """A scaled by 50: e^cl and the pairwise decays underflow within a chunk."""
    x, dt, A, B, C, s = _ssd_inputs(seed, b, t, h, "cpu")
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
    each source): both reverse state passes and K4-bwd's chunk pass hold two blocks an SM,
    K3-bwd's chunk pass, whose head tiles are double-buffered in 230.7 KB, one."""
    for name, source, blocks in (("wkv6_bwd", "rwkv6_scan_bwd", {0: 2, 1: 2}),
                                 ("ssd_bwd", "mamba2_ssd_bwd", {0: 2, 1: 1})):
        fn = getattr(_build.load(source), f"{name}_occupancy")
        fn.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
        for kernel, want in blocks.items():
            vals = [ctypes.c_int() for _ in range(3)]
            assert fn(kernel, *(ctypes.byref(v) for v in vals)) == 0
            assert vals[2].value >= want, (name, kernel, [v.value for v in vals])


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
    """fp32 reduced rwkv6 / zamba2 at the kernels' head size of 64 (zamba2 with 7
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


# ------------------------------------------------------------------ the kernels' operators

def _op_calls(cuda):
    """(operator, wrapper, arguments) for each of the seven kernel operators, at small
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

    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    cfg = reduced_config(arch, "cuda")
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
