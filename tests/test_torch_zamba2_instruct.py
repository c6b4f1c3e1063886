"""The published Zamba2-7B hybrid (``zamba2-7b-instruct``) in the port, on the CPU.

* The port-only entry: outside ``ARCH_NAMES`` (the list the two packages
  share), resolved by ``get_arch``, at the published widths; its reduced form
  keeps a site of each shared block; its parameter count is its tree's.
* Served through the normal path: ``get_model`` -> ``BatchServer`` and
  ``launch.serve --arch zamba2-7b-instruct``; prefill then decode agree with the
  full forward; training and a mesh raise.
* Its kernels' routes: K1 and K5 at head dim 224 with the softmax scale, K3 with
  B and C in groups (the wrappers' shape checks, the operators' fake outputs and
  work, the plain versions against their definitions), and a decode step lowered
  through ``ops.kernel_path`` calling each operator once a site or layer.
"""

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_NAMES, get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba2_ssd, mamba2_step, ops, ref, work
from repro_torch.launch import dryrun, roofline
from repro_torch.models import get_model, zamba2

NAME = "zamba2-7b-instruct"
SCALE = (224 / 2) ** -0.5


def _small(**kw):
    """The published block at a small size: 6 layers, two sites of each block, 2
    groups of B and C, adapters of rank 8."""
    base = dataclasses.replace(get_arch(NAME).reduced(), n_layers=6,
                               hybrid_layer_ids=(1, 2, 3, 5))
    return dataclasses.replace(base, **kw)


def test_the_port_only_entry_is_the_published_model():
    cfg = get_arch(NAME)
    assert NAME not in ARCH_NAMES and len(ARCH_NAMES) == 10
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff, cfg.vocab) == \
        (81, 3584, 32, 224, 14336, 32000)
    assert cfg.hybrid_layer_ids == (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)
    assert (cfg.shared_blocks, cfg.ssm_groups, cfg.adapter_rank, cfg.mlp_act) == \
        (2, 2, 128, "gelu")
    assert cfg.attn_concat_embed and cfg.attn_scale == pytest.approx(SCALE)
    assert cfg.rms_eps == 1e-5 and cfg.tie_embeddings
    assert cfg.param_count() == pytest.approx(7.357e9, rel=1e-3)
    twin = get_arch("zamba2-7b")       # the other configs keep the fields' defaults
    assert (twin.hybrid_layer_ids, twin.shared_blocks, twin.ssm_groups, twin.mlp_act,
            twin.attn_scale) == ((), 1, 1, "silu", None)


def test_reduced_keeps_a_site_of_each_block_and_counts_its_tree():
    cfg = get_arch(NAME).reduced()
    sites = zamba2.site_layers(cfg)
    assert len(sites) >= cfg.shared_blocks and all(i < cfg.n_layers for i in sites)
    assert {j % cfg.shared_blocks for j in range(len(sites))} == set(range(cfg.shared_blocks))
    params = get_model(cfg).init(0, torch.float32, "cpu")
    n = sum(t.numel() for tree in params.values() for t in tree.values())
    assert n == cfg.param_count()


def test_prefill_then_decode_agree_with_the_full_forward():
    cfg = _small()
    api = get_model(cfg)
    params = api.init(0, torch.float32, "cpu")
    toks = torch.randint(0, cfg.vocab, (3, 21), generator=torch.Generator().manual_seed(1))
    toks[0, :6] = 0
    with torch.no_grad():
        full = api.forward(params, toks[:, :20])
        logits, cache = api.prefill(params, toks[:, :16], 24)
        got = [logits[:, -1]]
        for i in range(16, 20):
            logits, cache = api.decode(params, toks[:, i:i + 1], cache, i)
            got.append(logits[:, -1])
    want = full[:, 15:20]
    assert float((torch.stack(got, 1) - want).abs().max()) <= 1e-5 * float(want.abs().max())
    spec = api.cache_spec(3, 24)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: s for k, (s, _) in spec.items()}


def test_launch_serve_runs_the_reduced_config(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", NAME, "--device", "cpu", "--requests", "3", "--max-new", "3"])
    assert "served 3 requests" in capsys.readouterr().out


def test_training_and_a_mesh_raise(monkeypatch):
    cfg = _small()
    api = get_model(cfg)
    params = api.init(0, torch.float32, "cpu")
    toks = torch.zeros((2, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="training"):
        api.loss(params, {"tokens": toks, "labels": toks})
    monkeypatch.setattr(zamba2.layers, "tp_mesh", lambda: object())
    with pytest.raises(NotImplementedError, match="mesh"):
        api.prefill(params, toks, 16)


# ------------------------------------------------------------------ kernels' routes

def test_flash_plain_version_takes_the_scale():
    gen = torch.Generator().manual_seed(2)
    q = torch.randn((2, 40, 2, 1, 224), generator=gen)
    k, v = (torch.randn((2, 40, 2, 224), generator=gen) for _ in range(2))
    want = ref.attention_naive(q, k, v, scale=SCALE)
    torch.testing.assert_close(ops.flash_attention(q, k, v, scale=SCALE), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ref.attention_naive(q * SCALE * 224 ** 0.5, k, v), want,
                               rtol=1e-5, atol=1e-5)


def test_flash_operator_takes_head_dim_224_and_its_backward_does_not():
    assert 224 in fa.HEAD_DIMS and 224 not in fa.BWD_HEAD_DIMS
    with FakeTensorMode():
        q = torch.empty((2, 64, 4, 1, 224), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((2, 64, 4, 224), dtype=torch.bfloat16, device="cuda")
        out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, k, 0, 0, SCALE)
        assert tuple(out.shape) == tuple(q.shape) and tuple(lse.shape) == (2, 4, 1, 64)
        with pytest.raises(ValueError, match="head dim 224 not compiled"):
            fa._check(q, k, k, 0, 0, "flash_attention_bwd", fa.BWD_HEAD_DIMS)


def test_decode_operator_at_head_dim_224_and_its_plain_version():
    assert 224 in da.HEAD_DIMS
    with FakeTensorMode():
        q = torch.empty((2, 1, 4, 224), dtype=torch.bfloat16, device="cuda")
        k = torch.empty((2, 40, 4, 224), dtype=torch.bfloat16, device="cuda")
        out = torch.ops.repro_torch.decode_attention(q, k, k, 17, SCALE)
        assert tuple(out.shape) == tuple(q.shape)
    q, k = (torch.zeros(s, dtype=torch.bfloat16) for s in ((1, 1, 1, 224), (1, 8, 1, 224)))
    with pytest.raises(ValueError, match="scale must be positive"):
        da.decode_attention(q, k, k, 8, 0.0)
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 1, 4, 224), generator=gen, dtype=torch.float64)
    k, v = (torch.randn((2, 40, 2, 224), generator=gen, dtype=torch.float64) for _ in range(2))
    got = ref.decode_attention(q, k, v, 23, SCALE)
    s = torch.einsum("bkgh,bskh->bkgs", q.reshape(2, 2, 2, 224), k[:, :23]) * SCALE
    want = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, -1), v[:, :23])
    torch.testing.assert_close(got.reshape(2, 2, 2, 224), want, rtol=1e-5, atol=1e-5)


def _grouped(b=2, t=150, h=6, g=2, p=8, n=4, seed=4):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    return (r(b, t, h, p) * 0.5, torch.nn.functional.softplus(r(b, t, h) - 1.0),
            -r(h).abs() - 0.1, r(b, t, g, n) * 0.5, r(b, t, g, n) * 0.5, r(b, h, p, n) * 0.2)


@pytest.mark.parametrize("fn", ["mamba2_ssd", "mamba2_naive"])
def test_grouped_scan_is_each_groups_own_scan(fn):
    x, dt, A, B, C, s = _grouped()
    scan = getattr(ref, fn)
    y, state = scan(x, dt, A, B, C, s)
    k = x.shape[2] // B.shape[2]
    for g in range(B.shape[2]):
        hs = slice(g * k, (g + 1) * k)
        yg, sg = scan(x[:, :, hs], dt[:, :, hs], A[hs], B[:, :, g], C[:, :, g], s[:, hs])
        torch.testing.assert_close(y[:, :, hs], yg, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(state[:, hs], sg, rtol=1e-5, atol=1e-6)


def test_grouped_ssd_wrapper_checks_and_work():
    with FakeTensorMode():
        x = torch.empty((2, 150, 6, 64), device="cuda")
        dt = torch.empty((2, 150, 6), device="cuda")
        A = torch.empty((6,), device="cuda")
        s = torch.empty((2, 6, 64, 64), device="cuda")
        B = torch.empty((2, 150, 4, 64), device="cuda")
        with pytest.raises(ValueError, match="4 groups of B/C do not divide 6 heads"):
            mamba2_ssd._check(x, dt, A, B, B, s, 128)
        B = torch.empty((2, 150, 2, 64), device="cuda")
        y, s_out = torch.ops.repro_torch.ssd_fwd(x, dt, A, B, B, s, 128, False)
        assert tuple(y.shape) == tuple(x.shape) and tuple(s_out.shape) == tuple(s.shape)
        with pytest.raises(ValueError, match=r"B/C \[Bt,T,N\]"):
            mamba2_ssd._check(x, dt, A, B, B, s.new_empty((2, 3, 6, 64, 64)), 128, "ssd_bwd", x)
    one = work.ssd_work(2, 150, 6, 64, 64, 128)
    two = work.ssd_work(2, 150, 6, 64, 64, 128, 2)
    assert one == work.ssd_work(2, 150, 6, 64, 64, 128, 1)
    gram = 2 * 2 * (128 * 129 // 2 + 22 * 23 // 2) * 64      # C B^T a batch row, causal half
    assert two[0] - one[0] == gram and two[2] - one[2] == 4 * 2 * 2 * 150 * 64


def test_a_decode_step_takes_each_kernel_once_a_site():
    """A decode step and a prefill of the small config lowered on fake tensors through
    ``ops.kernel_path``: K5 once a site and K6 once a layer in decode, K1 once a site
    and K3 once a layer in the prefill."""
    cfg = _small()
    api = get_model(cfg)
    sites = len(zamba2.site_layers(cfg))
    with FakeTensorMode(), ops.kernel_path():
        params = dryrun.fake_twin(api.init(0, torch.bfloat16, "cpu"), "cpu")
        cache = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in api.cache_spec(2, 24).items()}
        decode, prefill = roofline.Count("cpu"), roofline.Count("cpu")
        with torch.no_grad(), decode:
            api.decode(params, torch.zeros((2, 1), dtype=torch.int32), cache, 10)
        with torch.no_grad(), prefill:
            api.prefill(params, torch.zeros((2, 16), dtype=torch.int32), 24)
    assert dict(decode.kernel_calls) == {"decode_attention": sites, "mamba2_step": cfg.n_layers}
    assert dict(prefill.kernel_calls) == {"flash_attention_fwd": sites, "ssd_fwd": cfg.n_layers}


def _step_inputs(b=2, h=6, p=32, n=16, groups=2, dtype=torch.float32, seed=5):
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    din, c = h * p, h * p + 2 * groups * n
    return (r(b, din + c + h).to(dtype), r(b, c, 3).to(dtype), (r(4, c) * 0.3).to(dtype),
            (r(c) * 0.1).to(dtype), r(h) - 3.0, -torch.arange(1, h + 1, dtype=torch.float32),
            torch.ones(h), r(b, h, p, n) * 0.2, torch.ones(din, dtype=dtype), groups, 1e-5)


def test_the_decode_step_is_the_prefills_scan_one_token_on():
    """``ref.mamba2_step`` (K6's plain version) against the prefill's formulation of the
    same token: the conv over the tail and the token, the chunked scan from the state,
    D x and the gated group norm."""
    import torch.nn.functional as F
    u, conv, w, cb, dt_bias, A, D, s, nw, groups, eps = _step_inputs()
    b, h, p, n = s.shape
    din, gn = h * p, groups * n
    conv0, s0 = conv.clone(), s.clone()
    got = ref.mamba2_step(u, conv, w, cb, dt_bias, A, D, s, nw, groups, eps)
    z, xbc, dt = torch.split(u[:, None], [din, din + 2 * gn, h], dim=-1)
    pad = torch.cat([conv0.transpose(1, 2), xbc], 1)                # [B, K, C]
    xs, B, C = torch.split(F.silu((pad * w).sum(1, keepdim=True) + cb), [din, gn, gn], dim=-1)
    dt = F.softplus(dt + dt_bias)
    xh = xs.reshape(b, 1, h, p)
    y, s1 = ref.mamba2_ssd(xh, dt, A, B.reshape(b, 1, groups, n), C.reshape(b, 1, groups, n), s0)
    y = ((y + D[:, None] * xh).reshape(b, groups, din // groups)
         * F.silu(z).reshape(b, groups, din // groups))
    want = (y * torch.rsqrt((y * y).mean(-1, keepdim=True) + eps)).reshape(b, din) * nw
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, s1, rtol=1e-5, atol=1e-6)
    assert torch.equal(conv, pad[:, 1:].transpose(1, 2))


def test_the_decode_step_operator_and_its_refusals():
    xs = _step_inputs(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one CUDA device"):
        mamba2_step.mamba2_step(*xs)
    def on_card(xs):        # fake CUDA tensors of the inputs' shapes and dtypes
        return [torch.empty(x.shape, dtype=x.dtype, device="cuda")
                if isinstance(x, torch.Tensor) else x for x in xs]

    small = _step_inputs(p=16, dtype=torch.bfloat16)
    with FakeTensorMode():
        out = torch.ops.repro_torch.mamba2_step(*on_card(xs))
        assert (tuple(out.shape), out.dtype) == ((2, 6 * 32), torch.bfloat16)
        with pytest.raises(ValueError, match="not compiled"):
            mamba2_step._check(*on_card(small)[:-1])
    flops, nbytes = work.mamba2_step_work(32, 112, 64, 64, 2)
    assert nbytes > 2 * 4 * 32 * 112 * 64 * 64
    assert flops == 32 * (8 * 7424 + 6 * 112 * 4096 + 8 * 7168)


@pytest.mark.parametrize("dtype,p", [(torch.float32, 32), (torch.bfloat16, 16)])
def test_the_card_takes_the_decode_kernels_whatever_they_are_given(dtype, p):
    """On the card a decode step's Mamba2 step and attention are the operators even
    where the kernels do not take the inputs (fp32, a (P, N) not compiled), so that
    their wrappers refuse them: nothing is sent to the plain versions.  On the CPU the
    routes are the plain versions."""
    xs = _step_inputs(p=p, dtype=dtype)
    q = torch.zeros((2, 1, 4, 224), dtype=dtype)
    cache = torch.zeros((2, 40, 2, 224), dtype=dtype)
    with FakeTensorMode(), ops.kernel_path():
        fake = [torch.empty(x.shape, dtype=x.dtype) if isinstance(x, torch.Tensor) else x
                for x in xs]
        count = roofline.Count("cpu")
        with count:
            ops.mamba2_step(*fake)
            ops.decode_attention(torch.empty(q.shape, dtype=dtype),
                                 torch.empty(cache.shape, dtype=dtype),
                                 torch.empty(cache.shape, dtype=dtype), 17, SCALE)
    assert dict(count.kernel_calls) == {"mamba2_step": 1, "decode_attention": 1}
    with ops.kernel_path(), pytest.raises(ValueError, match="one CUDA device"):
        ops.mamba2_step(*[x.clone() if isinstance(x, torch.Tensor) else x for x in xs])
    mine = [x.clone() if isinstance(x, torch.Tensor) else x for x in xs]
    torch.testing.assert_close(ops.mamba2_step(*mine), ref.mamba2_step(*xs))
    torch.testing.assert_close(mine[7], xs[7])
    torch.testing.assert_close(ops.decode_attention(q, cache, cache, 17, SCALE),
                               ref.decode_attention(q, cache, cache, 17, SCALE))


def test_segments_run_eagerly_unless_a_server_graphs_them():
    """Off the card ``BatchServer`` keeps no step graphs, and a segment outside
    ``StepGraphs.on()`` is its function's call: the published model's prefill and
    decode on the CPU are the eager path."""
    from repro_torch.serve import graphs
    from repro_torch.serve.server import BatchServer
    x = torch.arange(6.0)
    assert torch.equal(graphs.segment(("run", 0), lambda a, b: a * b + 1, x, x), x * x + 1)
    cfg = _small()
    server = BatchServer(cfg, get_model(cfg).init(0, torch.float32, "cpu"), batch=2, smax=32,
                         device="cpu")
    assert server.graphs is None
    assert server._graphed(3).__class__.__name__ == "nullcontext"
