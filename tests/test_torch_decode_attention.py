"""The decode kernel's wrapper, operator and routing, on the CPU (no card, no JAX).

* The wrapper (``kernels.decode_attention.decode_attention``) refuses, before
  anything is built or launched, each input the kernel does not take: a CPU
  tensor, a DTensor, an int8 or fp32 cache, a head dim not compiled, G > 8,
  ``n_valid`` outside [1, Smax], non-contiguous or misaligned inputs.
* ``splits`` cuts the valid slots into whole tiles, none empty, covering them.
* The operator's fake implementation gives the wrapper's output (shape, dtype,
  device) and launches nothing; its work is the plain path's score and value
  products over the slots it reads, so the dry run's decode counts the plain
  path's flops less those of the slots past ``n_valid``.
* ``layers.attention_decode`` takes the kernel's operator only where ``ops``
  sends the call to the card and the cache is bf16 and not split by its
  sequence: on the CPU, with an int8 cache, or with the sequence split, the
  einsums run and nothing launches.
* On that route a dense decode step runs as ``serve.graphs`` segments around each
  layer's kernel, bit for bit the step it was.
* ``ref.decode_attention`` (the plain version the card tests hold the kernel
  to) in float32 against the softmax written out in float64.
"""

import contextlib
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, ref, work
from repro_torch.launch import dryrun, roofline
from repro_torch.models import get_model, layers

B, SMAX, KV, G, HD = 2, 40, 2, 2, 64


def _inputs(b=B, smax=SMAX, kv=KV, g=G, hd=HD, q_dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((b, 1, kv * g, hd), generator=gen).to(q_dtype)
    k = torch.randn((b, smax, kv, hd), generator=gen).to(cache_dtype)
    v = torch.randn((b, smax, kv, hd), generator=gen).to(cache_dtype)
    return q, k, v


def _misaligned(x):
    """A contiguous view of x's shape that starts 2 bytes into a buffer."""
    flat = torch.empty(x.numel() + 8, dtype=x.dtype)[1:x.numel() + 1]
    return flat.view(x.shape).copy_(x)


REFUSALS = {
    "cpu_tensor": (lambda q, k, v: (q, k, v, 8), ValueError, "one CUDA device"),
    "int8_cache": (lambda q, k, v: (q, k.to(torch.int8), v.to(torch.int8), 8), ValueError,
                   "bf16 K/V cache"),
    "fp32_cache": (lambda q, k, v: (q, k.float(), v.float(), 8), ValueError, "bf16 K/V cache"),
    "fp16_q": (lambda q, k, v: (q.half(), k, v, 8), ValueError, "bf16 or fp32 q"),
    "head_dim_48": (lambda q, k, v: (q[..., :48], k[..., :48], v[..., :48], 8), ValueError,
                    "head dim 48 not compiled"),
    "g_9": (lambda q, k, v: (torch.zeros(B, 1, 9, HD, dtype=q.dtype), k[:, :, :1].contiguous(),
                             v[:, :, :1].contiguous(), 8), ValueError, "G <= 8"),
    "heads_not_a_multiple": (lambda q, k, v: (q[:, :, :3].contiguous(), k, v, 8), ValueError,
                             "H = G \\* KV"),
    "n_valid_0": (lambda q, k, v: (q, k, v, 0), ValueError, "n_valid 0 outside"),
    "n_valid_past_smax": (lambda q, k, v: (q, k, v, SMAX + 1), ValueError, "outside \\[1, 40\\]"),
    "batch_disagrees": (lambda q, k, v: (q[:1], k, v, 8), ValueError, "disagree"),
    "non_contiguous_cache": (lambda q, k, v: (q, k.transpose(1, 2).contiguous().transpose(1, 2),
                                              v, 8), ValueError, "contiguous"),
    "misaligned_cache": (lambda q, k, v: (q, _misaligned(k), v, 8), ValueError, "16-byte"),
    "misaligned_q": (lambda q, k, v: (_misaligned(q), k, v, 8), ValueError, "16-byte"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    make, exc, match = REFUSALS[case]
    before = da.decode_attention.launches
    with pytest.raises(exc, match=match):
        da.decode_attention(*make(*_inputs()))
    assert da.decode_attention.launches == before


def test_wrapper_refuses_a_dtensor():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    dryrun.join_fake_world(4)
    try:
        mesh = make_host_mesh(1, 4, device_type="cpu")
        q, k, v = (shd.distribute(x, (), mesh) for x in _inputs())
        with pytest.raises(TypeError, match="DTensor"):
            da.decode_attention(q, k, v, 8)
        with pytest.raises(TypeError, match="DTensor"):
            ops.decode_attention(q, k, v, 8)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("pairs,n_valid,tile", [
    (1152, 2100, 64), (1152, 1, 64), (1152, 2304, 64), (8, 2000, 32), (1, 4999, 64),
    (2, 129, 128), (64, 64, 64), (3, 65, 64)])
def test_splits_cover_the_valid_slots_in_whole_tiles(pairs, n_valid, tile):
    sms = 132
    n, per = da.splits(pairs, n_valid, tile, sms)
    assert per % tile == 0 and per >= tile
    assert (n - 1) * per < n_valid <= n * per          # every split non-empty, all covered
    tiles = -(-n_valid // tile)
    assert n <= tiles
    assert pairs * n >= da.BLOCKS_PER_SM * sms or n == tiles   # enough blocks, or one tile each
    if n > 1:                                          # and no shorter run would be needed
        assert pairs * -(-tiles // (per // tile + 1)) < da.BLOCKS_PER_SM * sms


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_operator_fake_output_and_work(q_dtype):
    before = da.decode_attention.launches
    with FakeTensorMode():
        q = torch.empty((B, 1, KV * G, HD), dtype=q_dtype, device="cuda")
        k = torch.empty((B, SMAX, KV, HD), dtype=torch.bfloat16, device="cuda")
        out = torch.ops.repro_torch.decode_attention(q, k, k, 17)
        assert (tuple(out.shape), out.dtype, out.device.type) == (tuple(q.shape), q_dtype, "cuda")
        assert out.is_contiguous()
        count = roofline.Count("cuda")
        with count:
            ops.decode_attention(q, k, k, 17)
    assert da.decode_attention.launches == before
    assert dict(count.kernel_calls) == {"decode_attention": 1}
    flops, nbytes = work.decode_attention_work(B, 17, KV, G, HD, q.element_size())
    assert flops == 4 * HD * B * KV * G * 17
    assert nbytes == 4 * B * 17 * KV * HD + 2 * B * KV * G * HD * q.element_size()
    assert count.totals()["dot_flops"] == flops
    assert torch.ops.repro_torch.decode_attention in work.KERNEL_OPS


def _decode(cfg, params, cache_len, smax=24):
    api = get_model(cfg)
    cache = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in api.cache_spec(B, smax).items()}
    return api.decode(params, torch.zeros((B, 1), dtype=torch.int32), cache, cache_len)


@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x22b", "zamba2-7b"])
def test_kernel_route_counts_the_plain_products_over_the_valid_slots(arch):
    """A reduced decode step counted on real CPU tensors (the einsums over all 24
    slots) and lowered on fake ones through ``ops.kernel_path`` (the operator, one a
    layer with attention, counting the 11 valid slots): the dot flops differ by
    the products over the 13 slots past n_valid, exactly."""
    cfg = get_arch(arch).reduced()
    params = get_model(cfg).init(0, torch.float32, "cpu")
    plain = roofline.Count("cpu")
    with torch.no_grad(), plain:
        _decode(cfg, params, 10)
    with FakeTensorMode(), ops.kernel_path():
        fake = dryrun.fake_twin(params, "cpu")
        kernel = roofline.Count("cpu")
        with torch.no_grad(), kernel:
            _decode(cfg, fake, 10)
    sites = cfg.n_layers // cfg.attn_every if cfg.attn_every else cfg.n_layers
    assert not plain.kernel_calls
    assert dict(kernel.kernel_calls) == {"decode_attention": sites}
    past = 4 * cfg.hd * B * cfg.n_heads * (24 - 11) * sites
    assert plain.totals()["dot_flops"] - kernel.totals()["dot_flops"] == past


def _attention(cache: str):
    """One reduced minicpm-2b attention_decode call on real CPU tensors over a cache
    of 24 slots, 11 valid: bf16, int8 with its scales, or fp32."""
    cfg = get_arch("minicpm-2b").reduced()
    gen = torch.Generator().manual_seed(1)
    p = layers.init_attention(cfg, gen, torch.float32)
    x = torch.randn((B, 1, cfg.d_model), generator=gen)
    shape = (B, 24, cfg.n_kv_heads, cfg.hd)
    k, v = (torch.randn(shape, generator=gen) for _ in range(2))
    scales = None
    if cache == "int8":
        (k, ks), (v, vs) = layers._quantize_kv(k), layers._quantize_kv(v)
        scales = (ks, vs)
    else:
        k, v = k.to({"bf16": torch.bfloat16, "fp32": torch.float32}[cache]), \
            v.to({"bf16": torch.bfloat16, "fp32": torch.float32}[cache])
    return layers.attention_decode(cfg, p, x, k, v, 10, 10, 11, kv_scale=scales)[0]


class _Graphs:
    """A stand-in for a server's ``StepGraphs``: each segment recorded, then run on
    copies of its inputs, as a replay reads the buffers it was captured with."""

    def __init__(self):
        self.keys = []

    def run(self, key, fn, inputs):
        self.keys.append(key)
        return fn(*[x.clone() for x in inputs])


@pytest.mark.parametrize("arch,swa", [("minicpm-2b", 0), ("minicpm-2b", 16), ("qwen1.5-32b", 0),
                                      ("phi3-medium-14b", 0), ("chameleon-34b", 0),
                                      ("mixtral-8x22b", 0)])
def test_dense_decode_step_runs_as_segments_around_the_kernel(arch, swa, monkeypatch):
    """On the kernel's route (here ``ref.decode_attention`` in its place) a dense
    decode step is one segment for the embedding and the first layer's q/k/v and
    cache write, and one after each layer's attention (``serve.graphs``), the kernel
    between them; under a server's graphs, eagerly, and as one ``attention_decode``
    a layer it gives the same logits and cache, bit for bit.  An MoE step, whose
    routing is not captured, marks no segment."""
    from repro_torch.models import transformer
    from repro_torch.serve import graphs
    cfg = dataclasses.replace(get_arch(arch).reduced(), swa_window=swa)
    api = get_model(cfg)
    params = api.init(0, torch.bfloat16, "cpu")
    monkeypatch.setattr(ops, "takes_decode_attention", lambda q, cache: True)
    monkeypatch.setattr(ops, "decode_attention", ref.decode_attention)
    toks = torch.randint(0, cfg.vocab, (B, 23), generator=torch.Generator().manual_seed(3))

    def step():
        with torch.no_grad():
            _, cache = api.prefill(params, toks[:, :22], 24)
            logits, cache = api.decode(params, toks[:, 22:], cache, 22)
        return logits, cache

    eager = step()
    fake = _Graphs()
    monkeypatch.setattr(graphs, "_active", fake)
    graphed = step()
    monkeypatch.setattr(graphs, "_active", None)
    monkeypatch.setattr(transformer, "_segmented", lambda cfg, cache: False)
    layered = step()
    want = [] if cfg.family == "moe" else [("dense", i) for i in range(-1, cfg.n_layers)]
    assert fake.keys == want
    for got in (graphed, layered):
        assert torch.equal(got[0], eager[0])
        assert all(torch.equal(got[1][n], eager[1][n]) for n in eager[1])


@pytest.mark.parametrize("cache", ["bf16", "int8", "fp32"])
def test_attention_decode_takes_the_kernel_for_a_bf16_cache_only(cache, monkeypatch):
    """On CPU tensors every cache runs the einsums and nothing launches.  On the
    card's route (``ops.kernel_path``) a bf16 cache goes to the kernel, whose
    wrapper refuses the CPU tensors; an int8 or fp32 cache still runs the
    einsums, bit for bit as on the CPU's route, and nothing launches."""
    monkeypatch.setattr(da.decode_attention, "launches", 0)
    count = roofline.Count("cpu")
    with torch.no_grad(), count:
        plain = _attention(cache)
    assert torch.isfinite(plain).all() and not count.kernel_calls
    with torch.no_grad(), ops.kernel_path():
        if cache == "bf16":
            with pytest.raises(ValueError, match="one CUDA device"):
                _attention(cache)
        else:
            assert torch.equal(_attention(cache), plain)
    assert da.decode_attention.launches == 0


def test_sequence_split_keeps_the_einsums():
    """A placed decode step lowered on a fake world of 4 ranks, a (1, 4) mesh, through
    ``ops.kernel_path``: with the cache split by its heads each rank's attention is
    the operator, once a layer; with the sequence split forced it is the einsums,
    with the softmax reduced over "model", and the operator is never called."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    from repro_torch.serve.server import cache_specs, placed_decode
    cfg = dataclasses.replace(get_arch("minicpm-2b").reduced(), n_layers=2)
    api = get_model(cfg)
    dryrun.join_fake_world(4)
    calls = {}
    try:
        mesh = make_host_mesh(1, 4, device_type="cpu")
        for name, forced in (("heads", False), ("sequence", True)):
            with FakeTensorMode(), ops.kernel_path():
                whole = api.init(0, torch.float32, "cpu")
                params = shd.distribute_tree(whole, shd.param_shardings(cfg, whole, mesh), mesh)
                spec = api.cache_spec(4, 24)
                cache = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in spec.items()}
                with ctx.force_sequence_split() if forced else contextlib.nullcontext():
                    placed = shd.distribute_tree(cache, cache_specs(
                        cfg, {k: s for k, (s, _) in spec.items()}, mesh), mesh)
                    count = roofline.Count("cpu")
                    with torch.no_grad(), count:
                        placed_decode(cfg, params, shd.distribute(
                            torch.zeros((4, 1), dtype=torch.int32), ("data", None), mesh),
                            placed, 5, mesh)
                calls[name] = dict(count.kernel_calls)
    finally:
        dist.destroy_process_group()
    assert calls == {"heads": {"decode_attention": cfg.n_layers}, "sequence": {}}


def test_plain_version_is_the_softmax_over_the_valid_slots():
    """``ref.decode_attention`` in float32 against the softmax written out in float64
    over slots [0, n_valid), with NaN past them in neither (the plain version reads
    every slot and masks; the kernel reads only the valid ones)."""
    q, k, v = _inputs(q_dtype=torch.float32, cache_dtype=torch.float32)
    n_valid = 23
    got = ref.decode_attention(q, k, v, n_valid)
    qd, kd, vd = (x.double() for x in (q, k, v))
    qg = qd.reshape(B, KV, G, HD)
    s = torch.einsum("bkgh,bskh->bkgs", qg, kd[:, :n_valid]) / HD ** 0.5
    want = torch.einsum("bkgs,bskh->bkgh", torch.softmax(s, -1), vd[:, :n_valid])
    torch.testing.assert_close(got.double().reshape(B, KV, G, HD), want, rtol=1e-5, atol=1e-5)
