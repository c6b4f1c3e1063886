"""Placed prefill and decode against the mesh-free ones, on 8 gloo ranks.

``serve.server.placed_prefill``/``placed_decode`` run the model's prefill
and decode on DTensors placed as the reference's dry run places its
serving calls: params by ``param_shardings``, tokens by
``input_shardings``, the cache by ``cache_shardings`` (rwkv6's and
zamba2's states and K/V over "model" too), and they return the logits placed by
``logits_sharding``.  On a (2, 4) ("data", "model") mesh of 8 CPU
processes (``torch_gloo_ranks``), each case serves a prompt and 4 greedy
decode steps both ways from the same fp32 weights (made once, from a
seed), and holds the placed run to the mesh-free one:

  * every step's logits, gathered whole, within ``TOL``, and its argmax
    token equal;
  * the cache after the prefill and after the last step, gathered whole,
    within ``TOL``;
  * each rank's local shapes of cache and logits: the specs' shares.

The transformer's K/V cache is bf16 whatever the weights' dtype; a bf16
cache rounds the fp32 K/V, so a difference in their last fp32 bits (a
rank's narrower product, a residual summed over "model" in another order)
turns into a whole bf16 ulp of the cache (2e-3) where it crosses a rounding
boundary.  So the cases that serve a bf16 cache serve an fp32 one on both
sides (``fp32_kv_cache``), as ``chip_smoke.py`` does for its fp32 checks;
the int8 case keeps its int8 cache.

The cases reach the heads branch (codeqwen1.5-7b, 4 KV heads over model
4), the sequence branch with TP head padding (qwen1.5-32b at 6 heads) in
bf16 and int8, a cache split over neither, GQA (phi3-medium-14b, 1 KV
head), mixtral's window with a prompt past it (the ring over the sequence
split, the MoE block on each data rank's rows), arctic with FSDP forced,
rwkv6 and zamba2 split over "model" (their states by heads, channels and
d; zamba2's shared-block K/V by its heads, and by its sequence, forced),
each also with heads that do not divide the axis (the block whole on
every rank, its states at their placements all the same), and placements
other than the specs', refused.  Values are fp32 and differ only in the
order of summation: 1e-5.
"""

import contextlib
import dataclasses

import pytest
import torch

from torch_gloo_ranks import cases_of, fsdp_forced, moe_groups, rank_main, spawn_ranks

from repro_torch.parallel import sharding as shd  # noqa: E402

WORLD, MESH = 8, (2, 4)
SPAWN_TIMEOUT_S = 300        # all ranks, every case
PG_TIMEOUT_S = 60            # each collective
TOL = 1e-5
STEPS = 4                    # greedy decode steps after the prefill


# ------------------------------------------------------------------ the cases (in a rank)

def _close(got, want, what):
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL * (1 + float(want.float().abs().max())), f"{what}: max |diff| {err}"
    return err


def _attn_cfg(arch, heads, kv):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).reduced(), n_heads=heads, n_kv_heads=kv,
                               head_dim=16, n_layers=1)


def _reduced(arch, **kw):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(arch).reduced(), **kw)


def _share(shape, spec):
    """A rank's block shape of a tensor of ``shape`` placed by ``spec``."""
    sizes = dict(zip(("data", "model"), MESH))
    out = list(shape)
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            out[d] //= sizes[a]
    return out


@contextlib.contextmanager
def fp32_kv_cache():
    """The transformer's K/V cache allocated fp32 in place of bf16, for the block."""
    from repro_torch.models import transformer
    saved = transformer.kv_cache_spec

    def spec(*args):
        return {name: (shape, torch.float32 if dt == torch.bfloat16 else dt)
                for name, (shape, dt) in saved(*args).items()}

    transformer.kv_cache_spec = spec
    try:
        yield
    finally:
        transformer.kv_cache_spec = saved


def _argmax(logits, vocab):
    return logits[:, -1, :vocab].argmax(-1)


def _serve_case(mesh, cfg, seed, t, smax, kv="bfloat16", b=4):
    """``_serve`` with a bf16 K/V cache served fp32 (see the module's docstring)."""
    with fp32_kv_cache() if kv == "bfloat16" else contextlib.nullcontext():
        return _serve(mesh, cfg, seed, t, smax, kv, b)


def _serve(mesh, cfg, seed, t, smax, kv, b):
    """A prompt [b, t] and ``STEPS`` greedy steps, mesh-free then placed."""
    from repro_torch.models import get_model
    from repro_torch.serve.server import placed_decode, placed_prefill
    api = get_model(cfg)
    params = api.init(seed, torch.float32, "cpu")
    toks = torch.randint(0, cfg.vocab, (b, t), generator=torch.Generator().manual_seed(seed + 1))
    dp = MESH[0]

    with moe_groups(dp) if cfg.n_experts else contextlib.nullcontext():
        logits, cache = api.prefill(params, toks, smax, kv)
        caches = [{k: x.clone() for k, x in cache.items()}]
        want = [logits]
        for i in range(STEPS):
            logits, cache = api.decode(params, _argmax(want[-1], cfg.vocab)[:, None], cache,
                                       t + i)
            want.append(logits)
        caches.append(cache)

    def place(x):
        return shd.distribute(x, shd.input_shardings(mesh, {"x": x})["x"], mesh)

    placed = shd.distribute_tree(params, shd.param_shardings(cfg, params, mesh), mesh)
    logits, cache = placed_prefill(cfg, placed, place(toks), smax, kv, mesh)
    got, got_caches = [logits], [{k: x.full_tensor() for k, x in cache.items()}]
    for i in range(STEPS):
        logits, cache = placed_decode(cfg, placed, place(_argmax(got[-1].full_tensor(),
                                                                 cfg.vocab)[:, None]),
                                      cache, t + i, mesh)
        got.append(logits)
    got_caches.append({k: x.full_tensor() for k, x in cache.items()})

    cache_errs = {f"{k}@{when}": _close(g[k], w[k], f"cache {k} after {when}")
                  for when, g, w in zip(("prefill", "decode"), got_caches, caches) for k in w}
    errs = [_close(g.full_tensor(), w, f"logits of step {i}")
            for i, (g, w) in enumerate(zip(got, want))]
    tokens = [_argmax(w, cfg.vocab).tolist() for w in want]
    assert [_argmax(g.full_tensor(), cfg.vocab).tolist() for g in got] == tokens
    specs = {k: shd.cache_pspec(k, tuple(x.shape), mesh, cfg) for k, x in cache.items()}
    local = {k: list(x.to_local().shape) for k, x in cache.items()}
    assert local == {k: _share(x.shape, specs[k]) for k, x in cache.items()}, (local, specs)
    for k, x in cache.items():
        assert x.placements == shd.placements(specs[k], mesh), (k, x.placements)
    logits_spec = shd.logits_sharding(mesh, b)
    assert list(got[-1].to_local().shape) == _share(got[-1].shape, logits_spec)
    return {"logit_errs": errs, "cache_errs": cache_errs, "tokens": tokens,
            "local_cache_shapes": local, "local_logits_shape": list(got[-1].to_local().shape)}


def case_dense_heads(mesh):
    """(a) codeqwen1.5-7b reduced: 4 heads and 4 KV heads over model 4, the
    cache split by its heads: a rank runs its q head against its KV head."""
    res = _serve_case(mesh, _reduced("codeqwen1.5-7b"), 0, t=16, smax=24)
    assert res["local_cache_shapes"]["k"] == [2, 2, 24, 1, 32], res
    return res


def case_dense_sequence_padded(mesh):
    """(b) 6 heads (padded to 8 over model 4) and 6 KV heads: the cache split
    by its sequence (6 of 24 slots a rank), decode writing slots on two
    ranks."""
    res = _serve_case(mesh, _attn_cfg("qwen1.5-32b", 6, 6), 3, t=16, smax=24)
    assert res["local_cache_shapes"]["k"] == [1, 2, 6, 6, 16], res
    return res


def case_dense_sequence_int8(mesh):
    """(c) (b) with the int8 cache and its scales."""
    res = _serve_case(mesh, _attn_cfg("qwen1.5-32b", 6, 6), 3, t=16, smax=24, kv="int8")
    assert res["local_cache_shapes"]["k_scale"] == [1, 2, 6, 6, 1], res
    return res


def case_dense_cache_whole_over_model(mesh):
    """(b) with 22 slots, which divide neither over the heads nor over the
    sequence: every model rank holds the whole cache of its rows."""
    res = _serve_case(mesh, _attn_cfg("qwen1.5-32b", 6, 6), 3, t=16, smax=22)
    assert res["local_cache_shapes"]["k"] == [1, 2, 22, 6, 16], res
    return res


def case_gqa_sequence(mesh):
    """(d) phi3-medium-14b reduced: 4 heads, 1 KV head, the sequence split."""
    res = _serve_case(mesh, _reduced("phi3-medium-14b"), 5, t=16, smax=24)
    assert res["local_cache_shapes"]["k"] == [2, 2, 6, 1, 32], res
    return res


def case_mixtral_window_ring(mesh):
    """(e) mixtral reduced: its 64-slot window split over model 4 (16 slots a
    rank), a prompt of 80 past it, so prefill wraps the ring and decode
    overwrites slots on the ranks that hold them; the MoE block routes each
    data rank's rows as one group (the mesh-free run: in groups = dp)."""
    cfg = _reduced("mixtral-8x22b")
    assert cfg.swa_window == 64 and cfg.n_kv_heads == 1
    res = _serve_case(mesh, cfg, 7, t=80, smax=128)
    assert res["local_cache_shapes"]["k"] == [2, 2, 16, 1, 32], res
    return res


def case_arctic_fsdp(mesh):
    """(f) arctic reduced (4 experts over model 4, its dense residual MLP)
    with FSDP forced: each layer gathers its blocks over "data" too."""
    with fsdp_forced():
        return _serve_case(mesh, _reduced("arctic-480b"), 9, t=16, smax=24)


def case_rwkv6_model_split(mesh):
    """(g) rwkv6 reduced (4 heads over model 4): each rank its head of the
    time mix and its d-blocks of the channel mix; the wkv state split by its
    heads, the shift states by d."""
    res = _serve_case(mesh, _reduced("rwkv6-1.6b"), 11, t=16, smax=0)
    shapes = res["local_cache_shapes"]
    assert shapes["wkv"] == [2, 2, 1, 32, 32] and shapes["tmix_x"] == [2, 2, 32], res
    return res


def case_rwkv6_heads_not_dividing(mesh):
    """(g') rwkv6 at head size 64 (2 heads over model 4): the time mix whole
    on every rank, its wkv state whole over "model", the shift states still
    split by d; the channel mix split."""
    res = _serve_case(mesh, _reduced("rwkv6-1.6b", ssm_head_dim=64), 15, t=16, smax=0)
    shapes = res["local_cache_shapes"]
    assert shapes["wkv"] == [2, 2, 2, 64, 64] and shapes["cmix_x"] == [2, 2, 32], res
    return res


def case_zamba2_model_split(mesh):
    """(h) zamba2 reduced (8 Mamba2 heads, 4 shared-block KV heads over model
    4): the SSD state by its heads, the conv tail by its 288 channels (72 a
    rank against the 64 x-channels a rank computes), the K/V by its heads."""
    res = _serve_case(mesh, _reduced("zamba2-7b"), 13, t=16, smax=24)
    shapes = res["local_cache_shapes"]
    assert shapes["ssd"] == [4, 2, 2, 32, 16] and shapes["conv"] == [4, 2, 72, 3], res
    assert shapes["k"] == [2, 2, 24, 1, 32], res
    return res


def case_zamba2_sequence_split(mesh):
    """(h') (h) with the shared block's K/V split by its sequence, forced (6 of
    24 slots a rank; decode writes on two ranks)."""
    from repro_torch.parallel import ctx
    with ctx.force_sequence_split():
        res = _serve_case(mesh, _reduced("zamba2-7b"), 13, t=16, smax=24)
    assert res["local_cache_shapes"]["k"] == [2, 2, 6, 4, 32], res
    return res


def case_zamba2_heads_not_dividing(mesh):
    """(h'') zamba2 at Mamba2 head size 128 (2 heads over model 4): each
    Mamba2 layer whole on every rank, its SSD state whole over "model", its
    conv tail still split by channels."""
    res = _serve_case(mesh, _reduced("zamba2-7b", ssm_head_dim=128), 17, t=16, smax=24)
    shapes = res["local_cache_shapes"]
    assert shapes["ssd"] == [4, 2, 2, 128, 16] and shapes["conv"] == [4, 2, 72, 3], res
    return res


def case_wrong_placements_raise(mesh):
    """(i) tokens not split over the data axes, a cache not split over
    "model" where the specs split its sequence, and a weight not split over
    "model" where the rules split it: each refused."""
    from repro_torch.models import get_model
    from repro_torch.serve.server import placed_decode, placed_prefill
    cfg = _attn_cfg("qwen1.5-32b", 6, 6)
    api = get_model(cfg)
    params = api.init(3, torch.float32, "cpu")
    placed = shd.distribute_tree(params, shd.param_shardings(cfg, params, mesh), mesh)
    toks = torch.zeros((4, 16), dtype=torch.long)
    good = shd.distribute(toks, ("data", None), mesh)
    _, cache = placed_prefill(cfg, placed, good, 24, "bfloat16", mesh)
    token = shd.distribute(toks[:, :1], ("data", None), mesh)
    unsplit = {k: shd.distribute(x.full_tensor(), (None, "data"), mesh)
               for k, x in cache.items()}
    wrong_wq = dict(placed, layers={**placed["layers"], "attn": {
        **placed["layers"]["attn"],
        "wq": shd.distribute(params["layers"]["attn"]["wq"], (), mesh)}})
    calls = {
        "tokens": lambda: placed_prefill(cfg, placed, shd.distribute(toks, (), mesh), 24,
                                         "bfloat16", mesh),
        "cache": lambda: placed_decode(cfg, placed, token, unsplit, 16, mesh),
        "params": lambda: placed_prefill(cfg, wrong_wq, good, 24, "bfloat16", mesh)}
    for what, call in calls.items():
        with pytest.raises(ValueError, match=what):
            call()
    return {}


CASES = cases_of(globals())


# ------------------------------------------------------------------ the tests

@pytest.fixture(scope="module")
def rank_results():
    return spawn_ranks(__file__, WORLD, SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("case", list(CASES))
def test_placed_serving_case_on_8_gloo_ranks(rank_results, case):
    for rank, res in enumerate(rank_results):
        assert res[case]["ok"], f"rank {rank}:\n{res[case]['error']}"


if __name__ == "__main__":
    rank_main(CASES, MESH, PG_TIMEOUT_S)
