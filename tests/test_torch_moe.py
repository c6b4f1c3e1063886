"""The port's MoE family (mixtral-8x22b, arctic-480b) against the JAX package, on the CPU.

JAX-initialised fp32 parameters are carried across with
``repro_torch.interop``, and the same numpy inputs go through both
packages.  Routing is integer bookkeeping on top of an fp32 softmax, so
the experts, slots and drops must be equal; values are fp32 on both sides
and differ only in the order of summation.  Each tolerance is stated at
its check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import get_model as jax_model
from repro.models import moe as jmoe
from repro.models import transformer as jax_transformer
from repro.serve.server import BatchServer as JaxBatchServer
from repro.serve.server import Request as JaxRequest
from repro_torch import interop
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model, moe
from repro_torch.serve.server import BatchServer, Request
from repro_torch.train import optimizer as topt

ARCHS = ["mixtral-8x22b", "arctic-480b"]
B, T, SMAX = 2, 24, 40
TOL_FP32 = 2e-3         # logits, as tests/test_torch_models.py
TOL_BF16 = 1e-2         # the bf16 KV cache, and decode logits computed from it


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_arch(arch).reduced(), **kw),
            dataclasses.replace(torch_get_arch(arch).reduced(), **kw))


def _params(jcfg, seed=0):
    jp = jax_model(jcfg).init(jax.random.PRNGKey(seed), jnp.float32)
    return jp, interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


# ---------------------------------------------------------------- routing and the block

# capacity factors: the configs' 1.25, n_experts (no token can drop), 0.5 (many drop)
CAPACITY_FACTORS = [1.25, 4.0, 0.5]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", CAPACITY_FACTORS)
def test_route_matches_jax(arch, capacity_factor):
    """Experts, slots and drops equal; top_w within 1e-6."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, _ = _params(jcfg)
    router = np.array(_layer0(jp["layers"])["moe"]["router"])
    xg = np.random.default_rng(1).standard_normal((4, 32, jcfg.d_model)).astype(np.float32)
    capacity = int(32 * jcfg.top_k / jcfg.n_experts * capacity_factor) + 1
    want = jmoe._route(jcfg, jnp.asarray(router), jnp.asarray(xg), capacity)
    got = moe._route(tcfg, torch.from_numpy(router), torch.from_numpy(xg), capacity)
    for name, g, w in zip(("scatter_e", "scatter_p", "keep"), got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0, atol=1e-6)
    keep = got[2].numpy()
    if capacity_factor == tcfg.n_experts:
        assert keep.all()
    if capacity_factor < 1:
        assert not keep.all()            # drops are exercised
        assert (got[0].numpy()[~keep] == jcfg.n_experts - 1).all()
        assert (got[1].numpy()[~keep] == capacity - 1).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", CAPACITY_FACTORS)
def test_moe_block_matches_jax(arch, capacity_factor):
    """moe_block (arctic with its dense residual) within 1e-5, with and
    without dropped tokens."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=capacity_factor)
    jp, tp = _params(jcfg, seed=1)
    jl, tl = _layer0(jp["layers"]), {k: v[0] if not isinstance(v, dict) else
                                     {n: w[0] for n, w in v.items()}
                                     for k, v in tp["layers"].items()}
    assert ("mlp" in tl) == (arch == "arctic-480b") == jcfg.dense_residual
    x = np.random.default_rng(2).standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    jmlp = jl.get("mlp") if jcfg.dense_residual else None
    want = jmoe.moe_block(jcfg, jl["moe"], jnp.asarray(x), mlp=jmlp)
    got = moe.moe_block(tcfg, tl["moe"], torch.from_numpy(x),
                        mlp=tl.get("mlp") if tcfg.dense_residual else None)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    # this input drops tokens at capacity factors 1.25 and 0.5, none at 4
    n, G = B * T, moe.n_groups(B * T)
    cap = int(n // G * tcfg.top_k / tcfg.n_experts * capacity_factor) + 1
    keep = moe._route(tcfg, tl["moe"]["router"], torch.from_numpy(x).reshape(G, n // G, -1),
                      cap)[2]
    assert bool(keep.all()) == (capacity_factor == tcfg.n_experts)


def test_load_balance_loss_matches_jax():
    jcfg, tcfg = _cfgs("arctic-480b")
    rng = np.random.default_rng(3)
    probs = jax.nn.softmax(jnp.asarray(rng.standard_normal((64, jcfg.n_experts)),
                                       jnp.float32), -1)
    top_e = np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])
    want = jmoe.load_balance_loss(jcfg, probs, jnp.asarray(top_e))
    got = moe.load_balance_loss(tcfg, torch.from_numpy(np.asarray(probs)),
                                torch.from_numpy(top_e).long())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------- the model

def _path_name(path):
    return tuple(str(p.key) for p in path)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    """Logits within 2e-3, the loss within 1e-5 (relative) and every gradient
    leaf within 1e-4 of its largest value, as tests/test_torch_train.py holds
    the dense model.  The reduced config drops tokens here (capacity 2 for
    the 6 choices of a group of 3 tokens), in both packages alike."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=4)
    toks = _tokens(jcfg, 4, (B, T + 1))
    batch_j = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    batch_t = {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch_j.items()}
    api = get_model(tcfg)
    np.testing.assert_allclose(
        _np(api.forward(tp, batch_t["tokens"])),
        np.asarray(jax_transformer.forward(jcfg, jp, batch_j["tokens"], remat=False)),
        rtol=TOL_FP32, atol=TOL_FP32)
    j_loss, j_grads = jax.value_and_grad(jax_model(jcfg).loss)(jp, batch_j)
    pairs = [(path, p.requires_grad_()) for path, p in topt.flatten_with_paths(tp)]
    loss = api.loss(topt.unflatten(pairs), batch_t)
    grads = torch.autograd.grad(loss, [p for _, p in pairs])
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    j_flat = {_path_name(p): g for p, g in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    assert set(j_flat) == {path for path, _ in pairs}
    assert ("layers", "moe", "router") in j_flat
    for (path, _), g in zip(pairs, grads):
        want = np.asarray(j_flat[path])
        err = float(np.abs(_np(g) - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-30), (path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """With capacity_factor = n_experts (no drops), as the reference's
    test_prefill_decode_consistency sets it."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=float(get_arch(arch).reduced().n_experts))
    jp, tp = _params(jcfg, seed=5)
    toks = _tokens(jcfg, 5, (B, T))
    japi, tapi = jax_model(jcfg), get_model(tcfg)
    j_logits, j_cache = japi.prefill(jp, jnp.asarray(toks), SMAX, remat=False)
    t_logits, t_cache = tapi.prefill(tp, torch.from_numpy(toks).long(), SMAX)
    np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), rtol=TOL_FP32,
                               atol=TOL_FP32)
    for name in j_cache:
        assert tuple(t_cache[name].shape) == j_cache[name].shape
        np.testing.assert_allclose(_np(t_cache[name]), _np(j_cache[name]), rtol=TOL_BF16,
                                   atol=TOL_BF16)
    nxt = np.asarray(jnp.argmax(j_logits[:, -1, :jcfg.vocab], -1)).astype(np.int32)
    j_dec, _ = japi.decode(jp, jnp.asarray(nxt[:, None]), j_cache, jnp.int32(T))
    t_dec, _ = tapi.decode(tp, torch.from_numpy(nxt[:, None]).long(), t_cache, T)
    np.testing.assert_allclose(_np(t_dec), np.asarray(j_dec), rtol=TOL_BF16, atol=TOL_BF16)


def test_moe_capacity_drops_are_bounded():
    """Router + capacity: most tokens must be routed, not dropped
    (tests/test_models_smoke.py), and the loss is finite."""
    cfg = torch_get_arch("mixtral-8x22b").reduced()
    api = get_model(cfg)
    params = api.init(3, torch.float32, "cpu")
    toks = torch.from_numpy(_tokens(cfg, 4, (B, 32))).long()
    loss = api.loss(params, {"tokens": toks, "labels": torch.roll(toks, -1, 1)})
    assert torch.isfinite(loss)
    h = params["emb"]["tok"][toks]
    n = h.shape[0] * h.shape[1]
    G = moe.n_groups(n)
    cap = int(n // G * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    keep = moe._route(cfg, params["layers"]["moe"]["router"][0], h.reshape(G, n // G, -1),
                      cap)[2]
    assert keep.float().mean() > 0.5


def test_swa_restricts_context():
    """mixtral's sliding window: distant tokens do not affect the logits
    (tests/test_models_smoke.py, same tolerance 1e-4)."""
    cfg = dataclasses.replace(torch_get_arch("mixtral-8x22b").reduced(), swa_window=8,
                              n_layers=1)
    api = get_model(cfg)
    params = api.init(5, torch.float32, "cpu")
    t = 32
    toks = torch.from_numpy(_tokens(cfg, 6, (1, t))).long()
    logits1, _ = api.prefill(params, toks, t)
    toks2 = toks.clone()
    toks2[0, 0] = (toks2[0, 0] + 1) % cfg.vocab         # outside the window
    logits2, _ = api.prefill(params, toks2, t)
    np.testing.assert_allclose(_np(logits1), _np(logits2), rtol=1e-4, atol=1e-4)
    toks3 = toks.clone()
    toks3[0, -3] = (toks3[0, -3] + 1) % cfg.vocab       # inside it
    assert not torch.allclose(logits1, api.prefill(params, toks3, t)[0], atol=1e-4)


# ---------------------------------------------------------------- the SWA ring

W, T_LONG = 8, 11       # a prompt longer than the window, not a multiple of it


def _decode_vs_forward(prefill, decode, forward, toks):
    """Max |decode logit - forward logit| over the first two decode steps."""
    logits, cache = prefill(toks)
    seq, errs = toks, []
    for i in range(2):
        nxt = np.asarray(_np(logits)[:, -1, :512].argmax(-1)).astype(np.int64)[:, None]
        seq = np.concatenate([seq, nxt], 1)
        logits, cache = decode(nxt, cache, T_LONG + i)
        full = forward(seq)
        errs.append(float(np.abs(_np(logits)[:, 0] - _np(full)[:, -1]).max()))
    return errs


def test_swa_decode_past_the_window_matches_forward():
    """Prefill stores position j in ring slot j mod W, so the first two decode
    steps after a prompt of 11 tokens (W = 8) match a full forward, within
    3e-2 (the bf16 cache; tests/test_models_smoke.py's tolerance)."""
    _, tcfg = _cfgs("mixtral-8x22b", swa_window=W, capacity_factor=4.0)
    api = get_model(tcfg)
    params = api.init(7, torch.float32, "cpu")
    toks = _tokens(tcfg, 7, (B, T_LONG)).astype(np.int64)
    errs = _decode_vs_forward(
        lambda x: api.prefill(params, torch.from_numpy(x), 16),
        lambda x, c, n: api.decode(params, torch.from_numpy(x), c, n),
        lambda x: api.forward(params, torch.from_numpy(x)), toks)
    assert max(errs) <= 3e-2, errs


def test_reference_swa_decode_past_the_window_diverges():
    """The reference's fault, pinned: its prefill keeps the last W keys in
    slots 0..W-1 while decode writes position p at slot p mod W, so the same
    decode steps miss a full forward by far more than the cache's rounding
    (measured on the CPU: 0.66 and 1.75, for logits up to 2.3 in size; the
    port's test above measures 1.2e-2 and 6.5e-3)."""
    jcfg, _ = _cfgs("mixtral-8x22b", swa_window=W, capacity_factor=4.0)
    api = jax_model(jcfg)
    params = api.init(jax.random.PRNGKey(7), jnp.float32)
    toks = _tokens(jcfg, 7, (B, T_LONG))
    errs = _decode_vs_forward(
        lambda x: api.prefill(params, jnp.asarray(x, jnp.int32), 16, remat=False),
        lambda x, c, n: api.decode(params, jnp.asarray(x, jnp.int32), c, jnp.int32(n)),
        lambda x: jax_transformer.forward(jcfg, params, jnp.asarray(x, jnp.int32),
                                          remat=False), toks)
    assert min(errs) > 0.1, errs


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", ARCHS)
def test_batch_server_tokens_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=6)
    lengths = (3, 9, 5, 7, 4)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jcfg.vocab, n).tolist() for n in lengths]
    want = JaxBatchServer(jcfg, jp, batch=2, smax=32).serve(
        [JaxRequest(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    got = BatchServer(tcfg, tp, batch=2, smax=32, device="cpu").serve(
        [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)])
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.out for r in got] == [r.out for r in want]


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_moe_on_cpu(arch, capsys):
    launch_serve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests in batches of 2" in out
    assert out.count("req ") == 3
