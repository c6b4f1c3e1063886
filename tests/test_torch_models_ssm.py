"""The PyTorch port's rwkv6 (ssm) and zamba2 (hybrid) models against the JAX
package, on the CPU, at the reduced configurations.

JAX-initialised fp32 parameters are carried across with
``repro_torch.interop`` (``jax.random`` bits cannot be reproduced in torch),
and the same token ids go through both packages.  T = 70 spans two WKV6
chunks (64) and one ragged SSD chunk (128).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import get_model as jax_model
from repro.models import rwkv6 as jax_rwkv6
from repro.models import zamba2 as jax_zamba2
from repro.serve.server import BatchServer as JaxBatchServer
from repro.serve.server import Request as JaxRequest
from repro_torch import interop
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import get_model
from repro_torch.serve.server import BatchServer, Request

ARCHS = ("rwkv6-1.6b", "zamba2-7b")
JAX_MODULES = {"rwkv6-1.6b": jax_rwkv6, "zamba2-7b": jax_zamba2}
B, T, SMAX = 2, 70, 80

# fp32 on both sides: only the order of summation differs
TOL_FP32 = 2e-3
# one decode step: the per-step recurrences and the cached attention sum in
# another order than the chunked prefill they continue (1e-2, as the dense
# decode test allows for its bf16 cache)
TOL_DECODE = 1e-2
# decode(prefill(x)) vs prefill(x + token), tests/test_models_smoke.py
TOL_CONSISTENCY = 3e-2


def _jax_params(cfg, seed):
    return jax_model(cfg).init(jax.random.PRNGKey(seed), jnp.float32)


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _assert_states_match(t_state, j_state, tol):
    assert set(t_state) == set(j_state)
    for name in j_state:
        got, want = t_state[name], j_state[name]
        assert str(got.dtype).split(".")[-1] == str(want.dtype), name
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_jax(arch):
    """The port's init lays out the reference's tree: leaf names, [L] stacking,
    shapes and dtypes, in fp32 and bf16."""
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jp = jax_model(get_arch(arch).reduced()).init(jax.random.PRNGKey(0), jdt)
        want = dict(_leaves(interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")))
        got = dict(_leaves(get_model(torch_get_arch(arch).reduced()).init(0, tdt, "cpu")))
        assert sorted(got) == sorted(want)
        for name, x in want.items():
            assert got[name].shape == x.shape and got[name].dtype == x.dtype, name


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg = get_arch(arch).reduced()
    jp = _jax_params(cfg, 1)
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(cfg, 1, (B, T))
    japi, tapi = jax_model(cfg), get_model(torch_get_arch(arch).reduced())

    j_logits, j_state = japi.prefill(jp, jnp.asarray(toks), SMAX, remat=False)
    t_logits, t_state = tapi.prefill(tp, torch.tensor(toks, dtype=torch.long), SMAX)
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), rtol=TOL_FP32, atol=TOL_FP32)
    _assert_states_match(t_state, j_state, TOL_FP32)

    nxt = np.asarray(jnp.argmax(j_logits[:, -1, :cfg.vocab], -1)).astype(np.int32)
    j_dec, j_state2 = japi.decode(jp, jnp.asarray(nxt[:, None]), j_state, jnp.int32(T))
    t_dec, t_state2 = tapi.decode(tp, torch.tensor(nxt[:, None], dtype=torch.long),
                                  t_state, T)
    np.testing.assert_allclose(_np(t_dec), _np(j_dec), rtol=TOL_DECODE, atol=TOL_DECODE)
    _assert_states_match(t_state2, j_state2, TOL_DECODE)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    cfg = get_arch(arch).reduced()
    jp = _jax_params(cfg, 2)
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    toks = _tokens(cfg, 2, (B, 40))
    want, _ = JAX_MODULES[arch].forward(cfg, jp, jnp.asarray(toks), remat=False)
    got = get_model(torch_get_arch(arch).reduced()).forward(
        tp, torch.tensor(toks, dtype=torch.long))
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL_FP32, atol=TOL_FP32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(prompt)) logits == prefill(prompt + token) logits, on the
    port's own parameters (tests/test_models_smoke.py)."""
    cfg = torch_get_arch(arch).reduced()
    api = get_model(cfg)
    params = api.init(3, torch.float32, "cpu")
    toks = torch.tensor(_tokens(cfg, 3, (B, 32)), dtype=torch.long)
    logits_p, cache = api.prefill(params, toks, 48)
    assert logits_p.shape == (B, 1, (cfg.vocab + 255) // 256 * 256)
    nxt = logits_p[:, -1, :cfg.vocab].argmax(-1)
    logits_d, _ = api.decode(params, nxt[:, None], cache, 32)
    assert torch.isfinite(logits_d).all()
    full, _ = api.prefill(params, torch.cat([toks, nxt[:, None]], 1), 49)
    np.testing.assert_allclose(_np(logits_d[:, 0]), _np(full[:, -1]),
                               rtol=TOL_CONSISTENCY, atol=TOL_CONSISTENCY)


def _requests(cls, vocab):
    lengths = (3, 9, 5, 7, 4)       # unequal lengths in a wave: the left-pad path
    rng = np.random.default_rng(5)
    return [cls(rid=i, prompt=rng.integers(0, vocab, n).tolist(), max_new=6)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_server_tokens_match_jax(arch):
    cfg = get_arch(arch).reduced()
    jp = _jax_params(cfg, 6)
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    want = JaxBatchServer(cfg, jp, batch=2, smax=32).serve(_requests(JaxRequest, cfg.vocab))
    got = BatchServer(torch_get_arch(arch).reduced(), tp, batch=2, smax=32,
                      device="cpu").serve(_requests(Request, cfg.vocab))
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.out for r in got] == [r.out for r in want]
    assert all(len(r.out) == 6 for r in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests in batches of 2" in out
    assert out.count("req ") == 3


def test_zamba2_prompt_longer_than_the_cache_raises():
    cfg = torch_get_arch("zamba2-7b").reduced()
    api = get_model(cfg)
    params = api.init(4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        api.prefill(params, torch.zeros((1, 9), dtype=torch.long), 8)


def test_carried_states_do_not_hold_the_layer_inputs():
    """The conv tail and the token-shift states are copies: a view would keep
    each layer's whole [B, T, ...] input alive until the states are stacked."""
    from repro_torch.models import layers, rwkv6, zamba2
    owns = lambda x: x.untyped_storage().nbytes() == x.numel() * x.element_size()
    cfg = torch_get_arch("zamba2-7b").reduced()
    params = get_model(cfg).init(5, torch.float32, "cpu")
    h = torch.randn(2, 40, cfg.d_model)
    state = zamba2.zero_state(cfg, 2, 40)
    lp = layers.unstack(params["mamba"])[0]
    _, conv, _ = zamba2.mamba_layer(cfg, lp, h, state["conv"][0], state["ssd"][0])
    assert owns(conv)
    cfg = torch_get_arch("rwkv6-1.6b").reduced()
    params = get_model(cfg).init(5, torch.float32, "cpu")
    lp = layers.unstack(params["layers"]["cmix"])[0]
    _, shift = rwkv6.cmix(lp, h, torch.zeros(2, cfg.d_model))
    assert owns(shift)
    lp = layers.unstack(params["layers"]["tmix"])[0]
    _, shift, _ = rwkv6.tmix(cfg, lp, h, torch.zeros(2, cfg.d_model),
                             torch.zeros(2, cfg.d_model // cfg.ssm_head_dim,
                                         cfg.ssm_head_dim, cfg.ssm_head_dim))
    assert owns(shift)
