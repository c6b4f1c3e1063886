"""The PyTorch port's dense models against the JAX package, on the CPU.

JAX-initialised fp32 parameters are carried across with
``repro_torch.interop`` (``jax.random`` bits cannot be reproduced in torch),
and the same token ids go through both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES, get_arch
from repro.models import get_model as jax_model
from repro.models import transformer as jax_transformer
from repro_torch import interop
from repro_torch.configs import ARCH_NAMES, get_arch as torch_get_arch
from repro_torch.models import get_model

B, T, SMAX = 2, 24, 40

# fp32 on both sides: only the order of summation differs
TOL_FP32 = 2e-3
# the bf16 cache: a value whose fp32 inputs differ in the last bits may round
# to the neighbouring bf16 number (one ulp, 2^-8 relative), and the decode
# logits computed from that cache inherit it
TOL_BF16 = 1e-2


def _params(cfg, seed=0):
    jp = jax_model(cfg).init(jax.random.PRNGKey(seed), jnp.float32)
    return jp, interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _fields_of(ref_cfg, cfg):
    """``cfg``'s fields that the reference's config has, after checking that its
    others (the port's own: the published Zamba2 block's) hold their defaults."""
    mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(ref_cfg)
    own = {f.name: f.default for f in dataclasses.fields(cfg) if f.name not in theirs}
    assert {k: mine[k] for k in own} == own
    return {k: v for k, v in mine.items() if k in theirs}


def test_configs_are_the_reference_configs():
    assert ARCH_NAMES == JAX_ARCH_NAMES
    for name in ARCH_NAMES:
        mine, ref = torch_get_arch(name), get_arch(name)
        assert _fields_of(ref, mine) == dataclasses.asdict(ref)
        assert _fields_of(ref, mine.reduced()) == dataclasses.asdict(ref.reduced())
        assert mine.param_count() == ref.param_count()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_interop_round_trip_is_bit_exact(dtype):
    cfg = get_arch("minicpm-2b").reduced()
    jp = jax_model(cfg).init(jax.random.PRNGKey(1), dtype)
    src = jax.tree.map(np.asarray, jp)
    back = interop.to_numpy(interop.to_torch(src, "cpu"))
    flat_src, tree = jax.tree.flatten(src)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat_src, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        width = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(a.view(width), b.view(width))


@pytest.mark.parametrize("arch,kv,swa", [
    ("codeqwen1.5-7b", "bfloat16", 0), ("codeqwen1.5-7b", "int8", 0),
    ("minicpm-2b", "bfloat16", 0), ("minicpm-2b", "int8", 0),
    ("codeqwen1.5-7b", "bfloat16", 16),      # ring-buffer cache, prompt > window
    ("phi3-medium-14b", "bfloat16", 0),      # GQA, 4 query heads a kv head
    ("qwen1.5-32b", "bfloat16", 0),          # qkv bias, MHA
    ("musicgen-large", "bfloat16", 0),       # audio backbone
    ("chameleon-34b", "bfloat16", 0),        # qk_norm
])
def test_prefill_and_decode_match_jax(arch, kv, swa):
    cfg = dataclasses.replace(get_arch(arch).reduced(), swa_window=swa)
    jp, tp = _params(cfg)
    toks = _tokens(cfg, 1, (B, T))
    japi = jax_model(cfg)
    tapi = get_model(dataclasses.replace(torch_get_arch(arch).reduced(),
                                         swa_window=swa))

    j_logits, j_cache = japi.prefill(jp, jnp.asarray(toks), SMAX, kv, remat=False)
    if swa and T > swa:
        # the reference keeps the last W positions in slots 0..W-1, the port
        # position j in slot j mod W, where decode writes it: the same keys,
        # rolled.  Rolled, the reference's decode is right too (its fault is
        # pinned in tests/test_torch_moe.py).
        j_cache = {n: jnp.roll(c, (T - swa) % swa, axis=2) for n, c in j_cache.items()}
    t_logits, t_cache = tapi.prefill(tp, torch.tensor(toks, dtype=torch.long),
                                     SMAX, kv)
    np.testing.assert_allclose(_np(t_logits), _np(j_logits), rtol=TOL_FP32,
                               atol=TOL_FP32)
    assert set(t_cache) == set(j_cache)
    for name in j_cache:
        assert str(t_cache[name].dtype).split(".")[-1] == str(j_cache[name].dtype)
        assert tuple(t_cache[name].shape) == j_cache[name].shape
        # int8: a value on a rounding boundary may land one step away
        tol = 1.0 if name in ("k", "v") and kv == "int8" else TOL_BF16
        np.testing.assert_allclose(_np(t_cache[name]), _np(j_cache[name]),
                                   rtol=TOL_BF16, atol=tol)

    nxt = np.asarray(jnp.argmax(j_logits[:, -1, :cfg.vocab], -1)).astype(np.int32)
    j_dec, _ = japi.decode(jp, jnp.asarray(nxt[:, None]), j_cache, jnp.int32(T))
    t_dec, _ = tapi.decode(tp, torch.tensor(nxt[:, None], dtype=torch.long),
                           t_cache, T)
    np.testing.assert_allclose(_np(t_dec), _np(j_dec), rtol=TOL_BF16, atol=TOL_BF16)


def test_forward_matches_jax():
    cfg = get_arch("codeqwen1.5-7b").reduced()
    jp, tp = _params(cfg, seed=2)
    toks = _tokens(cfg, 2, (B, T))
    j = jax_transformer.forward(cfg, jp, jnp.asarray(toks), remat=False)
    t = get_model(torch_get_arch("codeqwen1.5-7b").reduced()).forward(
        tp, torch.tensor(toks, dtype=torch.long))
    np.testing.assert_allclose(_np(t), _np(j), rtol=TOL_FP32, atol=TOL_FP32)


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES
                                  if torch_get_arch(a).family in
                                  ("dense", "audio", "vlm")])
def test_prefill_decode_consistency(arch):
    """decode(prefill(prompt)) logits == prefill(prompt + token) logits, on the
    port's own parameters (tests/test_models_smoke.py, dense cases)."""
    cfg = torch_get_arch(arch).reduced()
    api = get_model(cfg)
    params = api.init(3, torch.float32, "cpu")
    toks = torch.tensor(_tokens(cfg, 3, (B, 32)), dtype=torch.long)
    logits_p, cache = api.prefill(params, toks, 48, "bfloat16")
    assert logits_p.shape == (B, 1, (cfg.vocab + 255) // 256 * 256)
    assert torch.isfinite(logits_p).all()
    nxt = logits_p[:, -1, :cfg.vocab].argmax(-1)
    logits_d, _ = api.decode(params, nxt[:, None], cache, 32)
    assert torch.isfinite(logits_d).all()
    full, _ = api.prefill(params, torch.cat([toks, nxt[:, None]], 1), 49, "bfloat16")
    np.testing.assert_allclose(_np(logits_d[:, 0]), _np(full[:, -1]),
                               rtol=3e-2, atol=3e-2)


def test_every_family_gets_a_model():
    """Every configuration, the moe family included, gets a model whose
    reduced forward gives finite logits of the padded vocab's width."""
    families = set()
    for name in ARCH_NAMES:
        cfg = torch_get_arch(name).reduced()
        api = get_model(cfg)
        assert api.cfg == cfg
        params = api.init(0, torch.float32, "cpu")
        logits = api.forward(params, torch.zeros((1, 4), dtype=torch.long))
        assert logits.shape == (1, 4, (cfg.vocab + 255) // 256 * 256)
        assert torch.isfinite(logits).all()
        families.add(cfg.family)
    assert families == {"dense", "moe", "ssm", "hybrid", "audio", "vlm"}


def test_decode_past_the_cache_raises():
    cfg = torch_get_arch("codeqwen1.5-7b").reduced()
    api = get_model(cfg)
    params = api.init(4, torch.float32, "cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    _, cache = api.prefill(params, toks, 8)
    with pytest.raises(IndexError, match="outside"):
        api.decode(params, toks[:, :1], cache, 8)
