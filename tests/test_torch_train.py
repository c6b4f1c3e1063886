"""The port's training path against the JAX package, on the CPU.

Flash backward, cross-entropy, the loss and its gradients (dense, rwkv6 and
zamba2), the optimizer and the train step.  The same numpy inputs (and JAX-initialised
fp32 parameters, carried across with ``repro_torch.interop``) go through
both packages.  Everything here is fp32, so only the order of summation
differs; the tolerances are stated beside each check.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.kernels import ref as jref
from repro.models import get_model as jax_model
from repro.models import layers as jax_layers
from repro.models import rwkv6 as jax_rwkv6
from repro.models import transformer as jax_transformer
from repro.models import zamba2 as jax_zamba2
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import interop
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import get_model, layers
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_eval_step, make_train_step

B, T = 2, 24


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close_to_max(got, want, tol):
    """|got - want| <= tol * max|want| (tol relative to the array's largest value)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (err, float(np.abs(want).max()))


# ---------------------------------------------------------------- flash backward

def _flash_inputs(seed, tq, tk):
    """tests/test_kernel_refs.py's shapes: B 2, KV 2, G 2, hd 16."""
    rng = np.random.default_rng(seed)
    b, kv, g, hd = 2, 2, 2, 16
    return (rng.standard_normal((b, tq, kv, g, hd), dtype=np.float32),
            rng.standard_normal((b, tk, kv, hd), dtype=np.float32),
            rng.standard_normal((b, tk, kv, hd), dtype=np.float32),
            rng.standard_normal((b, tq, kv, g, hd), dtype=np.float32))


FLASH_CASES = [(96, 96, 0, 0, 32, 32), (128, 128, 32, 0, 32, 32),
               (32, 96, 0, 64, 16, 32),           # q is the suffix of the sequence
               (40, 100, 24, 60, 16, 32)]         # suffix, windowed, ragged blocks


def _jax_grads(q, k, v, co, window, q_offset, block_q, block_k):
    def f(q, k, v):
        return jnp.sum(jref.flash_attention(q, k, v, q_offset=q_offset, window=window,
                                            block_q=block_q, block_k=block_k) * co)
    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("tq,tk,window,q_offset,block_q,block_k", FLASH_CASES)
def test_plain_flash_bwd_matches_jax_custom_vjp(tq, tk, window, q_offset, block_q,
                                                block_k):
    q, k, v, co = _flash_inputs(7, tq, tk)
    want = _jax_grads(q, k, v, co, window, q_offset, block_q, block_k)
    tq_, tk_, tv_ = _t(q), _t(k), _t(v)
    _, lse = tref._flash_fwd_impl(tq_, tk_, tv_, q_offset, window, block_q, block_k)
    got = tref._flash_bwd_impl(tq_, tk_, tv_, lse, _t(co), q_offset, window, block_q,
                               block_k)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_reference_flash_bwd_nan_where_a_pad_row_sees_no_key():
    """A fault of the reference, not carried over.  With blocks of 32, the
    40 queries at 60..99 of a window-24 suffix are padded to 64 rows; pad
    rows at positions past 122 see no key, the forward gives them
    lse = -1e30, and the backward's exp(s - lse) * mask is inf * 0 = NaN in
    dk and dv.  The port masks with where() and cuts lse to Tq, so its
    gradients are finite and match autodiff through the naive attention."""
    q, k, v, co = _flash_inputs(7, 40, 100)
    want = _jax_grads(q, k, v, co, 24, 60, 32, 32)
    assert not np.isnan(np.asarray(want[0])).any()
    assert np.isnan(np.asarray(want[1])).any() and np.isnan(np.asarray(want[2])).any()
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad((tref.flash_attention(xs[0], xs[1], xs[2], q_offset=60,
                                                    window=24, block_q=32, block_k=32)
                               * _t(co)).sum(), xs)
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    naive = torch.autograd.grad(
        (tref.attention_naive(*xs, q_offset=60, window=24) * _t(co)).sum(), xs)
    for a, b in zip(got, naive):
        np.testing.assert_allclose(_np(a), _np(b), rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("tq,tk,window,q_offset,block_q,block_k", FLASH_CASES)
def test_flash_autograd_on_cpu_matches_jax_and_naive_grads(tq, tk, window, q_offset,
                                                           block_q, block_k):
    """``ops.flash_attention`` (``ref.flash_attention`` on the CPU) and
    ``ref.flash_attention`` at the test's blocks against JAX's custom VJP at 1e-5, and against
    autodiff through the naive attention at 5e-3, the bound the reference's
    test_flash_custom_vjp_matches_naive_grads uses."""
    q, k, v, co = _flash_inputs(8, tq, tk)
    want = _jax_grads(q, k, v, co, window, q_offset, 512, 1024)
    want_blocks = _jax_grads(q, k, v, co, window, q_offset, block_q, block_k)
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    naive = (tref.attention_naive(*xs, q_offset=q_offset, window=window) * _t(co)).sum()
    g_naive = torch.autograd.grad(naive, xs)
    for fn, ref_grads in (
            (lambda q, k, v: ops.flash_attention(q, k, v, window=window, q_offset=q_offset),
             want),
            (lambda q, k, v: tref.flash_attention(q, k, v, q_offset=q_offset, window=window,
                                                  block_q=block_q, block_k=block_k),
             want_blocks)):
        xs = [_t(a).requires_grad_() for a in (q, k, v)]
        got = torch.autograd.grad((fn(*xs) * _t(co)).sum(), xs)
        for a, b, c in zip(got, ref_grads, g_naive):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(_np(a), _np(c), rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------- cross-entropy

def test_cross_entropy_matches_jax_in_value_and_grad():
    """512 logit columns for a vocab of 500: the 12 padded columns are masked."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 512), dtype=np.float32) * 3
    labels = rng.integers(0, 500, (2, 9)).astype(np.int32)
    j_loss, j_grad = jax.value_and_grad(jax_layers.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), 500)
    x = _t(logits).requires_grad_()
    loss = layers.cross_entropy(x, torch.from_numpy(labels), 500)
    (grad,) = torch.autograd.grad(loss, x)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(_np(grad), np.asarray(j_grad), rtol=1e-5, atol=1e-7)
    assert float(grad[..., 500:].abs().max()) == 0.0
    bf = layers.cross_entropy(x.detach().bfloat16(), torch.from_numpy(labels), 500)
    assert bf.dtype == torch.float32


def test_cross_entropy_grad_keeps_the_reference_max_term():
    """The reference stops the gradient of the max inside the exp only, and
    adds the max back with its gradient: each row's gradient is the softmax
    minus the label's one-hot PLUS a one-hot at the row's argmax, over the
    number of rows.  The port keeps it for parity (ROADMAP.md, section 3)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((1, 6, 64), dtype=np.float32)
    labels = rng.integers(0, 64, (1, 6))
    x = _t(logits).requires_grad_()
    (grad,) = torch.autograd.grad(layers.cross_entropy(x, torch.from_numpy(labels), 64), x)
    p = torch.softmax(x.detach(), -1)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(labels), 64).float()
    argmax = torch.nn.functional.one_hot(x.detach().argmax(-1), 64).float()
    torch.testing.assert_close(grad, (p - onehot + argmax) / 6, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- loss and grads

def _model(arch, n_layers=None):
    """Reduced configs of both packages (``n_layers`` replaced if given), JAX-initialised
    fp32 params and their torch copy, and one batch."""
    cfg, tcfg = get_arch(arch).reduced(), torch_get_arch(arch).reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    jp = jax_model(cfg).init(jax.random.PRNGKey(0), jnp.float32)
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    batch_np = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    batch_t = {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch_np.items()}
    batch_j = {k: jnp.asarray(v) for k, v in batch_np.items()}
    return cfg, tcfg, jp, tp, batch_j, batch_t


def _jax_logits(cfg, p, tokens, remat):
    """The reference's training forward, with or without ``jax.checkpoint``."""
    if cfg.family == "ssm":
        return jax_rwkv6.forward(cfg, p, tokens, remat=remat)[0]
    if cfg.family == "hybrid":
        return jax_zamba2.forward(cfg, p, tokens, remat=remat)[0]
    return jax_transformer.forward(cfg, p, tokens, remat=remat)


def _path_name(path):
    return tuple(str(p.key) for p in path)


@pytest.mark.parametrize("arch,n_layers", [
    ("minicpm-2b", None), ("codeqwen1.5-7b", None), ("rwkv6-1.6b", None), ("zamba2-7b", None),
    ("zamba2-7b", 5),      # two shared-block sites and one mamba layer after the last
    ("phi3-medium-14b", None), ("qwen1.5-32b", None), ("musicgen-large", None),
    ("chameleon-34b", None),
])
@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(arch, n_layers, remat):
    """The port's one path (every layer checkpointed; for zamba2 every mamba layer
    and every shared-block site) against JAX's loss and grads with and without
    ``jax.checkpoint``.  rwkv6's and zamba2's scans take their plain chunked forms
    on the CPU, differentiated by autograd as JAX differentiates the reference's."""
    jcfg, tcfg, jp, tp, batch_j, batch_t = _model(arch, n_layers)

    def jloss(p):
        logits = _jax_logits(jcfg, p, batch_j["tokens"], remat)
        return jax_layers.cross_entropy(logits, batch_j["labels"], jcfg.vocab)

    j_loss, j_grads = jax.value_and_grad(jloss)(jp)
    np.testing.assert_allclose(float(jax_model(jcfg).loss(jp, batch_j)), float(j_loss),
                               rtol=1e-6)
    pairs = [(path, p.requires_grad_()) for path, p in topt.flatten_with_paths(tp)]
    loss = get_model(tcfg).loss(topt.unflatten(pairs), batch_t)
    grads = torch.autograd.grad(loss, [p for _, p in pairs])
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    j_flat = {_path_name(path): g for path, g in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    assert set(j_flat) == {path for path, _ in pairs}
    for (path, _), g in zip(pairs, grads):
        assert g.shape == j_flat[path].shape, path
        _close_to_max(g, j_flat[path], 1e-4)
    assert np.isclose(float(get_model(tcfg).loss(tp, batch_t)), float(j_loss), rtol=1e-5)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("kind", ["cosine", "wsd", "const"])
def test_schedule_matches_jax(kind):
    joc = jopt.OptConfig(schedule=kind, lr=1e-3, warmup_steps=5, total_steps=40)
    toc = topt.OptConfig(schedule=kind, lr=1e-3, warmup_steps=5, total_steps=40)
    for step in (0, 1, 3, 5, 10, 31, 32, 35, 40, 50):
        want = float(jopt.schedule(joc, jnp.asarray(step, jnp.int32)))
        got = float(topt.schedule(toc, torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_opt_config_for_matches_jax():
    for arch in ("minicpm-2b", "codeqwen1.5-7b", "arctic-480b", "mixtral-8x22b"):
        j = jopt.opt_config_for(get_arch(arch), lr=1e-3)
        t = topt.opt_config_for(torch_get_arch(arch), lr=1e-3)
        assert (t.schedule, t.master_weights, t.lr) == (j.schedule, j.master_weights, j.lr)
        assert str(t.moment_dtype).split(".")[-1] == jnp.dtype(j.moment_dtype).name


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32) * 2,
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    for max_norm in (1.0, 100.0):
        j_tree, j_norm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), max_norm)
        t_tree = {"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}}
        got_tree, t_norm = topt.clip_by_global_norm(t_tree, max_norm)
        np.testing.assert_allclose(float(t_norm), float(j_norm), rtol=1e-6)
        np.testing.assert_allclose(_np(got_tree["a"]), np.asarray(j_tree["a"]), rtol=1e-6)
        np.testing.assert_allclose(_np(got_tree["b"]["c"]), np.asarray(j_tree["b"]["c"]),
                                   rtol=1e-6)


def test_decay_mask_matches_jax_on_the_real_leaf_paths():
    """The rule works on the leaf's own name, quirks included: the qkv biases
    (bq, bk, bv) and every name starting with ``b`` are exempt, as are
    ln1/ln2/ln_f and q_norm/k_norm."""
    cfg = dataclasses.replace(get_arch("codeqwen1.5-7b").reduced(), qk_norm=True)
    jp = jax_model(cfg).init(jax.random.PRNGKey(0), jnp.float32)
    j_paths = jax.tree_util.tree_flatten_with_path(jp)[0]
    t_paths = [path for path, _ in topt.flatten_with_paths(
        interop.to_torch(jax.tree.map(np.asarray, jp), "cpu"))]
    assert [_path_name(p) for p, _ in j_paths] == t_paths
    got = {p: topt._decay_mask(p) for p in t_paths}
    assert got == {_path_name(p): jopt._decay_mask(p) for p, _ in j_paths}
    assert not got[("layers", "attn", "bq")] and not got[("layers", "attn", "q_norm")]
    assert got[("layers", "attn", "wq")] and got[("emb", "tok")]
    assert not topt._decay_mask(("layers", "block_scale"))      # a "b" name, not a bias


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
@pytest.mark.parametrize("master", [True, False])
def test_adamw_update_matches_jax(moment, master):
    rng = np.random.default_rng(7)
    shapes = {"w": (5, 6), "bq": (6,), "ln1": (6,)}
    params = {"emb": {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}}
    grads = {"emb": {k: rng.standard_normal(s).astype(np.float32) * 0.1
                     for k, s in shapes.items()}}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, master_weights=master)
    joc = jopt.OptConfig(moment_dtype=getattr(jnp, moment), **kw)
    toc = topt.OptConfig(moment_dtype=getattr(torch, moment), **kw)
    jp, jg = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads)
    tp, tg = interop.to_torch(params, "cpu"), interop.to_torch(grads, "cpu")
    js, ts = jopt.init_opt_state(joc, jp), topt.init_opt_state(toc, tp)
    for _ in range(3):
        jp, js = jopt.adamw_update(joc, jp, jg, js)
        tp, ts = topt.adamw_update(toc, tp, tg, ts)
    assert int(ts.step) == int(js.step) == 3
    for name in shapes:
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)) + (
                ((ts.master, js.master),) if master else ()):
            _close_to_max(got["emb"][name], want["emb"][name], 1e-5)
    assert (ts.master is None) == (not master)


# ---------------------------------------------------------------- train step

# per arch (see test_three_train_steps_match_jax): the moments' tolerance (of the
# leaf's largest value, and never below one ulp of the moment dtype there); the part
# of the learning rate summed over the steps taken that a moved element may differ by
# on top of 1e-5 of its leaf's largest value; and the part of it that an exempt
# element may differ by.  Beside each, the largest value measured on the CPU (moments;
# moved; exempt), "-" where nothing reached 1e-5 of the leaf
STEP_TOL = {
    "minicpm-2b": (1e-5, 0.0, 0.05),            # 8.7e-6; -; 2.1e-2
    "rwkv6-1.6b": (5e-5, 2e-4, 0.25),           # 1.7e-5; 7.9e-5; -
    "zamba2-7b": (5e-5, 2e-4, 0.25),            # 1.7e-5; 7.9e-5; 1.06e-1
    "codeqwen1.5-7b": (1e-5, 1e-4, 0.05),       # 5.8e-6; 1.9e-5 (bq); 2.9e-2 (bk)
    "qwen1.5-32b": (1e-5, 1e-4, 0.05),          # as codeqwen1.5-7b: equal reduced configs
    "phi3-medium-14b": (1e-4, 3e-3, 0.05),      # 4.3e-5; 1.38e-3; 2.2e-2
    "musicgen-large": (5e-5, 0.0, 0.05),        # 1.3e-5; -; 4.2e-2
    "chameleon-34b": (2e-5, 0.0, 0.1),          # 8.3e-6; -; 4.8e-2
    "mixtral-8x22b": (1e-5, 2 ** -7, 0.1),      # one bf16 ulp; 2.2e-3; 4.7e-2
    "arctic-480b": (1e-5, 2 ** -7, 0.1),        # one bf16 ulp; 2.2e-3; 5.1e-2
}


@pytest.mark.parametrize("arch", list(STEP_TOL))
def test_three_train_steps_match_jax(arch):
    """Reduced minicpm-2b (WSD, depth-scaled residual, tied embeddings) with
    fp32 master weights, reduced rwkv6-1.6b and zamba2-7b (cosine, their scans'
    backward through the plain chunked forms), and the seven attention archs
    (cosine; fp32 master weights and moments, but bf16 moments and no master
    weights for mixtral-8x22b and arctic-480b, as ``opt_config_for`` gives them):
    step, metrics, moments, params and master weights (where kept) after each of 3
    steps of ``make_train_step`` against the JAX one under ``jax.jit``, within
    1e-5 (relative, or of the leaf's largest value).

    One set of elements is exempt from 1e-5: those whose gradient fell below
    1e-5 of its leaf's largest at some step taken (about 0.1% of them).
    AdamW moves each element by lr * mu / (sqrt(nu) + eps), about
    lr * g / (|g| + eps) on the first step, whatever the gradient's size; for
    a gradient that small the fp32 noise of the two summation orders is a
    sizable part of it, and the step carries that noise at full size.  They
    get 5% of the learning rate summed over the steps taken (measured here:
    at most 2.1% of one step's lr).  Every other element is held to 1e-5 of
    its leaf's largest value (measured: at most 8.7e-6), at least five times
    under one step's weight decay (lr * 0.1 * |w|) on the leaf's largest
    weights, so a missing or misplaced decay fails.

    rwkv6's and zamba2's gradients agree to about 2e-5 of their leaf's largest
    (their scans sum in other orders), so their moments are held to 5e-5 of it
    (measured: at most 1.7e-5).  They have leaves that start constant (the
    token-shift mixes maa_*, conv_b, A_log): their largest value is itself a
    few steps, so 1e-5 of it is 1e-5 of one step.  Their moved elements also
    get 2e-4 of the summed lr (measured: at most 7.9e-5 of it beyond 1e-5 of
    the leaf, zamba2's conv_b; a missing decay, 1e-4 of a weight a step, still
    fails on the leaves of random weights), and the exempt ones 25% of it
    (measured: 10.6%, zamba2's emb.out: an element whose gradient is near
    Adam's eps moves by about lr * g / eps, noise and all).

    The attention archs (STEP_TOL gives each measured value):
    - The key bias bk (codeqwen1.5-7b, qwen1.5-32b) is exempt as a whole.  A
      bias added to every key adds q . bk to all of a query's scores, which the
      softmax removes, so bk's gradient is zero but for RoPE, which rotates bk
      by each key's position.  Over the test's 24 positions the slow rotary
      pairs turn by almost nothing (a pair at frequency theta^(-2i/hd) by
      24 theta^(-2i/hd) rad), and their gradient is a cancellation, 1e-4 to 1e-5
      of the fast pairs', which the two summation orders leave with 3-80%
      relative noise; AdamW turns that into whole steps.  bq starts at zero, so
      1e-5 of its largest value is 1e-5 of a few steps: its moved elements get
      1e-4 of the summed lr.
    - phi3-medium-14b (GQA 4:1 at these widths) and musicgen-large amplify
      rounding: the port's own step from params moved by one fp32 ulp (a
      relative 2^-23 draw) moves phi3's moments by 2.4e-4 of a leaf's largest
      value after step 2 and musicgen's by 7.6e-6 (minicpm-2b's by 2.1e-5),
      more than the two packages differ.  So their moments get 1e-4 and 5e-5,
      and phi3's moved elements, whose gradients near 1e-5 of their leaf carry
      that noise, 3e-3 of the summed lr.
    - bf16 moments (mixtral-8x22b, arctic-480b): both packages round the fp32
      moment to bf16, and a value on either side of a rounding boundary lands
      one ulp apart; so a moment is held to one bf16 ulp of its leaf's largest
      value, and a moved element to 2^-7 of the summed lr (one ulp's relative
      error in mu / sqrt(nu)) on top of 1e-5 of its leaf, the exempt ones to
      10% of it."""
    jcfg, tcfg, jp, tp, batch_j, batch_t = _model(arch)
    moment_tol, moved_tol, exempt_tol = STEP_TOL[arch]
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    joc, toc = jopt.opt_config_for(jcfg, **kw), topt.opt_config_for(tcfg, **kw)
    assert (toc.schedule, toc.master_weights) == (joc.schedule, joc.master_weights)
    assert arch != "minicpm-2b" or (toc.master_weights and toc.schedule == "wsd")
    j_step = jax.jit(jax_make_train_step(jcfg, joc))
    j_grad = jax.jit(jax.grad(jax_model(jcfg).loss))
    t_step = make_train_step(tcfg, toc)
    js, ts = jopt.init_opt_state(joc, jp), topt.init_opt_state(toc, tp)
    lr_sum, tiny = 0.0, {}
    for _ in range(3):
        for path, g in jax.tree_util.tree_flatten_with_path(j_grad(jp, batch_j))[0]:
            g = np.abs(np.asarray(g))
            now = g < 1e-5 * g.max()
            if _path_name(path)[-1] == "bk":        # RoPE's part only: see above
                now[...] = True
            tiny[_path_name(path)] = tiny.get(_path_name(path), now) | now
        jp, js, jm = j_step(jp, js, batch_j)
        tp, ts, tm = t_step(tp, ts, batch_t)
        assert int(ts.step) == int(js.step)
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5)
        lr_sum += float(jm["lr"])
        for got_tree, want_tree, moved in ((tp, jp, True), (ts.mu, js.mu, False),
                                           (ts.nu, js.nu, False),
                                           (ts.master, js.master, True))[:4 if js.master else 3]:
            want = {_path_name(p): x for p, x in
                    jax.tree_util.tree_flatten_with_path(want_tree)[0]}
            for path, got in topt.flatten_with_paths(got_tree):
                w = np.asarray(want[path], np.float32)
                err = np.abs(_np(got) - w)
                exempt = tiny[path] if moved else np.zeros_like(tiny[path])
                w_max = float(np.abs(w).max())
                ulp = torch.finfo(got.dtype).eps * 2.0 ** math.floor(
                    math.log2(max(w_max, 1e-30)))
                bound = (1e-5 * w_max + moved_tol * lr_sum if moved
                         else max(moment_tol * w_max, ulp))
                assert float(err[~exempt].max(initial=0.0)) <= bound, path
                assert float(err[exempt].max(initial=0.0)) <= exempt_tol * lr_sum, path
    assert all(not p.requires_grad and p.grad is None for _, p in topt.flatten_with_paths(tp))
    np.testing.assert_allclose(float(make_eval_step(tcfg)(tp, batch_t)),
                               float(jax_model(jcfg).loss(jp, batch_j)), rtol=1e-5)
