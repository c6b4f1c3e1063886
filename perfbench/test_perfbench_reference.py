"""The plain reference against the port at the port's reduced configurations,
on the CPU in float32: the parameter tree, the loss and every gradient, the
optimizer's three steps, and serving's logits through prefill and decode."""

import dataclasses
import statistics

import pytest
import torch

from perfbench import weights
from perfbench.reference import layout, model
from perfbench.reference import train as ref_train

ARCHS = ["minicpm-2b"]


def _setup(name, seed=2**31 + 3):
    from repro_torch.configs import get_arch
    from repro_torch.models import get_model
    cfg = get_arch(name).reduced()
    arch = dataclasses.asdict(cfg)
    lay = layout.layout(arch)
    return cfg, arch, lay, get_model(cfg), weights.make(lay, seed, torch.float32, "cpu")


def _batch(vocab, b=2, t=40, seed=0):
    toks = torch.randint(0, vocab, (b, t + 1), generator=torch.Generator().manual_seed(seed))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("name", ARCHS)
def test_the_layout_is_the_programs_tree(name):
    cfg, arch, lay, api, _ = _setup(name)
    for dtype in (torch.float32, torch.bfloat16):
        tree = api.init(0, dtype, "cpu")
        weights.fill(tree, lay, 5, dtype)
        again = weights.make(lay, 5, dtype, "cpu")
        for path, t in weights.flatten(tree):
            assert torch.equal(t, again[path]), path


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_every_gradient_match_the_port(name):
    cfg, arch, lay, api, w = _setup(name)
    batch = _batch(cfg.vocab)
    pairs = [(p, t.clone().requires_grad_()) for p, t in w.items()]
    loss = api.loss(weights.nest(dict(pairs)), batch)
    grads = torch.autograd.grad(loss, [t for _, t in pairs])
    ref_loss, ref_grads = ref_train.loss_and_grads(arch, {p: t.clone() for p, t in w.items()},
                                                   batch)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    med = statistics.median(float(g.norm()) for g in ref_grads.values())
    for (path, _), g in zip(pairs, grads):
        r = ref_grads[path]
        assert float((g - r).norm()) <= 1e-4 * max(float(r.norm()), med), path


@pytest.mark.parametrize("name", ARCHS)
def test_three_optimizer_steps_match_the_port(name):
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    cfg, arch, lay, api, w = _setup(name)
    spec = {"lr": 1e-2, "betas": [0.9, 0.95], "eps": 1e-8, "weight_decay": 0.1,
            "clip_norm": 1.0, "warmup_steps": 2, "total_steps": 10, "stable_frac": 0.5,
            "schedule": "wsd" if cfg.lr_schedule == "wsd" else "cosine"}
    oc = opt.opt_config_for(cfg, **dict(spec, betas=tuple(spec["betas"])))
    params = weights.nest({p: t.clone() for p, t in w.items()})
    state = opt.init_opt_state(oc, params)
    step = make_train_step(cfg, oc)
    batches = [_batch(cfg.vocab, seed=s) for s in range(3)]
    losses = []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    ref_params = {p: t.clone() for p, t in w.items()}
    ref = ref_train.train(arch, ref_params, spec, batches)
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    for path, t in weights.flatten(params):
        moved = float((ref_params[path] - w[path]).norm())
        assert float((t - ref_params[path]).norm()) <= 1e-3 * moved + 1e-7, path


def test_serving_logits_through_prefill_and_decode_match_a_full_forward():
    cfg, arch, lay, api, w = _setup("minicpm-2b")
    params = weights.nest(w)
    toks = torch.randint(0, cfg.vocab, (3, 21), generator=torch.Generator().manual_seed(1))
    toks[0, :6] = 0                                 # a left-padded row, as a wave pads it
    with torch.no_grad():
        logits, cache = api.prefill(params, toks[:, :16], 24)
        got = [logits[:, -1, :cfg.vocab]]
        for i in range(16, 20):
            logits, cache = api.decode(params, toks[:, i:i + 1], cache, i)
            got.append(logits[:, -1, :cfg.vocab])
    want = model.forward_logits(arch, w, toks[:, :20])[:, 15:20]
    got = torch.stack(got, 1)
    scale = float(want.abs().max())
    assert float((got[:, 0] - want[:, 0]).abs().max()) <= 1e-4 * scale
    # decode reads the K/V cache, which the program keeps in bfloat16 whatever
    # its weights' type: two of bfloat16's relative steps (2**-8) of the largest logit
    assert float((got - want).abs().max()) <= 2 * 2**-8 * scale
