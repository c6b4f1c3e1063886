"""What decides ``correct``, driven through the rest of a run on the CPU at a
tiny size (the look for a card skipped): a sound program passes every
cell's limits; a training step that leaves its state unchanged, half of the
batch left out (the mean over the rest), a served token altered where it is
produced, a decode step that leaves its cache unchanged, and the control
(the reference in fp8 in the program's place) each fail them."""

import pytest
import torch

from perfbench import check, manifest
from perfbench._testing import tiny_ctx
from perfbench.drivers import serve as serve_driver
from perfbench.drivers import train as train_driver
from perfbench.run import measure

BENCH = manifest.load()
TRAIN = [w["name"] for w in BENCH["workloads"]
         if manifest.cell(BENCH, w["name"])["cell"]["driver"] == "train"]
SERVE = [w["name"] for w in BENCH["workloads"]
         if manifest.cell(BENCH, w["name"])["cell"]["driver"] == "serve"]
ALL = TRAIN + SERVE
# the served model's width (its logits' scale), at four layers and a small
# vocabulary, so fp8's error reaches the size it has in the cell
SERVE_CONTROL = dict(n_layers=4, d_model=2304, n_heads=36, head_dim=64, d_ff=1024, vocab=8192)


def _run(ctx):
    result = measure(ctx, BENCH)
    assert set(result["checks"]) == set(ctx.cell["limits"])
    return result


@pytest.mark.parametrize("cell", ALL)
def test_a_sound_program_is_correct(cell):
    result = _run(tiny_ctx(cell))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert {"setup_s"} <= set(result["metrics"])


def _state_unchanged(trainer):
    step = trainer.step_fn

    def frozen(params, state, batch):
        tensors = [t for tree in (params, state.mu, state.nu, state.master or {})
                   for _, t in train_driver.weights.flatten(tree)]
        saved = [t.clone() for t in tensors]
        out = step(params, state, batch)
        for t, s in zip(tensors, saved):
            t.copy_(s)
        return params, state, out[2]
    trainer.step_fn = frozen


def _half_batch(trainer):
    step = trainer.step_fn
    trainer.step_fn = lambda params, state, batch: step(
        params, state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch], ids=["unchanged", "half"])
@pytest.mark.parametrize("cell", TRAIN)
def test_a_training_fault_is_not_correct(cell, fault):
    ctx = tiny_ctx(cell)
    ctx.hooks["trainer"] = fault
    assert not _run(ctx)["correct"]


def _altered_token(server):
    api = server.api
    vocab = server.cfg.vocab

    def bump(out):
        logits, cache = out
        top = logits[:, -1, :vocab].argmax(-1)
        logits[torch.arange(logits.shape[0]), -1, (top + 1) % vocab] += 1e4
        return logits, cache
    calls = {"n": 0}

    def prefill(*a, **k):
        calls["n"] += 1
        return bump(api.prefill(*a, **k)) if calls["n"] == 2 else api.prefill(*a, **k)
    server.api = serve_driver.dataclasses.replace(api, prefill=prefill)


@pytest.mark.parametrize("cell", SERVE)
def test_a_served_token_altered_is_not_correct(cell):
    ctx = tiny_ctx(cell)
    ctx.hooks["server"] = _altered_token
    assert not _run(ctx)["correct"]


def _cache_unchanged(server):
    api = server.api

    def decode(params, token, cache, cache_len):
        saved = {k: v.clone() for k, v in cache.items()}
        logits, out = api.decode(params, token, cache, cache_len)
        for k, v in out.items():
            v.copy_(saved[k])
        return logits, out
    server.api = serve_driver.dataclasses.replace(api, decode=decode)


@pytest.mark.parametrize("cell", SERVE)
def test_a_decode_step_that_leaves_its_cache_unchanged_is_not_correct(cell):
    ctx = tiny_ctx(cell, **SERVE_CONTROL)
    ctx.hooks["server"] = _cache_unchanged
    assert not _run(ctx)["correct"]


@pytest.mark.parametrize("cell", ALL)
def test_the_control_is_not_correct(cell):
    ctx = tiny_ctx(cell, **SERVE_CONTROL) if cell in SERVE else tiny_ctx(cell)
    driver = train_driver if cell in TRAIN else serve_driver
    ctx.extra_readings["control"] = driver.control_readings
    record = driver.run(ctx)
    assert check.judge(record["numbers"], ctx.cell["limits"])["correct"]
    assert not check.judge(record["readings"]["control"], ctx.cell["limits"])["correct"], \
        record["readings"]["control"]
