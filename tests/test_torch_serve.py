"""The PyTorch port's BatchServer and serving launcher, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models import get_model as jax_model
from repro.serve.server import BatchServer as JaxBatchServer
from repro.serve.server import Request as JaxRequest
from repro_torch import interop
from repro_torch.configs import get_arch as torch_get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.serve.server import BatchServer, Request


def _requests(cls, vocab):
    # unequal prompt lengths in each wave exercise the left-pad path
    lengths = (3, 9, 5, 7, 4)
    rng = np.random.default_rng(5)
    return [cls(rid=i, prompt=rng.integers(0, vocab, n).tolist(), max_new=6)
            for i, n in enumerate(lengths)]


def test_batch_server_tokens_match_jax():
    cfg = get_arch("codeqwen1.5-7b").reduced()
    jp = jax_model(cfg).init(jax.random.PRNGKey(6), jnp.float32)
    tp = interop.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    want = JaxBatchServer(cfg, jp, batch=2, smax=32).serve(
        _requests(JaxRequest, cfg.vocab))
    got = BatchServer(torch_get_arch("codeqwen1.5-7b").reduced(), tp, batch=2,
                      smax=32, device="cpu").serve(_requests(Request, cfg.vocab))
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.out for r in got] == [r.out for r in want]
    assert all(len(r.out) == 6 for r in got)


def test_batch_server_takes_temperature_and_ignores_it():
    """The reference's constructor takes ``temperature`` (fifth, or by name)
    and never reads it: decoding stays greedy."""
    cfg = torch_get_arch("codeqwen1.5-7b").reduced()
    params = interop.to_torch(jax.tree.map(np.asarray, jax_model(get_arch(
        "codeqwen1.5-7b").reduced()).init(jax.random.PRNGKey(7), jnp.float32)), "cpu")
    greedy = BatchServer(cfg, params, batch=2, smax=32, device="cpu")
    outs = [[r.out for r in srv.serve(_requests(Request, cfg.vocab))]
            for srv in (greedy, BatchServer(cfg, params, 2, 32, 0.8, device="cpu"),
                        BatchServer(cfg, params, batch=2, smax=32, temperature=1.5,
                                    device="cpu"))]
    assert outs[0] == outs[1] == outs[2]


def test_launch_serve_on_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests in batches of 2" in out
    assert out.count("req ") == 3


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_get_arch("codeqwen1.5-7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchServer(cfg, {}, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--requests", "1"])
