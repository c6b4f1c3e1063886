"""The readers of the program's own spans (``repro_torch.obs``), driven through
whole traced runs of both cells on the CPU at a tiny size: a CPU profiler
is started and stopped where the device trace's ``Tracer`` would be, so
the spans it touches are ``profiled`` as on the card."""

import math
import statistics
import time

import pytest
from torch.profiler import ProfilerActivity, profile

from perfbench import manifest, stats, trace
from perfbench._testing import tiny_ctx
from perfbench.drivers import serve as serve_driver
from perfbench.drivers import train as train_driver
from perfbench.run import measure
from repro_torch import obs

BENCH = manifest.load()


class CpuTracer(trace.Tracer):
    """``Tracer`` with the CPU's activity alone: no CUDA to profile or synchronise."""

    def start(self) -> None:
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._wall = time.perf_counter() - self._t0
        self.prof.stop()
        self._done, self.prof = self.prof, None


def _traced_run(cell, driver, monkeypatch, seconds=0.5):
    """(the result's metrics, the run's record, its context) of one traced run."""
    monkeypatch.setattr(trace, "Tracer", CpuTracer)
    records = []
    run = driver.run
    monkeypatch.setattr(driver, "run", lambda ctx: records.append(run(ctx)) or records[-1])
    ctx = tiny_ctx(cell, seconds=seconds)
    ctx.traced = True
    obs.reset()
    result = measure(ctx, BENCH)
    assert result["correct"], result["checks"]
    return {k: v["value"] for k, v in result["metrics"].items()}, records[0], ctx


def _window(record, ctx, name):
    t0 = (ctx.t_start + record["setup_s"]) * 1e9
    return [s for s in obs.spans() if s.name == name and s.start_ns >= t0]


def test_the_train_shares_read_the_traced_steps_of_the_window(monkeypatch):
    m, record, ctx = _traced_run("minicpm-2b.train", train_driver, monkeypatch)
    fwd, bwd, opt = (m[f"{part}_share.train"] for part in ("forward", "backward", "optimizer"))
    assert all(math.isfinite(x) and 0 < x < 100 for x in (fwd, bwd, opt))
    assert fwd + bwd + opt < 100
    steps = _window(record, ctx, "train.step")
    assert len(steps) == len(record["step_ends"])
    assert [s.profiled for s in steps] == [i < ctx.cell["trace_steps"] for i in range(len(steps))]


def test_the_decode_readers_read_the_window_waves(monkeypatch):
    m, record, ctx = _traced_run("minicpm-2b.decode", serve_driver, monkeypatch, seconds=1.0)
    for name in ("decode_host_ms.decode", "prefill_share.decode"):
        assert math.isfinite(m[name]), name
    assert 0 < m["prefill_share.decode"] < 100

    assert len(_window(record, ctx, "serve.wave")) == len(record["waves"])
    # each decode step of the window, beside its gap between tokens
    steps = list(zip(_window(record, ctx, "serve.decode"), stats.token_gaps(record), strict=True))
    quiet = [gap for s, gap in steps if not s.profiled]
    assert 0 < len(quiet) < len(steps)
    assert m["decode_host_ms.decode"] < 1e3 * statistics.mean(quiet)


@pytest.mark.parametrize("cell,names", [
    ("minicpm-2b.train", ["forward_share.train", "backward_share.train", "optimizer_share.train"]),
    ("minicpm-2b.decode", ["decode_host_ms.decode", "prefill_share.decode"])])
def test_a_program_without_spans_leaves_the_metrics_out(cell, names, monkeypatch):
    import builtins
    real = builtins.__import__

    def no_obs(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch" and "obs" in (fromlist or ()):
            raise ImportError("cannot import name 'obs' from 'repro_torch'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_obs)
    ctx = tiny_ctx(cell)
    record = {"setup_s": 0.0}
    assert [manifest.reader(n)(record, ctx) for n in names] == [None] * len(names)
    assert {m["name"] for m in manifest.metrics_of(BENCH, cell, True)} >= set(names)
