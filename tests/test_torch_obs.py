"""The port's spans (``repro_torch.obs``) on the CPU: nesting, parents, self
time and the ring's bound; the ``profiled`` flag and the
profiler's events; no device call with the profiler off; and the spans of
the trainer, the train step, the datapipe, the checkpoint and the server
on a reduced config.  Nothing here depends on how long anything takes."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.launch.train import write_dataset
from repro_torch.models import get_model
from repro_torch.serve.server import BatchServer, Request
from repro_torch.storage.datapipe import ShardReader
from repro_torch.storage.volume import LocalMount
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

STEP_PARTS = ["datapipe.batch", "train.forward", "train.backward", "train.optimizer"]


@pytest.fixture(autouse=True)
def _empty_ring():
    obs.reset()
    yield
    obs.reset()


def _cpu_profiler():
    return profile(activities=[ProfilerActivity.CPU])


def test_nesting_parents_and_self_time():
    with obs.span("outer") as outer:
        with obs.span("a") as a:
            pass
        with obs.span("b") as b:
            with obs.span("c") as c:
                pass
    got = obs.spans()
    assert [s.name for s in got] == ["a", "c", "b", "outer"]     # in the order they ended
    assert (outer.parent, a.parent, b.parent, c.parent) == (None, outer, outer, b)
    assert outer.child_ns == a.host_ns + b.host_ns
    assert outer.self_ns == outer.host_ns - a.host_ns - b.host_ns >= 0
    assert b.self_ns == b.host_ns - c.host_ns and c.self_ns == c.host_ns
    assert all(s.start_ns <= s.end_ns for s in got)
    assert a.start_ns >= outer.start_ns and b.end_ns <= outer.end_ns
    assert all(s.device_ns == s.host_ns for s in got)            # no streams on the CPU
    assert not any(s.profiled for s in got)


def test_a_span_whose_body_raises_is_recorded_and_closed():
    with pytest.raises(ValueError):
        with obs.span("fails"):
            raise ValueError("body")
    with obs.span("next") as nxt:
        pass
    assert [s.name for s in obs.spans()] == ["fails", "next"]
    assert nxt.parent is None


def test_the_ring_keeps_the_newest_spans_up_to_its_bound():
    assert obs.RING == 65_536
    for i in range(obs.RING + 10):
        with obs.span(f"s{i}"):
            pass
    got = obs.spans()
    assert len(got) == obs.RING
    assert (got[0].name, got[-1].name) == ("s10", f"s{obs.RING + 9}")
    obs.reset()
    assert obs.spans() == []


def test_profiled_marks_the_span_the_session_touched_and_rises_to_its_parents():
    with obs.span("outer") as outer:
        with obs.span("middle") as middle:
            with obs.span("before") as before:
                pass
            prof = _cpu_profiler()
            prof.start()
            try:
                with obs.span("during") as during:
                    pass
            finally:
                prof.stop()
            with obs.span("after") as after:
                pass
    assert during.profiled and middle.profiled and outer.profiled
    assert not before.profiled and not after.profiled

    prof = _cpu_profiler()
    with obs.span("starts_inside") as starts:      # off at entry, on at exit
        prof.start()
    try:
        with obs.span("stops_inside") as stops:    # on at entry, off at exit
            prof.stop()
    finally:
        if torch.autograd._profiler_enabled():
            prof.stop()
    assert starts.profiled and stops.profiled


def test_a_profiled_span_is_among_the_profilers_events():
    with _cpu_profiler() as prof:
        with obs.span("p.outer"):
            with obs.span("p.inner"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert {"p.outer", "p.inner"} <= names


def _refuse(*args, **kwargs):
    raise AssertionError("a device call with the profiler off")


def test_with_the_profiler_off_a_span_makes_no_device_call(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    with obs.span("a"):
        with obs.span("b"):
            pass
    got = obs.spans()
    assert [s.name for s in got] == ["b", "a"]
    assert all(s.device_ns == s.host_ns for s in got)


class _FakeEvent:
    """A CUDA event on the CPU: records that it was recorded, and a fixed
    elapsed time of 2.5 ms to any later event."""
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.recorded = False
        _FakeEvent.made.append(self)

    def record(self):
        self.recorded = True

    def elapsed_time(self, end):
        assert self.recorded and end.recorded
        return 2.5


def test_with_the_profiler_on_a_span_takes_its_device_time_from_a_pair_of_events(monkeypatch):
    _FakeEvent.made = []
    syncs = []
    with _cpu_profiler():
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_initialized", lambda: True)
            m.setattr(torch.cuda, "Event", _FakeEvent)
            with obs.span("on") as on:
                pass
    with obs.span("off") as off:
        pass
    assert len(_FakeEvent.made) == 2 and all(e.recorded for e in _FakeEvent.made)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    obs.spans()
    obs.spans()
    assert syncs == [1]                                           # resolved once, lazily
    assert on.device_ns == 2_500_000 and off.device_ns == off.host_ns


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_arch("minicpm-2b").reduced(), n_layers=1)


def _trainer(cfg, root, ckpt_every):
    mnt = LocalMount(root)
    if not mnt.exists("/data"):
        write_dataset(mnt, cfg.vocab)
    reader = ShardReader(mnt, "/data", rank=0, world=1, batch=2, seq_len=16)
    return Trainer(cfg, topt.opt_config_for(cfg), TrainerConfig(ckpt_every=ckpt_every),
                   mnt, reader, device="cpu")


def test_trainer_spans_each_step_its_parts_and_the_checkpoint(cfg, tmp_path):
    trainer = _trainer(cfg, tmp_path, ckpt_every=2)
    obs.reset()
    trainer.train(3)
    got = obs.spans()
    steps = [s for s in got if s.name == "train.step"]
    assert len(steps) == 3 and all(s.parent is None for s in steps)
    for st in steps:
        parts = [s for s in got if s.parent is st]
        assert [s.name for s in parts] == STEP_PARTS
        assert st.child_ns == sum(s.host_ns for s in parts)
    assert sum(s.name in STEP_PARTS or s.name == "train.step" for s in got) == 5 * 3

    save, = [s for s in got if s.name == "ckpt.save"]
    assert save.parent is None
    stages = [s for s in got if s.parent is save]
    assert {s.name for s in stages} == {"ckpt.device_to_host", "ckpt.serialize",
                                        "ckpt.write", "ckpt.crc32"}
    io = trainer.ckpt.last_io
    assert io["s"] == save.host_ns / 1e9
    for name in ("device_to_host", "serialize", "write", "crc32"):
        assert io[f"{name}_s"] == pytest.approx(
            sum(s.host_ns for s in stages if s.name == f"ckpt.{name}") / 1e9)
    assert io["bytes"] > 0

    obs.reset()
    resumed = _trainer(cfg, tmp_path, ckpt_every=2)
    assert resumed.resume() and resumed.step == 2
    restore, = [s for s in obs.spans() if s.name == "ckpt.restore"]
    stages = [s for s in obs.spans() if s.parent is restore]
    assert {s.name for s in stages} == {"ckpt.read", "ckpt.crc32", "ckpt.deserialize",
                                        "ckpt.host_to_device"}
    io = resumed.ckpt.last_io
    assert set(io) == {"bytes", "s", "read_s", "crc32_s", "deserialize_s", "host_to_device_s"}
    assert io["s"] == restore.host_ns / 1e9


def test_server_spans_each_wave_its_prefill_and_decode_steps(cfg):
    params = get_model(cfg).init(0, torch.float32, "cpu")
    server = BatchServer(cfg, params, batch=3, smax=64, device="cpu")
    news = [3, 1, 5, 2, 0]
    reqs = [Request(10 + i, list(range(1, i + 3)), n) for i, n in enumerate(news)]
    served = server.serve(reqs)
    assert [len(r.out) for r in served] == news
    got = obs.spans()
    waves = [s for s in got if s.name == "serve.wave"]
    assert len(waves) == 2 and all(w.parent is None for w in waves)
    for w, steps in zip(waves, (5, 2)):                            # each wave's longest answer
        prefill = [s for s in got if s.name == "serve.prefill" and s.parent is w]
        decode = [s for s in got if s.name == "serve.decode" and s.parent is w]
        assert len(prefill) == 1 and len(decode) == steps - 1
        for d in decode:
            tokens = [s for s in got if s.parent is d]
            assert [s.name for s in tokens] == ["serve.tokens"]
            assert d.self_ns == d.host_ns - tokens[0].host_ns


def test_every_span_of_a_profiled_step_and_wave_is_among_the_profilers_events(cfg, tmp_path):
    trainer = _trainer(cfg, tmp_path, ckpt_every=1)
    server = BatchServer(cfg, trainer.params, batch=2, smax=32, device="cpu")
    obs.reset()
    with _cpu_profiler() as prof:
        trainer.train(1)
        server.serve([Request(0, [1, 2, 3], 3), Request(1, [4], 2)])
    names = {s.name for s in obs.spans()}
    assert names >= {"train.step", *STEP_PARTS, "ckpt.save", "ckpt.write", "serve.wave",
                     "serve.prefill", "serve.decode", "serve.tokens"}
    assert names <= {e.name for e in prof.events()}
    assert all(s.profiled for s in obs.spans())


def test_with_the_profiler_off_a_train_step_and_a_wave_make_no_profiler_call(
        cfg, tmp_path, monkeypatch):
    trainer = _trainer(cfg, tmp_path, ckpt_every=100)
    server = BatchServer(cfg, trainer.params, batch=2, smax=32, device="cpu")
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    obs.reset()
    trainer.train(1)
    server.serve([Request(0, [1, 2, 3], 3)])
    assert len(obs.spans()) == 5 + 1 + 1 + 2 * 2
    assert not any(s.profiled for s in obs.spans())
