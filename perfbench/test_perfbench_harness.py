"""The harness on the CPU: the manifest, the generator, the readers' arithmetic,
the model flops, the frozen work counts and what the benchmark may import."""

import ast
import json
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from perfbench import flops, manifest, stats, traffic, work
from perfbench.run import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parent
BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# ------------------------------------------------------------------ manifest

def test_manifest_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/")


def test_every_per_layer_metric_moves_a_metric_all_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in moved.get("workloads", CELLS), (m["name"], cell)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in layer and len(layer) <= 200 for layer in layers)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files_and_reports_setup_another_metric_and_a_layer(cell):
    found = manifest.cell(BENCH, cell)
    e2e = {m["name"] for m in manifest.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.metrics_of(BENCH, cell, True)
    assert layer
    for m in manifest.metrics_of(BENCH, cell, False) + layer:
        assert callable(manifest.reader(m["name"]))
    assert found["cell"]["driver"] in ("train", "serve")
    assert found["traffic"]["kind"] == found["cell"]["driver"]
    assert set(found["cell"]["limits"]) >= {"logit_gap"} or \
        set(found["cell"]["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}


# ------------------------------------------------------------------ traffic

def test_train_documents_are_the_seeds_and_inside_their_range():
    mix = json.loads((HERE / "traffic" / "pretrain_2x2048.json").read_text())
    a = traffic.documents(mix, 1000, 2**31 + 5, 200_000)
    b = traffic.documents(mix, 1000, 2**31 + 5, 200_000)
    c = traffic.documents(mix, 1000, 2**31 + 6, 200_000)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    lo, hi = mix["doc_tokens"]
    assert all(lo <= len(d) <= hi and d.min() >= 0 and d.max() < 1000 for d in a + c)
    block = mix["length_grid"]
    assert sorted(map(len, a[:block])) == sorted(map(len, c[:block]))
    assert [len(d) for d in a[:block]] != [len(d) for d in c[:block]]


SERVE_MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json")
                     if json.loads(p.read_text())["kind"] == "serve")


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_serve_waves_are_the_seeds_and_every_seed_sends_the_same_waves(name):
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    n = mix["length_grid"] // mix["batch"]

    def block(seed):
        g = traffic.waves(mix, 500, seed)
        return [next(g) for _ in range(n)]

    a, b, c = block(2**31 + 1), block(2**31 + 1), block(2**31 + 2)
    for (pa, na), (pb, nb) in zip(a, b):
        assert na == nb and all(np.array_equal(x, y) for x, y in zip(pa, pb))
    lo, hi = mix["prompt_tokens"]
    nlo, nhi = mix["new_tokens"]
    for prompts, news in a + c:
        assert len(prompts) == len(news) == mix["batch"]
        assert all(lo <= len(p) <= hi for p in prompts)
        assert all(nlo <= k <= nhi for k in news)
    shape = lambda ws: sorted((tuple(sorted(map(len, p))), tuple(sorted(k))) for p, k in ws)  # noqa: E731
    assert shape(a) == shape(c)
    assert [k for _, k in a] != [k for _, k in c]


# ------------------------------------------------------------------ readers

def _serve_record(gaps_per_wave, waves=20, batch=4, ttft=0.5):
    out, t = [], 0.0
    for w in range(waves):
        start = t
        entries = [start]
        t += ttft
        for g in gaps_per_wave(w):
            entries.append(t)
            t += g
        out.append({"start": start, "entries": entries, "end": t, "max_p": 100,
                    "new": [len(entries)] * batch})
    return {"waves": out, "window_s": t, "batch": batch}


def _read(metric, record, ctx=None):
    return manifest.reader(metric)(record, ctx)


def test_tail_is_over_every_gap_and_moves_with_a_stall():
    steady = _serve_record(lambda w: [0.1] * 10)
    stalled = _serve_record(lambda w: [0.1] * 9 + [0.5])
    assert _read("tpot_p95_ms", steady) == pytest.approx(100.0)
    assert _read("tpot_p95_ms", stalled) == pytest.approx(500.0)
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_rates_are_over_the_whole_window_and_fall_with_a_stall():
    steady = _serve_record(lambda w: [0.1] * 10)
    stalled = _serve_record(lambda w: [0.1] * 10 if w != 3 else [0.1] * 9 + [2.0])
    r0, r1 = _read("decode_tokens_per_s", steady), _read("decode_tokens_per_s", stalled)
    assert r0 == pytest.approx(20 * 11 * 4 / steady["window_s"])
    assert r1 < r0 * 0.95
    train = {"step_ends": [0.5 * (i + 1) for i in range(40)], "tokens_per_step": 4096}
    slow = dict(train, step_ends=train["step_ends"][:20] + [e + 3 for e in train["step_ends"][20:]])
    for rec in (train, slow):
        rec["window_s"] = rec["step_ends"][-1]
    assert _read("train_tokens_per_s", train) == pytest.approx(40 * 4096 / 20.0)
    assert _read("train_tokens_per_s", slow) < _read("train_tokens_per_s", train) * 0.9


def test_decode_rate_counts_each_request_only_up_to_its_own_length():
    rec = _serve_record(lambda w: [0.1] * 9, waves=2)
    full = stats.tokens_after(rec, -1.0)
    assert full == 2 * 10 * 4
    rec["waves"][1]["new"] = [10, 3, 1, 1]
    assert stats.tokens_after(rec, -1.0) == 40 + 15
    after = rec["waves"][1]["entries"][2]           # the end of step 1 of wave 1
    assert stats.tokens_after(rec, after) == 8 + 1
    assert _read("decode_tokens_per_s", rec) == pytest.approx(55 / rec["window_s"])


# ------------------------------------------------------------------ flops

def test_model_flops_count_every_layer_and_the_head_once():
    m = json.loads((HERE / "configs" / "minicpm-2b.json").read_text())["arch"]
    d, f, hd = m["d_model"], m["d_ff"], m["head_dim"]
    assert flops.body(m) == m["n_layers"] * (4 * d * m["n_heads"] * hd + 3 * d * f)
    assert flops.body(m) + flops.head(m) == pytest.approx(2.72e9, rel=0.01)
    assert flops.decode(m, 10) == 2 * 10 * (flops.body(m) + flops.head(m))


# ------------------------------------------------------------------ frozen work

SHAPES_FLASH = [(2, 2048, 2048, 36, 1, 64, 0, 0, 2), (4, 2040, 2040, 32, 1, 112, 0, 0, 2),
                (4, 2048, 2048, 32, 1, 128, 0, 0, 2), (2, 64, 64, 4, 1, 32, 0, 0, 4),
                (1, 100, 300, 8, 4, 128, 64, 200, 2)]
SHAPES_SCAN = [(2, 2048, 112, 64, 64, 128), (4, 2040, 112, 64, 64, 128),
               (2, 1000, 224, 32, 16, 128), (4, 2048, 32, 64, 64, 64)]


@pytest.mark.parametrize("shape", SHAPES_FLASH)
def test_frozen_flash_work_equals_the_programs(shape):
    from repro_torch.kernels import work as theirs
    assert work.flash_fwd_work(*shape) == theirs.flash_fwd_work(*shape)
    assert work.flash_bwd_work(*shape) == theirs.flash_bwd_work(*shape)


@pytest.mark.parametrize("shape", SHAPES_SCAN)
def test_frozen_scan_work_equals_the_programs(shape):
    from repro_torch.kernels import work as theirs
    assert work.ssd_work(*shape) == theirs.ssd_work(*shape)
    assert work.ssd_bwd_work(*shape) == theirs.ssd_bwd_work(*shape)
    b, t, h, d, _, c = shape
    assert work.wkv6_work(b, t, h, d, c) == theirs.wkv6_work(b, t, h, d, c)
    assert work.wkv6_bwd_work(b, t, h, d, c) == theirs.wkv6_bwd_work(b, t, h, d, c)


def test_frozen_peaks_equal_the_programs():
    from repro_torch.launch import roofline
    assert work.PEAK_FLOPS == roofline.PEAK_FLOPS


# ------------------------------------------------------------------ imports

REFERENCE_MAY = {"torch", "numpy", "math", "typing", "__future__", "dataclasses"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_imports_jax_or_the_jax_package(path):
    tops = {name for name, level in _imports(path) if level == 0}
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for name, level in _imports(path):
        assert level <= 1, f"{path.name} reaches outside the reference"
        assert level == 1 or name in REFERENCE_MAY, name


def test_a_run_refuses_a_loaded_jax_package_by_its_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType("repro_torch_like"))
    assert not {"repro_torch", "repro_torch_like"} & set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("repro.core"))
    assert "repro" in forbidden_modules()
