"""The key of a built CUDA library: it changes with the source or any shared
header it may include, and with nothing else.  Needs no nvcc."""

import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    d.mkdir()
    (d / "a.cu").write_text('#include "shared.cuh"\n__global__ void a() {}\n')
    (d / "b.cu").write_text("__global__ void b() {}\n")
    (d / "shared.cuh").write_text("#pragma once\n#define TILE 64\n")
    return d


def test_editing_a_header_changes_the_library_name(csrc):
    before = _build.source_digest("a", csrc)
    (csrc / "shared.cuh").write_text("#pragma once\n#define TILE 128\n")
    assert _build.source_digest("a", csrc) != before


def test_adding_a_header_changes_the_library_name(csrc):
    before = _build.source_digest("a", csrc)
    (csrc / "more.cuh").write_text("#pragma once\n")
    assert _build.source_digest("a", csrc) != before


def test_editing_an_unrelated_source_keeps_the_library_name(csrc):
    before = _build.source_digest("a", csrc)
    (csrc / "b.cu").write_text("__global__ void b() { int x = 1; (void)x; }\n")
    assert _build.source_digest("a", csrc) == before


def test_editing_the_source_changes_the_library_name(csrc):
    before = _build.source_digest("a", csrc)
    (csrc / "a.cu").write_text('#include "shared.cuh"\n__global__ void a() { }\n')
    assert _build.source_digest("a", csrc) != before


def test_the_repository_sources_have_distinct_stable_keys(tmp_path):
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert {"flash_attention", "flash_attention_bwd", "checksum"} <= set(names)
    digests = {n: _build.source_digest(n) for n in names}
    assert len(set(digests.values())) == len(names)
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    assert all(_build.source_digest(n, copy) == d for n, d in digests.items())
