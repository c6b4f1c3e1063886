"""The port's storage plane (``repro_torch.core``, ``repro_torch.cache``,
``repro_torch.analysis``) against the reference's, on the CPU.

The storage plane is a deterministic simulation on a virtual clock, and the
port keeps its own copy of it, so each scripted workload below must give
the same trajectory in both packages, bit for bit: every return value and
errno, every op's modeled time, and the whole cluster's state and ``fsck``
report at the end (``torch_core_parity``).  The drawn sequences (VFS ops,
raft fault schedules) are in ``test_torch_core_props.py``.
"""

import ast
import dataclasses
import re
import sys
from pathlib import Path

import pytest

import torch_core_parity as tp

ROOT = Path(__file__).resolve().parents[1]
FAULT_FIELDS = ("orphan_inodes", "dangling_dentries", "nlink_drift", "range_overlaps",
                "range_gaps", "range_mismatches", "misplaced_inodes", "unroutable_dentries")


def _rows_by_label(rows):
    return {label: (out, timing) for label, out, timing in rows}


def _assert_fsck_clean(rows):
    label, (_, (name, fields)), _ = rows[-1]
    assert label == "fsck" and name == "FsckReport"
    fields = dict(fields)
    assert all(fields[f] == ("list", ()) for f in FAULT_FIELDS), fields


def test_knobs_tables_are_equal():
    ref, port = tp.REF.knobs.KNOBS, tp.PORT.knobs.KNOBS
    assert list(ref) == list(port)
    assert {k: dataclasses.astuple(v) for k, v in ref.items()} == \
        {k: dataclasses.astuple(v) for k, v in port.items()}
    for name, knob in port.items():          # each parses as the reference's does
        getter = {"int": "get_int", "float": "get_float", "bool": "get_bool",
                  "str": "get_str"}[knob.type]
        assert getattr(tp.PORT.knobs, getter)(name) == getattr(tp.REF.knobs, getter)(name)
    with pytest.raises(tp.PORT.knobs.UnregisteredKnob):
        tp.PORT.knobs.get_int("CFS_NOT_A_KNOB")


# the constants that name the reference's own package in the reference and
# the port's in the port
RENAMED = {"analysis.lint": ("SIM_SCOPE", "BASELINE_PATH")}


def _as_port(v):
    """``repro.x`` or ``repro/x``, or a tuple of them, under the port's name."""
    if isinstance(v, tuple):
        return tuple(_as_port(x) for x in v)
    assert v.startswith(("repro.", "repro/")), v
    return "repro_torch" + v[len("repro"):]


@pytest.mark.parametrize("module", tp.MODULES)
def test_module_constants_and_public_names_are_the_references(module):
    """Each module's upper-case constants (the knob values read at import
    among them) and its ``__all__``; the knobs module leaves out the
    reference's README table sync (its renderer and markers).  The lint's
    scope and baseline file name the port's package where the reference's
    name its own (``RENAMED``); a path is compared below ``src/``, a pattern
    by its text, a tuple of names as it is."""
    ref, port = (sys.modules[f"{P.root}.{module}"] for P in (tp.REF, tp.PORT))
    readme_sync = {"render_markdown_table", "BEGIN_MARK", "END_MARK"}

    def value(v):
        if isinstance(v, Path):
            return v.relative_to(ROOT / "src").as_posix()
        if isinstance(v, re.Pattern):
            return v.pattern
        if isinstance(v, tuple) and all(isinstance(x, str) for x in v):
            return v
        return tp.norm(v)

    def consts(mod):
        return {k: value(v) for k, v in vars(mod).items()
                if k.lstrip("_").isupper() and not isinstance(v, type(sys))
                and k not in readme_sync}

    want = consts(ref)
    for k in RENAMED.get(module, ()):
        want[k] = _as_port(want[k])
    assert consts(port) == want
    names = set(getattr(ref, "__all__", ())) - readme_sync
    assert set(getattr(port, "__all__", ())) == names


def test_packages_export_the_references_names():
    for pkg in ("core", "cache", "analysis"):
        assert getattr(tp.PORT, pkg).__all__ == getattr(tp.REF, pkg).__all__


def test_storage_plane_imports_only_the_standard_library():
    """No torch, numpy or anything outside the standard library: the copies
    run on the host, as the reference's do."""
    files = [f for pkg in ("core", "cache", "analysis", "baseline")
             for f in sorted((ROOT / "src" / "repro_torch" / pkg).glob("*.py"))]
    assert len(files) == 23
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in sys.stdlib_module_names, (f.name, m)


def test_sanitizer_globals_are_separate():
    before = tp.REF.sanitizer.SAN
    with tp.sanitized(tp.PORT) as san:
        assert tp.PORT.sanitizer.SAN is san and tp.REF.sanitizer.SAN is before
    assert tp.PORT.sanitizer.SAN is not san


def test_not_found_is_one_class_for_both_mounts():
    from repro_torch.storage import checkpoint, volume
    NotFound = tp.PORT.client.NotFound
    assert volume.NotFound is NotFound and checkpoint.NotFound is NotFound
    assert issubclass(NotFound, tp.PORT.client.FsError)
    assert issubclass(NotFound, FileNotFoundError)
    assert tp.PORT.core.NotFound is NotFound


SCENARIOS = ["quickstart", "failover", "meta_split", "meta_sessions", "meta_async_crash",
             "extent_cache", "multi_client", "racy"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_trajectories_are_equal(scenario):
    rows = tp.both(getattr(tp, scenario))
    _assert_fsck_clean(rows)
    by = _rows_by_label(rows)
    if scenario == "failover":
        assert by["read back"][0] == ("ok", b"A" * (512 * 1024) + b"B" * (512 * 1024))
    elif scenario == "meta_split":
        assert by["split log"][0][1][1], "no split in the create storm"
        assert by["sibling replicas"][0][1][1][0] == "m4"   # the new node takes it
    elif scenario == "meta_sessions":
        assert by["r rmdir through stale listing"][0][:3] == ("raise", "CfsOSError", 39)
    elif scenario == "meta_async_crash":
        assert by["burst mkdir c5"][0][:2] == ("raise", "NotLeader")
        assert by["readdir"][0] == ("ok", ("list", ("c0", "c1", "c2", "c3", "c4", "f.bin")))
    elif scenario == "multi_client":
        assert len(rows) == 1 + 3 * 2 * (2 * 5 + 3 + 1) + 3    # mkdir, ops, makespan, ...
        assert all(out[0] == "ok" for label, out, _ in rows[1:-3])
    elif scenario == "racy":
        assert by["branch 0 append"][0][0] == "ok"
        assert by["branch 1 append"][0][:2] == ("raise", "HBViolation")
        assert by["violations"][0] == ("note", 1) and by["violations after"][0] == ("note", 1)


def test_trajectories_see_a_difference():
    """The comparison is not vacuous: one more byte written by one side is
    found, at its row."""
    ref = tp.quickstart(tp.REF)

    def port(P):
        rows = tp.quickstart(P)
        label, (kind, n), timing = rows[2]
        rows[2] = (label, (kind, n + 1), timing)
        return rows

    with pytest.raises(AssertionError, match="row 2 differs"):
        tp.assert_same(ref, port(tp.PORT))
