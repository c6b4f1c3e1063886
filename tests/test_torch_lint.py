"""The port's determinism lint (``repro_torch.analysis.lint``) against the
reference's (``repro.analysis.lint``), on the CPU.

Every fixture of ``tests/test_analysis.py``'s lint tests, and one for each
renamed exemption, is linted by both: the reference's at ``repro/<path>``,
the port's at ``repro_torch/<path>``.  The findings must be equal, rule,
qualname, line and column, with the module name and the knob registry's
name in the message mapped to the port's.  The port's tree lints clean with
an empty baseline.
"""

from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint as port_lint

ROOT = Path(__file__).resolve().parents[1]

WALL = "import time\ndef f():\n    return time.time()\n"

# (id, path under the package, source, the reference's rules, one per finding)
FIXTURES = [
    ("wall-clock", "core/x.py", WALL, ["wall-clock"]),
    ("wall-clock-outside-sim", "launch/x.py", WALL, []),
    ("unseeded-random", "core/x.py",
     "import random\ndef f():\n    r = random.Random()\n    return random.random()\n",
     ["unseeded-random"] * 2),
    ("seeded-random", "core/x.py",
     "import random\ndef f(seed):\n    return random.Random(seed)\n", []),
    ("numpy-random", "core/x.py",
     "import numpy as np\ndef f():\n    return np.random.rand(3)\n", ["unseeded-random"]),
    ("salted-hash", "baseline/x.py", "def f(s):\n    return hash(s) % 7\n", ["salted-hash"]),
    ("set-iter", "core/x.py",
     "def f(xs):\n    for x in set(xs):\n        pass\n    return [y for y in {1, 2}]\n",
     ["set-iter"] * 2),
    ("sorted-set-iter", "core/x.py",
     "def f(xs):\n    for x in sorted(set(xs)):\n        pass\n", []),
    ("env-knob", "launch/y.py",
     "import os\nA = os.environ.get('CFS_FOO', '1')\nB = os.getenv('CFS_BAR')\n",
     ["env-knob"] * 2),
    ("env-knob-in-the-registry", "analysis/knobs.py",
     "import os\nA = os.environ.get('CFS_FOO', '1')\n", []),
    ("unregistered-knob", "core/x.py",
     "from repro.analysis import knobs\nA = knobs.get_int('CFS_NOT_DECLARED')\n"
     "B = knobs.get_float('CFS_META_TTL')\n", ["unregistered-knob"]),
    ("direct-propose", "core/x.py", "def f(member, p):\n    return member.propose(p)\n",
     ["direct-propose"]),
    ("direct-propose-in-raft", "core/raft.py",
     "def f(member, p):\n    return member.propose(p)\n", []),
    ("direct-propose-in-the-funnel", "core/client.py",
     "class CfsClient:\n    def _meta_propose(self, m, p):\n        return m.propose(p)\n"
     "    def other(self, m, p):\n        return m.propose(p)\n", ["direct-propose"]),
    ("direct-resource", "core/x.py", "def f(simnet):\n    return simnet.Resource('q')\n",
     ["direct-resource"]),
    ("direct-resource-in-simnet", "core/simnet.py",
     "def f():\n    return WfqResource('q', None)\n", []),
    ("fork-unjoined-blocking", "core/x.py",
     "def f(self, op):\n    fork = op.fork()\n    self.drain_window()\n    fork.join()\n",
     ["fork-unjoined-blocking"]),
    ("fork-joined", "core/x.py",
     "def f(self, op):\n    fork = op.fork()\n    fork.join()\n    self.drain_window()\n", []),
    ("inline-suppression", "core/x.py",
     "import time\ndef f():\n    return time.time()  # lint: allow[wall-clock]\n", []),
    ("inline-suppression-other-rule", "core/x.py",
     "import time\ndef f():\n    return time.time()  # lint: allow[set-iter]\n",
     ["wall-clock"]),
]


def _lint(mod, root: Path, rel: str, src: str):
    """Lint ``src`` with ``mod`` as if it lived at ``<root>/<rel>``."""
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(src)
    return mod.lint_file(p, [root])


def _as_port(f):
    """A reference finding under the port's names."""
    return (f.rule, "repro_torch" + f.module[len("repro"):], f.qualname, f.line, f.col,
            f.msg.replace("repro.analysis.knobs", "repro_torch.analysis.knobs"))


def _key(f):
    return (f.rule, f.module, f.qualname, f.line, f.col, f.msg)


@pytest.mark.parametrize("rel, src, rules", [f[1:] for f in FIXTURES],
                         ids=[f[0] for f in FIXTURES])
def test_fixture_gives_the_references_findings(tmp_path, rel, src, rules):
    ref = _lint(ref_lint, tmp_path / "ref", f"repro/{rel}", src)
    port = _lint(port_lint, tmp_path / "port", f"repro_torch/{rel}", src)
    assert sorted(f.rule for f in ref) == rules
    assert [_key(f) for f in port] == [_as_port(f) for f in ref]


@pytest.mark.parametrize("package, port_flags, ref_flags", [
    ("repro", False, True), ("repro_torch", True, False)])
def test_scope_is_renamed_and_not_vacuous(tmp_path, package, port_flags, ref_flags):
    """The port's sim scope is its own package: wall clock in
    ``repro/core`` is outside it, in ``repro_torch/core`` inside."""
    rel = f"{package}/core/x.py"
    assert bool(_lint(port_lint, tmp_path / "port", rel, WALL)) is port_flags
    assert bool(_lint(ref_lint, tmp_path / "ref", rel, WALL)) is ref_flags


def test_port_tree_lints_clean_with_an_empty_baseline(capsys):
    """``python -m repro_torch.analysis.lint`` exits 0 on the port's whole
    tree, and the baseline beside it holds no keys."""
    assert port_lint.BASELINE_PATH == ROOT / "src/repro_torch/analysis/lint_baseline.txt"
    assert port_lint.load_baseline(port_lint.BASELINE_PATH) == set()
    assert port_lint.BASELINE_PATH.read_text() == ref_lint.BASELINE_PATH.read_text()
    assert port_lint.main([]) == 0
    assert capsys.readouterr().out == "lint: clean\n"


def test_a_new_finding_fails_and_names_file_line_and_rule(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\n\nA = os.environ['CFS_FOO']\n")
    assert port_lint.main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert f"{bad}:3:4: env-knob: " in out and out.endswith("lint: 1 new finding(s)\n")


def test_update_baseline_grandfathers_as_the_reference_does(tmp_path, monkeypatch, capsys):
    """``--update-baseline`` writes the reference's file for the same
    findings, which then grandfathers them; ``--no-baseline`` reports them
    again.  Only a file under ``tmp_path`` is written."""
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nA = os.getenv('CFS_FOO')\nB = os.environ\n")
    written = {}
    for name, mod in (("ref", ref_lint), ("port", port_lint)):
        base = tmp_path / f"{name}_baseline.txt"
        monkeypatch.setattr(mod, "BASELINE_PATH", base)
        assert mod.main(["--update-baseline", str(bad)]) == 0
        written[name] = base.read_text()
        assert mod.main([str(bad)]) == 0
        assert mod.main(["--no-baseline", str(bad)]) == 1
    assert written["port"] == written["ref"]
    assert port_lint.load_baseline(tmp_path / "port_baseline.txt") == {
        ("env-knob", "bad", "<module>")}
    assert "lint: clean, 2 grandfathered" in capsys.readouterr().out
