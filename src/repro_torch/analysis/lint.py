"""cfs-analyze: AST lint for determinism and protocol discipline.

Run as ``python -m repro_torch.analysis.lint [paths...]`` (default:
``src/repro_torch``).  Exit 0 when every finding is suppressed inline or
grandfathered in the checked-in baseline; exit 1 on any NEW finding.

The port's own copy of the reference's ``repro.analysis.lint``: the same
rules, messages, suppression and baseline format, linting the port's tree.
It differs only where the port's names require:

* the module names it scopes by: :data:`SIM_SCOPE` is
  ``repro_torch.core`` and ``repro_torch.baseline``; ``env-knob`` exempts
  ``repro_torch.analysis.knobs``; ``direct-propose`` applies under
  ``repro_torch.core`` and exempts ``repro_torch.core.raft``/``multiraft``
  and ``repro_torch.core.client``'s two funnels; ``direct-resource``
  applies under ``repro_torch.core`` and exempts
  ``repro_torch.core.simnet``;
* the messages that name the knob registry name the port's;
* :func:`main`'s program name, help and default path (``src/repro_torch``);
* :data:`BASELINE_PATH` is the port's own ``lint_baseline.txt`` beside this
  file, which holds no keys.

Checkers (all pluggable via :data:`CHECKERS`):

* ``wall-clock`` — wall-clock reads (``time.time``, ``datetime.now`` …) in
  sim code: the simulator runs on virtual microseconds; wall time leaks
  host speed into results.
* ``unseeded-random`` — module-level ``random.*`` / any ``numpy.random``
  use, or argless ``random.Random()`` in sim code: unseeded entropy breaks
  bit-identical same-seed reruns.
* ``salted-hash`` — builtin ``hash()`` in sim code: str hashing is salted
  per process (PYTHONHASHSEED), so anything derived from it differs run to
  run.  Use ``zlib.crc32`` (see ``CfsClient._new_extent_id``).
* ``set-iter`` — iteration over set displays/comprehensions/``set()`` calls
  in sim code: set order is hash order, which is salted for strings.
* ``env-knob`` — any ``os.environ`` / ``os.getenv`` access outside the
  knob registry: every knob must be declared once in
  :mod:`repro_torch.analysis.knobs` and read through its typed getters.
* ``unregistered-knob`` — ``knobs.get_*("NAME")`` with a name missing from
  the registry (would raise at import time; the lint catches it statically).
* ``direct-propose`` — a ``.propose`` reference outside the raft machinery
  and the two sanctioned funnels: client metadata mutations MUST go through
  ``CfsClient._meta_propose`` so the ``note_mutation`` cache-invalidation
  hook fires (a bypass silently serves stale entries for up to one TTL).
* ``direct-resource`` — ``Resource``/``WfqResource`` construction in server
  scope (``repro_torch.core`` outside ``simnet``): service queues must come from
  ``Network.resource()`` so QoS-registered NICs get the tenant-tagged WFQ
  variant and ``reset_accounting`` resets them with the timeline.
* ``fork-unjoined-blocking`` — calling a blocking client helper
  (``drain_window``/``sync_partitions``/``evict_orphans``/``fsync``) between
  an ``OpTimer.fork()`` and its ``join()``: the helper advances the op
  frontier on ONE branch of an un-joined fork, so the barrier it models
  lands before the fork's other branches exist on the timeline.

Suppression: append ``# lint: allow[<rule>]`` to the offending source line.
Grandfathering: ``lint_baseline.txt`` next to this file holds
``rule<TAB>module<TAB>qualname`` keys (no line numbers — stable across
unrelated edits); ``--update-baseline`` rewrites it.
"""

from __future__ import annotations

import ast
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, List, Optional, Set, Tuple

from .knobs import KNOBS

__all__ = ["Finding", "Checker", "CHECKERS", "lint_file", "lint_paths", "main"]

# Modules whose code runs on the virtual timeline: determinism rules apply.
SIM_SCOPE = ("repro_torch.core", "repro_torch.baseline")

# Blocking client helpers that drain/synchronize the current op's frontier.
BLOCKING_HELPERS = {"drain_window", "drain_meta_window", "sync_partitions",
                    "evict_orphans", "fsync"}

WALL_CLOCK_CALLS = {
    ("time", "time"), ("time", "time_ns"), ("time", "monotonic"),
    ("time", "monotonic_ns"), ("time", "perf_counter"),
    ("time", "perf_counter_ns"), ("time", "process_time"),
    ("time", "localtime"), ("time", "gmtime"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}

_ALLOW_RE = re.compile(r"#\s*lint:\s*allow\[([a-z0-9-]+(?:\s*,\s*[a-z0-9-]+)*)\]")


@dataclass(frozen=True)
class Finding:
    rule: str
    module: str        # dotted module, e.g. "repro_torch.core.client"
    qualname: str      # enclosing def/class path, or "<module>"
    line: int
    col: int
    msg: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.module, self.qualname)

    def render(self, path: Path) -> str:
        where = f"{path}:{self.line}:{self.col}"
        return f"{where}: {self.rule}: {self.msg} [in {self.qualname}]"


def _in_sim_scope(module: str) -> bool:
    return module.startswith(SIM_SCOPE)


def _dotted_call(node: ast.Call) -> Optional[Tuple[str, str]]:
    """("time", "monotonic") for ``time.monotonic(...)`` — one-level only."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id, f.attr
    return None


class _ScopedVisitor(ast.NodeVisitor):
    """Walks a module keeping a class/function qualname stack."""

    def __init__(self, module: str):
        self.module = module
        self._stack: List[str] = []
        self.findings: List[Finding] = []

    @property
    def qualname(self) -> str:
        return ".".join(self._stack) or "<module>"

    def _scoped(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _scoped

    def add(self, rule: str, node: ast.AST, msg: str) -> None:
        self.findings.append(Finding(rule, self.module, self.qualname,
                                     node.lineno, node.col_offset, msg))


class Checker:
    """One lint rule.  Subclasses set ``name`` and implement ``check``."""

    name = ""

    def applies(self, module: str) -> bool:
        return True

    def check(self, module: str, tree: ast.Module) -> List[Finding]:
        raise NotImplementedError


class WallClockChecker(Checker):
    name = "wall-clock"

    def applies(self, module: str) -> bool:
        return _in_sim_scope(module)

    def check(self, module, tree):
        rule = self.name

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                dc = _dotted_call(node)
                if dc in WALL_CLOCK_CALLS:
                    self.add(rule, node,
                             f"wall-clock call {dc[0]}.{dc[1]}() in sim code"
                             " — use the virtual clock (OpTimer/SimClock)")
                self.generic_visit(node)

        v = V(module)
        v.visit(tree)
        return v.findings


class UnseededRandomChecker(Checker):
    name = "unseeded-random"

    def applies(self, module: str) -> bool:
        return _in_sim_scope(module)

    def check(self, module, tree):
        rule = self.name

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                dc = _dotted_call(node)
                if dc is not None:
                    mod, fn = dc
                    if mod == "random" and fn == "Random" and not node.args:
                        self.add(rule, node,
                                 "argless random.Random() — seed it from op/"
                                 "cluster state for reproducible reruns")
                    elif mod == "random" and fn[0].islower():
                        self.add(rule, node,
                                 f"module-level random.{fn}() uses the "
                                 "process-global unseeded RNG — use a seeded "
                                 "random.Random instance")
                    elif mod in ("np", "numpy") and fn == "random":
                        self.add(rule, node, "numpy.random in sim code")
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr == "random" and \
                        isinstance(f.value, ast.Attribute) and \
                        isinstance(f.value.value, ast.Name) and \
                        f.value.value.id in ("np", "numpy"):
                    self.add(rule, node, "numpy.random in sim code")
                self.generic_visit(node)

            def visit_Attribute(self, node):
                if node.attr == "random" and isinstance(node.value, ast.Name) \
                        and node.value.id in ("np", "numpy"):
                    self.add(rule, node,
                             "numpy.random in sim code — unseeded global "
                             "state breaks same-seed reruns")
                self.generic_visit(node)

        v = V(module)
        v.visit(tree)
        return v.findings


class SaltedHashChecker(Checker):
    name = "salted-hash"

    def applies(self, module: str) -> bool:
        return _in_sim_scope(module)

    def check(self, module, tree):
        rule = self.name

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                if isinstance(node.func, ast.Name) and node.func.id == "hash":
                    self.add(rule, node,
                             "builtin hash() is salted per process "
                             "(PYTHONHASHSEED) — derive seeds/ids with "
                             "zlib.crc32 instead")
                self.generic_visit(node)

        v = V(module)
        v.visit(tree)
        return v.findings


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    return False


class SetIterChecker(Checker):
    name = "set-iter"

    def applies(self, module: str) -> bool:
        return _in_sim_scope(module)

    def check(self, module, tree):
        rule = self.name

        class V(_ScopedVisitor):
            def _check_iter(self, node, it):
                if _is_set_expr(it):
                    self.add(rule, node,
                             "iteration over an unordered set in sim code — "
                             "set order is hash order (salted); iterate a "
                             "sorted() or insertion-ordered container")

            def visit_For(self, node):
                self._check_iter(node, node.iter)
                self.generic_visit(node)

            def _comp(self, node):
                for gen in node.generators:
                    self._check_iter(node, gen.iter)
                self.generic_visit(node)

            visit_ListComp = visit_SetComp = visit_GeneratorExp = _comp

            def visit_DictComp(self, node):
                self._comp(node)

        v = V(module)
        v.visit(tree)
        return v.findings


class EnvKnobChecker(Checker):
    name = "env-knob"

    def applies(self, module: str) -> bool:
        return module != "repro_torch.analysis.knobs"

    def check(self, module, tree):
        rule = self.name

        class V(_ScopedVisitor):
            def visit_Attribute(self, node):
                if node.attr == "environ" and \
                        isinstance(node.value, ast.Name) and \
                        node.value.id == "os":
                    self.add(rule, node,
                             "direct os.environ access — declare the knob in "
                             "repro_torch.analysis.knobs and use its typed getters")
                self.generic_visit(node)

            def visit_Call(self, node):
                dc = _dotted_call(node)
                if dc == ("os", "getenv"):
                    self.add(rule, node,
                             "os.getenv — declare the knob in "
                             "repro_torch.analysis.knobs and use its typed getters")
                self.generic_visit(node)

        v = V(module)
        v.visit(tree)
        return v.findings


class UnregisteredKnobChecker(Checker):
    name = "unregistered-knob"

    def check(self, module, tree):
        rule = self.name

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                dc = _dotted_call(node)
                if dc is not None and dc[0] == "knobs" and \
                        dc[1] in ("get_int", "get_float", "get_str",
                                  "get_bool") and node.args:
                    arg = node.args[0]
                    if isinstance(arg, ast.Constant) and \
                            isinstance(arg.value, str) and \
                            arg.value not in KNOBS:
                        self.add(rule, node,
                                 f"knob {arg.value!r} is not declared in "
                                 "repro_torch.analysis.knobs.KNOBS (this raises "
                                 "UnregisteredKnob at import time)")
                self.generic_visit(node)

        v = V(module)
        v.visit(tree)
        return v.findings


class DirectProposeChecker(Checker):
    name = "direct-propose"
    # The raft machinery implements propose; these funnels are the ONLY
    # sanctioned users.  Everything else must route through them so the
    # note_mutation invalidation hook (client) stays on the mutation path.
    exempt_modules = ("repro_torch.core.raft", "repro_torch.core.multiraft")
    # _meta_propose_once is the transport half of the same funnel: the
    # public _meta_propose wraps it with the WrongRange redirect
    exempt_quals = {("repro_torch.core.client", "CfsClient._meta_propose"),
                    ("repro_torch.core.client", "CfsClient._meta_propose_once")}

    def applies(self, module: str) -> bool:
        return module.startswith("repro_torch.core") and \
            not module.startswith(self.exempt_modules)

    def check(self, module, tree):
        rule, exempt = self.name, self.exempt_quals

        class V(_ScopedVisitor):
            def visit_Attribute(self, node):
                if node.attr == "propose" and \
                        (self.module, self.qualname) not in exempt:
                    self.add(rule, node,
                             ".propose referenced outside the sanctioned "
                             "funnels — metadata mutations must go through "
                             "CfsClient._meta_propose so note_mutation "
                             "invalidates the session cache")
                self.generic_visit(node)

        v = V(module)
        v.visit(tree)
        return v.findings


class DirectResourceChecker(Checker):
    name = "direct-resource"
    # Service queues in server scope must come from Network.resource(),
    # which routes QoS-registered NICs through the tenant-tagged WFQ
    # variant.  A hand-built Resource bypasses per-volume
    # scheduling AND reset_accounting's timeline reset.  simnet itself is
    # the factory; WfqResource subclasses Resource there.
    exempt_modules = ("repro_torch.core.simnet",)

    def applies(self, module: str) -> bool:
        return module.startswith("repro_torch.core") and \
            not module.startswith(self.exempt_modules)

    def check(self, module, tree):
        rule = self.name

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                f = node.func
                name = f.id if isinstance(f, ast.Name) else \
                    (f.attr if isinstance(f, ast.Attribute) else None)
                if name in ("Resource", "WfqResource"):
                    self.add(rule, node,
                             f"direct {name}() construction in server scope "
                             "— obtain service queues via Network.resource() "
                             "so QoS-registered NICs get the tenant-tagged "
                             "WFQ variant and reset_accounting covers them")
                self.generic_visit(node)

        v = V(module)
        v.visit(tree)
        return v.findings


class ForkBlockingChecker(Checker):
    name = "fork-unjoined-blocking"

    def applies(self, module: str) -> bool:
        return _in_sim_scope(module)

    def check(self, module, tree):
        rule = self.name
        findings: List[Finding] = []
        blocking = BLOCKING_HELPERS

        def last_attr(call: ast.Call) -> Optional[str]:
            f = call.func
            if isinstance(f, ast.Attribute):
                return f.attr
            if isinstance(f, ast.Name):
                return f.id
            return None

        def scan_fn(fn: ast.AST, qual: str) -> None:
            open_forks: Set[str] = set()

            def scan_stmts(body: Iterable[ast.stmt]) -> None:
                for stmt in body:
                    # x = <expr>.fork()  opens; x.join()/join_first() closes
                    if isinstance(stmt, ast.Assign) and \
                            isinstance(stmt.value, ast.Call) and \
                            isinstance(stmt.value.func, ast.Attribute) and \
                            stmt.value.func.attr == "fork":
                        for tgt in stmt.targets:
                            if isinstance(tgt, ast.Name):
                                open_forks.add(tgt.id)
                        continue
                    for node in ast.walk(stmt):
                        if isinstance(node, (ast.FunctionDef,
                                             ast.AsyncFunctionDef)):
                            break   # nested defs scanned separately
                        if not isinstance(node, ast.Call):
                            continue
                        f = node.func
                        if isinstance(f, ast.Attribute) and \
                                f.attr in ("join", "join_first") and \
                                isinstance(f.value, ast.Name):
                            open_forks.discard(f.value.id)
                        elif open_forks and last_attr(node) in blocking:
                            findings.append(Finding(
                                rule, module, qual, node.lineno,
                                node.col_offset,
                                f"blocking helper {last_attr(node)}() called "
                                f"inside un-joined fork branch(es) "
                                f"{sorted(open_forks)} — the barrier lands "
                                "on one branch's timeline before the fork "
                                "is joined"))

            scan_stmts(getattr(fn, "body", []))

        class FnFinder(_ScopedVisitor):
            def _scoped(self, node):
                self._stack.append(node.name)
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scan_fn(node, self.qualname)
                self.generic_visit(node)
                self._stack.pop()

            visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = \
                _scoped

        FnFinder(module).visit(tree)
        return findings


CHECKERS: List[Checker] = [
    WallClockChecker(),
    UnseededRandomChecker(),
    SaltedHashChecker(),
    SetIterChecker(),
    EnvKnobChecker(),
    UnregisteredKnobChecker(),
    DirectProposeChecker(),
    DirectResourceChecker(),
    ForkBlockingChecker(),
]


def module_name(path: Path, roots: List[Path]) -> str:
    """Dotted module name for ``path`` relative to the nearest src root."""
    p = path.resolve()
    for root in roots:
        try:
            rel = p.relative_to(root.resolve())
        except ValueError:
            continue
        parts = list(rel.with_suffix("").parts)
        if parts and parts[-1] == "__init__":
            parts.pop()
        return ".".join(parts)
    return p.stem


def _inline_allowed(src_lines: List[str], finding: Finding) -> bool:
    if not 0 < finding.line <= len(src_lines):
        return False
    m = _ALLOW_RE.search(src_lines[finding.line - 1])
    if m is None:
        return False
    rules = {r.strip() for r in m.group(1).split(",")}
    return finding.rule in rules


def lint_file(path: Path, roots: List[Path],
              checkers: Optional[List[Checker]] = None) -> List[Finding]:
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [Finding("syntax-error", module_name(path, roots), "<module>",
                        e.lineno or 0, e.offset or 0, str(e))]
    module = module_name(path, roots)
    lines = src.splitlines()
    out: List[Finding] = []
    for checker in (checkers if checkers is not None else CHECKERS):
        if not checker.applies(module):
            continue
        for f in checker.check(module, tree):
            if not _inline_allowed(lines, f):
                out.append(f)
    return out


def lint_paths(paths: List[Path], roots: List[Path]) -> List[Tuple[Path, Finding]]:
    results: List[Tuple[Path, Finding]] = []
    for p in paths:
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            for finding in lint_file(f, roots):
                results.append((f, finding))
    return results


BASELINE_PATH = Path(__file__).resolve().parent / "lint_baseline.txt"


def load_baseline(path: Path) -> Set[Tuple[str, str, str]]:
    if not path.exists():
        return set()
    out: Set[Tuple[str, str, str]] = set()
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        if len(parts) == 3:
            out.add((parts[0], parts[1], parts[2]))
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Determinism / knob / protocol-discipline lint.")
    ap.add_argument("paths", nargs="*", help="files or dirs (default: src/repro_torch)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the grandfathered-findings baseline")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, even baselined ones")
    args = ap.parse_args(argv)

    src_root = Path(__file__).resolve().parents[2]     # .../src
    roots = [src_root]
    if args.paths:
        paths = [Path(p) for p in args.paths]
    else:
        paths = [src_root / "repro_torch"]

    results = lint_paths(paths, roots)
    baseline = set() if args.no_baseline else load_baseline(BASELINE_PATH)

    if args.update_baseline:
        keys = sorted({f.key() for _, f in results})
        with BASELINE_PATH.open("w") as fh:
            fh.write("# Grandfathered lint findings: rule<TAB>module<TAB>"
                     "qualname.\n# Remove lines as violations are fixed; "
                     "never add new ones.\n")
            for k in keys:
                fh.write("\t".join(k) + "\n")
        print(f"baseline updated: {len(keys)} grandfathered finding keys")
        return 0

    new = [(p, f) for p, f in results if f.key() not in baseline]
    for p, f in new:
        print(f.render(p))
    grandfathered = len(results) - len(new)
    status = "clean" if not new else f"{len(new)} new finding(s)"
    print(f"lint: {status}"
          + (f", {grandfathered} grandfathered" if grandfathered else ""))
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
