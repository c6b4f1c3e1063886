"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) has its file ``perfbench/workloads/<cell>.json``
(its driver, its optimizer where it trains, what its traced run traces, the
size of its check and the limits of the numbers that decide ``correct``);
its traffic mix ``perfbench/traffic/<traffic>.json``; its configuration the
``file`` of the entry of ``configs`` it names.  A metric's reader is
``perfbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> Dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _json(path: Path) -> Dict:
    return json.loads(path.read_text())


def cell(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    """{"entry", "cell", "config", "traffic"} of the workload ``name``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {"entry": entry,
            "cell": _json(HERE / "workloads" / f"{name}.json"),
            "config": _json(root / conf["file"]),
            "traffic": _json(HERE / "traffic" / f"{entry['traffic']}.json")}


def metrics_of(bench: Dict, name: str, traced: bool) -> List[Dict]:
    """The metrics a run of the cell ``name`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced.  A metric without ``workloads``
    belongs to every cell (a per-layer one to every cell reporting the
    end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in mine else [])]


def reader(metric: str):
    """The ``read(record, ctx)`` of ``perfbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "perfbench.metrics." + metric.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "perfbench.metrics"
    spec.loader.exec_module(mod)
    return mod.read
