"""A test module's cases on a world of gloo ranks on the CPU.

A test module that holds a mesh path of the port to its mesh-free path
names its cases ``case_<name>(mesh)`` and, run as a script, calls
``rank_main``: each of ``world`` processes (one thread each) joins a gloo
world through a ``file://`` rendezvous in a temporary directory, forms a
("data", "model") mesh, runs every case once and writes one JSON result
a rank.  ``spawn_ranks`` starts the processes from the test module's
fixture, under a time limit for the whole spawn, and every collective has
its own (the process group's timeout), so a hang fails instead of holding
the suite.  Each case then reports as its own test.

Also the rank-side patches that both modules' cases take: the sharding
rules as if every arch needed FSDP, and the local MoE dispatch routed in
as many groups as the mesh path routes.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def cases_of(namespace: dict) -> dict:
    """{name: fn} of a module's ``case_<name>`` functions, in order."""
    return {name[len("case_"):]: fn for name, fn in namespace.items()
            if name.startswith("case_")}


def rank_main(cases: dict, mesh_shape, pg_timeout_s: float) -> None:
    """One rank's run of every case; argv: rank, world size, rendezvous file,
    result file."""
    rank, world, init_file, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    init_process_group(init_file, rank, world, backend="gloo", timeout_s=pg_timeout_s)
    mesh = make_host_mesh(*mesh_shape, device_type="cpu")
    results = {}
    for name, fn in cases.items():
        t0 = time.perf_counter()
        try:
            results[name] = {"ok": True, **fn(mesh)}
        except Exception:
            results[name] = {"ok": False, "error": traceback.format_exc()}
        results[name]["s"] = time.perf_counter() - t0
    Path(out).write_text(json.dumps(results))
    dist.destroy_process_group()


def spawn_ranks(script: str, world: int, timeout_s: float) -> list:
    """Runs ``script`` as ``world`` ranks; each rank's results, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen([sys.executable, script, str(r), str(world),
                                   os.path.join(tmp, "pg"), os.path.join(tmp, f"{r}.json")],
                                  env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        deadline = time.monotonic() + timeout_s
        logs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                logs.append(out)
        finally:
            for p in procs:
                p.kill()
                p.wait()
        missing = [r for r in range(world) if not os.path.exists(os.path.join(tmp, f"{r}.json"))]
        assert not missing, f"ranks {missing} wrote no results:\n" + "\n".join(
            log[-3000:] for log in logs)
        return [json.loads(Path(tmp, f"{r}.json").read_text()) for r in range(world)]


@contextlib.contextmanager
def fsdp_forced(on: bool = True):
    """The sharding rules as if every arch needed FSDP (params split over the
    data axes on their marked dim), for the block."""
    from repro_torch.parallel import sharding as shd
    prev = shd.needs_fsdp
    if on:
        shd.needs_fsdp = lambda cfg: True
    try:
        yield
    finally:
        shd.needs_fsdp = prev


@contextlib.contextmanager
def moe_groups(n: int):
    """The local MoE dispatch routed in ``n`` groups (a mesh path's: one a
    data rank), for the block."""
    from repro_torch.models import moe
    local = moe.moe_block
    moe.moe_block = lambda *a, **kw: local(*a, groups=n, **kw)
    try:
        yield
    finally:
        moe.moe_block = local
