"""A/B of the port's serving waves between two source trees, on one card.

    python tools/serve_ab.py --tree parent=build/parent/src --tree change=src \\
        --runs parent,change,change,parent,parent,change,change,parent \\
        --out results/serve_ab.jsonl

Each run is a fresh process (``--worker``) that imports ``repro_torch`` from
its tree, joins a world of one NCCL rank (as ``chip_smoke.py`` does) and
times serving waves of ``--models``, one after the other, each from random
bf16 weights (seed 0) at full width:

  * ``codeqwen``: codeqwen1.5-7b, all 32 layers, through the model's
    mesh-free ``prefill``/``decode`` (what ``BatchServer`` calls);
  * ``mixtral``: mixtral-8x22b cut to 4 of its 56 layers, the same;
  * ``rwkv6``: rwkv6-1.6b cut to 4 of its 24 layers, the same;
  * ``zamba2``: zamba2-7b cut to 6 of its 81 layers (one site of its shared
    block), the same;
  * ``placed``, ``rwkv6-placed``, ``zamba2-placed``: codeqwen1.5-7b, and
    the two cuts above, through ``serve.server.placed_prefill``/
    ``placed_decode`` on DTensors on a 1 x 1 mesh (skipped, and said so,
    in a tree that has no placed serving).

A wave is a prefill of B=4 random prompts of T=1788 tokens and
``--steps`` greedy decode steps; one wave warms up, then ``--waves`` are
timed: each prefill and each decode step on the host clock, synchronised.
The runs alternate as ``--runs`` lists them, so drift in the host falls on
both trees.  Every record goes to ``--out``; the summary (for each tree
and model, each run's median decode step and prefill, and their median)
is the last line of stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# model: (arch, layers it is cut to or 0 for all, placed)
MODELS = {"codeqwen": ("codeqwen1.5-7b", 0, False), "mixtral": ("mixtral-8x22b", 4, False),
          "placed": ("codeqwen1.5-7b", 0, True), "rwkv6": ("rwkv6-1.6b", 4, False),
          "zamba2": ("zamba2-7b", 6, False), "rwkv6-placed": ("rwkv6-1.6b", 4, True),
          "zamba2-placed": ("zamba2-7b", 6, True)}
B, T = 4, 1788


def _wave(cfg, prefill, decode, toks, steps: int) -> dict:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(toks)
    torch.cuda.synchronize()
    out = {"prefill_ms": (time.perf_counter() - t0) * 1e3, "decode_step_ms": []}
    for i in range(steps):
        t0 = time.perf_counter()
        logits, cache = decode(logits[:, -1, :cfg.vocab].argmax(-1)[:, None], cache, T + i)
        torch.cuda.synchronize()
        out["decode_step_ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def _calls(model: str, cfg, params):
    """(prefill(toks), decode(token, cache, cache_len)) of ``model``, whole
    logits out; None where the tree has no placed serving."""
    from repro_torch.models import get_model
    api = get_model(cfg)
    smax = T + 64
    if not MODELS[model][2]:
        return (lambda t: api.prefill(params, t, smax),
                lambda tok, c, n: api.decode(params, tok, c, n))
    try:
        from repro_torch.serve.server import placed_decode, placed_prefill
    except ImportError:
        return None
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import sharding as shd
    mesh = make_host_mesh(1, 1, "cuda")
    placed = shd.distribute_tree(params, shd.param_shardings(cfg, params, mesh), mesh)

    def place(x):
        return shd.distribute(x, shd.input_shardings(mesh, {"x": x})["x"], mesh)

    def whole(out):
        return out[0].full_tensor(), out[1]
    return (lambda t: whole(placed_prefill(cfg, placed, place(t), smax, "bfloat16", mesh)),
            lambda tok, c, n: whole(placed_decode(cfg, placed, place(tok), c, n, mesh)))


def worker(args) -> None:
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import init_process_group
    from repro_torch.models import get_model
    rec = {"run": args.label, "src": args.src, "nvidia_smi": args.smi, "models": {}}
    with tempfile.TemporaryDirectory() as rdv, torch.no_grad():
        init_process_group(str(Path(rdv) / "pg"), 0, 1, "nccl", 60)
        try:
            for model in args.models.split(","):
                arch, layers, _ = MODELS[model]
                cfg = get_arch(arch)
                cfg = dataclasses.replace(cfg, n_layers=layers) if layers else cfg
                params = get_model(cfg).init(0, torch.bfloat16, "cuda")
                calls = _calls(model, cfg, params)
                if calls is None:
                    rec["models"][model] = {"skipped": "the tree has no placed serving"}
                    continue
                toks = torch.randint(0, cfg.vocab, (B, T), device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(3))
                waves = [_wave(cfg, *calls, toks, args.steps) for _ in range(args.waves + 1)][1:]
                steps = [ms for w in waves for ms in w["decode_step_ms"]]
                rec["models"][model] = {
                    "arch": cfg.name, "layers": cfg.n_layers, "waves": waves,
                    "prefill_ms": statistics.median(w["prefill_ms"] for w in waves),
                    "decode_step_ms": statistics.median(steps)}
                del params, calls
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    print("AB " + json.dumps(rec), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[], help="NAME=SRC_DIR")
    ap.add_argument("--runs", default="", help="comma-separated NAME, in order")
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--steps", type=int, default=31)
    ap.add_argument("--models", default=",".join(MODELS), help="of " + ", ".join(MODELS))
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--src"), ap.add_argument("--label")
    ap.add_argument("--smi", default="")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)

    trees = dict(t.split("=", 1) for t in args.tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from repro_torch.kernels "
             "import _build; _build.build_all(['flash_attention', 'rwkv6_scan', 'mamba2_ssd'])")
    builds = [subprocess.Popen([sys.executable, "-c", build, src]) for src in trees.values()]
    if any(p.wait(timeout=600) for p in builds):
        raise SystemExit("a tree's kernels did not build")
    records = []
    for run in args.runs.split(","):
        out = subprocess.run(
            [sys.executable, __file__, "--worker", "--src", trees[run], "--label", run,
             "--waves", str(args.waves), "--steps", str(args.steps), "--models", args.models,
             "--smi", smi], capture_output=True, text=True, timeout=600)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("AB ")]
        if out.returncode or not lines:
            raise SystemExit(f"run {run} failed ({out.returncode}):\n{out.stderr[-3000:]}")
        records.append(json.loads(lines[-1][3:]))
        r = {m: v for m, v in records[-1]["models"].items() if "skipped" not in v}
        print(f"{run}: " + ", ".join(f"{m} prefill {v['prefill_ms']:.1f} ms, decode step "
                                     f"{v['decode_step_ms']:.2f} ms" for m, v in r.items()),
              flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in records))
    summary = {}
    for run in dict.fromkeys(r["run"] for r in records):
        mine = [r["models"] for r in records if r["run"] == run]
        summary[run] = {
            m: {"run_decode_step_ms": [x[m]["decode_step_ms"] for x in mine],
                "decode_step_ms": statistics.median(x[m]["decode_step_ms"] for x in mine),
                "run_prefill_ms": [x[m]["prefill_ms"] for x in mine],
                "prefill_ms": statistics.median(x[m]["prefill_ms"] for x in mine)}
            for m in mine[0] if "skipped" not in mine[0][m]}
    print(smi)
    print(json.dumps({"summary": summary, "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
