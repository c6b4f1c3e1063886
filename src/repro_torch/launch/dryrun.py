"""Multi-pod dry run: every (arch x shape x mesh) cell lowered on fake tensors
and counted, with no card.

    python -m repro_torch.launch.dryrun --arch minicpm-2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both [--skip-existing]

The twin of ``repro.launch.dryrun``.  Each cell joins torch's fake process
group (backend ``"fake"``) at 256 ranks (``--mesh single``, a 16 x 16
("data", "model") mesh) or 512 (``multi``, 2 x 16 x 16 with "pod"), makes
the model's parameters at full published width as fake tensors, places
them as the port places them, runs one train step, one prefill or one
decode step, and counts it with ``roofline.Count``: per-rank flops, bytes,
collectives, the peak of live device bytes and the roofline bound on an
H100 (``roofline.roofline_terms``).  It writes
``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` and exits 1 if any
cell fails.

The fake tensors lie on the CPU and stand for the card's: autograd cannot
build a graph on fake CUDA tensors where torch has no CUDA (it asks CUDA
for the device's stream), and where it has, a fake CUDA tensor would open
a context on the card.  Inside ``ops.kernel_path()`` the step takes the
card's path all the same: each kernel is one operator whose fake
implementation gives its outputs, counted by its work formula.  No kernel
is launched and no card is touched; the same command runs with and without
one.

The record says how the port placed the call (``placement``).  A train
step stores parameters and gradients as the reference's placements say:
each layer gathers its blocks over the data axes inside its checkpointed
block (``param_gathers``: gathers and their backward's reduce-scatters),
and the loss is vocab-parallel.  A prefill or decode runs
``serve.server.placed_prefill``/``placed_decode`` on the params, tokens
and cache placed as the reference's ``lower_cell`` places them, and its
cache is counted as its own category of live bytes (``cache``).

Importing this module has no side effects: the process group is joined by
``lower_cell``.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import List, Optional

import torch
import torch.distributed as dist

from ..configs import all_cells, get_arch, get_shape
from ..kernels import ops
from ..models import get_model, input_specs, kv_dtype_for_cell
from ..parallel import spmd
from ..parallel import sharding as shd
from ..serve.server import cache_specs, placed_decode, placed_prefill
from ..train import optimizer as opt
from ..train.train_step import make_train_step
from . import roofline
from .mesh import make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
DEVICE = "cpu"           # where the fake tensors lie (they stand for the card's)
CARD_BYTES = 80e9        # one H100's device memory
PLACEMENT = {
    "train": {"params": "DTensors placed by sharding.param_shardings; the model takes each "
                        "rank's blocks, a checkpointed layer gathers its blocks over the data "
                        "axes where they are split (FSDP) inside, and again in the recompute; "
                        "weights split over 'model' stay this rank's block where that is its "
                        "part (attention under TP head padding, and the rwkv6 and Mamba2 blocks "
                        "whose heads do not divide 'model', gather over 'model' too; rwkv6's "
                        "small maa_w2 is used whole)",
              "grads": "at each param's placement: an FSDP leaf's reduce-scattered over the "
                       "data axes by its gather's backward, the rest reduce-scattered onto "
                       "their ZeRO-1 blocks after the backward",
              "loss": "vocab-parallel: the embedding, head and cross-entropy on each rank's "
                      "slice of the vocab ([B, T, V / model] logits)",
              "opt_state": "DTensors placed by sharding.opt_shardings (ZeRO-1); each rank "
                           "updates its block and gathers it over the data axes where the "
                           "param is not split",
              "batch": "rows over the data axes (sharding.input_shardings)"},
    "prefill": {"params": "DTensors placed by sharding.param_shardings; the model takes each "
                          "rank's blocks, and each layer gathers its blocks over the data axes "
                          "where they are split (FSDP); weights split over 'model' stay this "
                          "rank's block where that is its part (the rwkv6 and Mamba2 blocks "
                          "whose heads do not divide 'model' gather whole over it)",
                "tokens": "rows over the data axes (sharding.input_shardings; a batch that "
                          "does not divide them, whole on every rank)",
                "cache": "sharding.cache_shardings: rows over the data axes; the KV heads over "
                         "'model' where they divide it (each rank its q heads against its KV "
                         "heads), else the sequence (each rank its slots of every KV head: the "
                         "softmax's max and exp-sum and the partial outputs summed over "
                         "'model'); zamba2's shared-block K/V likewise. rwkv6's wkv and "
                         "zamba2's SSD states by their heads over 'model', the shift states by "
                         "d and the conv tail by its channels (each layer gathers those two "
                         "over 'model' on entry and keeps its block on exit)",
                "logits": "sharding.logits_sharding: rows over the data axes, the vocab over "
                          "'model'",
                "model_axis": "prefill's attention on each rank's heads, padded to a "
                              "multiple of 'model'; decode's on its heads, or on its slots of "
                              "every head (each rank's columns of q, k and v gathered, its rows "
                              "of wo); the MLP's hidden dim and the MoE experts over 'model'; "
                              "the rwkv6 and Mamba2 blocks on each rank's heads (rwkv6's "
                              "channel mix on its share of d_ff, reduce-scattered onto its "
                              "d-block and gathered), whole on every rank where the heads do "
                              "not divide 'model'"},
}
PLACEMENT["decode"] = {**PLACEMENT["prefill"], "tokens": "the batch's tokens, placed as "
                       "prefill's"}


def fake_twin(tree, device):
    """A tree of fake tensors of ``tree``'s shapes, strides and dtypes on
    ``device``, made under the active ``FakeTensorMode``."""
    if isinstance(tree, dict):
        return {k: fake_twin(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):       # a NamedTuple
        return type(tree)(*(fake_twin(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(fake_twin(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype, device=device)
    return tree


def join_fake_world(world_size: int) -> None:
    """This process as rank 0 of a fake world of ``world_size`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _empty(spec):
    return {k: torch.zeros(s, dtype=dt, device=DEVICE) for k, (s, dt) in spec.items()}


def lower_cell(arch_name: str, shape_name: str, multi_pod: bool):
    """One cell's call on fake tensors, counted; returns (cfg, shape, mesh,
    count, seconds of the counted call, a train step's ``spmd.GATHERS``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, shape = get_arch(arch_name), get_shape(shape_name)
    api = get_model(cfg)
    join_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=DEVICE)
    kv = kv_dtype_for_cell(cfg, shape_name)
    count = roofline.Count(DEVICE)
    spmd.GATHERS.clear()
    with FakeTensorMode(), ops.kernel_path():
        whole = api.init(0, torch.bfloat16, DEVICE)
        params = shd.distribute_tree(whole, shd.param_shardings(cfg, whole, mesh), mesh)
        del whole
        ins = _empty(input_specs(cfg, shape))
        ins = shd.distribute_tree(ins, shd.input_shardings(mesh, ins), mesh)
        count.track(params, "params")
        count.track(ins, "other")
        if shape.kind == "train":
            oc = opt.opt_config_for(cfg)
            state = opt.init_opt_state(oc, params, shd.opt_shardings(cfg, params, mesh))
            step = make_train_step(cfg, oc)
            count.track((state.step, state.mu, state.nu, state.master), "opt_state")
            t0 = time.perf_counter()
            with count:
                step(params, state, ins)
        elif shape.kind == "prefill":
            t0 = time.perf_counter()
            with count:
                placed_prefill(cfg, params, ins["tokens"], shape.seq_len, kv, mesh)
        else:
            spec = api.cache_spec(shape.global_batch, shape.seq_len, kv)
            cache = shd.distribute_tree(_empty(spec), cache_specs(
                cfg, {name: dims for name, (dims, _) in spec.items()}, mesh), mesh)
            count.track(cache, "cache")
            t0 = time.perf_counter()
            with count:
                placed_decode(cfg, params, ins["token"], cache, shape.seq_len - 1, mesh)
        lower_s = time.perf_counter() - t0
    return cfg, shape, mesh, count, lower_s, dict(spmd.GATHERS)


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: Path = RESULTS) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch_name}__{shape_name}__{mesh_name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    result = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name, "ok": False}
    t0 = time.perf_counter()
    try:
        cfg, shape, mesh, count, lower_s, gathers = lower_cell(arch_name, shape_name, multi_pod)
        n_dev = mesh.size()
        totals = count.totals()
        mem = count.memory()
        coll_bytes, coll_count = count.collectives()
        mf = roofline.model_flops_per_device(cfg, shape, n_dev)
        result.update(
            world=n_dev, mesh_shape=dict(zip(mesh.mesh_dim_names, mesh.shape)),
            fake_device=f"{DEVICE} (standing for cuda: the kernels' operators, fake)",
            kv_dtype=kv_dtype_for_cell(cfg, shape_name), placement=PLACEMENT[shape.kind],
            lower_s=lower_s, kernel_calls=dict(count.kernel_calls),
            param_gathers=gathers,
            memory={**mem, "fits_80gb": mem["peak_bytes"] <= CARD_BYTES},
            cost={"flops": totals["dot_flops"], "bytes accessed": totals["traffic_bytes"]},
            collective_bytes=coll_bytes, collective_count=coll_count, totals=totals,
            roofline=roofline.roofline_terms(totals), model_flops_per_device=mf,
            flops_over_model_flops=totals["dot_flops"] / mf,
        )
        result["ok"] = True
        print(f"[{tag}] roofline: {result['roofline']}; peak "
              f"{mem['peak_bytes'] / 1e9:.2f} GB a rank")
    except Exception as e:      # a failed cell is recorded, and the grid goes on
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        print(f"[{tag}] FAILED: {result['error']}")
    result["total_s"] = time.perf_counter() - t0
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))
    return result


def table(records: List[dict]) -> str:
    """The grid as a markdown table, a row per (arch, shape): each number for the
    single-pod mesh, then the multi-pod one where both ran (counts per rank; bounds
    on the H100's published peaks)."""
    rows = {}
    for r in records:
        rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r

    def both(cell, fn):
        return " / ".join(fn(cell[m]) if cell[m].get("ok") else "failed"
                          for m in ("pod16x16", "pod2x16x16") if m in cell)

    def wire(r):
        kinds = {"all-reduce": "AR", "all-gather": "AG", "reduce-scatter": "RS",
                 "all-to-all": "A2A", "collective-permute": "CP", "broadcast": "BC"}
        t = r["totals"]
        return " ".join(f"{a} {t[f'wire_{k}'] / 1e9:.3g}" for k, a in kinds.items()
                        if f"wire_{k}" in t) or "0"
    out = ["| arch | shape | peak GB a rank | fits 80 GB | TFLOP | traffic TB | "
           "wire GB by kind | dominant | bound_s | flops / model flops |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), cell in rows.items():
        out.append("| " + " | ".join([
            arch, shape,
            both(cell, lambda r: f"{r['memory']['peak_bytes'] / 1e9:.1f}"),
            both(cell, lambda r: "yes" if r["memory"]["fits_80gb"] else "no"),
            both(cell, lambda r: f"{r['totals']['dot_flops'] / 1e12:.4g}"),
            both(cell, lambda r: f"{r['totals']['traffic_bytes'] / 1e12:.4g}"),
            both(cell, wire),
            both(cell, lambda r: r["roofline"]["dominant"]),
            both(cell, lambda r: f"{r['roofline']['bound_s']:.4g}"),
            both(cell, lambda r: f"{r['flops_over_model_flops']:.3g}")]) + " |")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS, help="where the records go")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    records = []
    t0 = time.perf_counter()
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}__{shape}__{'pod2x16x16' if mp else 'pod16x16'}"
            prev = args.out / f"{tag}.json"
            if args.skip_existing and prev.exists() and json.loads(prev.read_text()).get("ok"):
                print(f"[{tag}] cached OK")
                records.append(json.loads(prev.read_text()))
                continue
            records.append(run_cell(arch, shape, mp, args.out))
    n_ok = sum(r["ok"] for r in records)
    n_fail = len(records) - n_ok
    print(table(records))
    print(f"dry-run: {n_ok} ok, {n_fail} failed in {time.perf_counter() - t0:.1f} s")
    if dist.is_initialized():
        dist.destroy_process_group()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
