"""The ``train`` driver: ``Trainer.train`` on volume ``train`` of the port's CFS.

Set-up writes the traffic's documents through the program's
``ShardWriter`` into a fresh ``launch.train.build_cluster()``, builds one
``Trainer`` (its batches read by ``ShardReader.batch_at`` through hedged
reads), draws the benchmark's weights into the trainer's parameters and
master weights, and runs the first three steps through ``Trainer.train``:
they are the warm-up and the steps the reference follows.  The same
trainer then trains one step a call until the window closes at the first
step that ends ``seconds`` or more after it opened; no checkpoint falls in
it.  The window's steps are timed on the host: ``Trainer.train`` returns
after reading the step's loss, which waits for the whole step.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import check, traffic, weights
from ..reference import layout as ref_layout
from ..reference import train as ref_train
from ..reference.precision import FP8, FP32, strict_fp32
from ..trace import span
from . import GcClock, param_dtype

CHECKED_STEPS = 3


def reference_batches(docs: List[np.ndarray], mix: Dict, order_seed: int,
                      steps: int) -> List[Dict[str, np.ndarray]]:
    """The batches of the first ``steps`` steps, from the documents as
    written: packed into shards of ``tokens_per_shard`` (the last padded with
    zeros), the shards in the order a ``RandomState(order_seed)`` shuffle
    gives, each step taking the next ``batch * (seq_len + 1)`` tokens."""
    tps, b, t = mix["tokens_per_shard"], mix["batch"], mix["seq_len"]
    stream = np.concatenate(docs)
    stream = np.concatenate([stream, np.zeros((-len(stream)) % tps, np.int32)])
    order = list(range(len(stream) // tps))
    np.random.RandomState(order_seed).shuffle(order)
    stream = stream.reshape(-1, tps)[order].reshape(-1)
    need = b * (t + 1)
    out = []
    for s in range(steps):
        rows = stream[s * need:(s + 1) * need].reshape(b, t + 1)
        out.append({"tokens": rows[:, :-1], "labels": rows[:, 1:]})
    return out


def leaf_norms(tree: Dict, scale: float = 1.0) -> Dict:
    return {p: float(t.float().norm()) * scale for p, t in weights.flatten(tree)}


def change_norms(current: Dict, lay, seed: int, pdt, device) -> Dict:
    """Each leaf's norm of (current - its initial draw), drawing the initial
    values again one leaf at a time."""
    out = {}
    for path, t in current.items():
        w0 = weights.make(lay, seed, pdt, device, only=[path])[path]
        out[path] = float((t.float() - w0.float()).norm())
    return out


def opt_overrides(opt: Dict) -> Dict:
    return {**opt, "betas": tuple(opt["betas"])}


def run(ctx) -> Dict:
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch.train import build_cluster
    from repro_torch.storage.datapipe import ShardReader, ShardWriter
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch, mix, seed, dev = ctx.config["arch"], ctx.traffic, ctx.seed, ctx.device
    pdt = param_dtype(ctx)
    cfg = ArchConfig(**arch)
    lay = ref_layout.layout(arch)
    b, t = mix["batch"], mix["seq_len"]
    steps_max = CHECKED_STEPS + math.ceil(ctx.seconds * mix["max_steps_per_second"]) + 2
    docs = traffic.documents(mix, cfg.vocab, seed, steps_max * b * (t + 1))
    order_seed = seed % (1 << 32)

    mnt = build_cluster().mount("train")
    writer = ShardWriter(mnt, "/data", tokens_per_shard=mix["tokens_per_shard"])
    for d in docs:
        writer.add_document(d.tolist())
    writer.finish()
    reader = ShardReader(mnt, "/data", rank=0, world=1, batch=b, seq_len=t, seed=order_seed)
    batch_s: List[float] = []
    consumed: List[Dict[str, np.ndarray]] = []
    batch_at = reader.batch_at

    def timed_batch_at(step):
        t0 = time.perf_counter()
        with span("pb:batch_at"):
            out = batch_at(step)
        batch_s.append(time.perf_counter() - t0)
        if len(consumed) < CHECKED_STEPS:
            consumed.append({k: v.copy() for k, v in out.items()})
        return out

    reader.batch_at = timed_batch_at
    oc = opt.opt_config_for(cfg, **opt_overrides(ctx.cell["optimizer"]))
    tc = TrainerConfig(ckpt_every=1 << 30, max_steps=1 << 30)
    trainer = Trainer(cfg, oc, tc, mnt, reader, seed=0, param_dtype=pdt, device=dev)
    weights.fill(trainer.params, lay, seed, pdt)
    state = trainer.opt_state
    if state.master is not None:
        for (_, p), (_, m) in zip(weights.flatten(trainer.params),
                                  weights.flatten(state.master)):
            m.copy_(p.float())
    if ctx.hooks.get("trainer"):
        ctx.hooks["trainer"](trainer)

    trainer.train(1)
    first_grad = leaf_norms(trainer.opt_state.mu, 1.0 / (1.0 - oc.betas[0]))
    trainer.train(CHECKED_STEPS - 1)
    moved = trainer.opt_state.master if trainer.opt_state.master is not None else trainer.params
    prog = {"loss": [h["loss"] for h in trainer.history[:CHECKED_STEPS]],
            "grad_norm": [h["grad_norm"] for h in trainer.history[:CHECKED_STEPS]],
            "first_grad": first_grad,
            "change": change_norms(dict(weights.flatten(moved)), lay, seed, pdt, dev)}
    del moved
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    gc_clock = GcClock().open()

    ends: List[float] = []
    traced_until = None
    n_batch_setup = len(batch_s)
    if ctx.seconds > 0:
        t0 = time.perf_counter()
        while True:
            if ctx.tracer is not None and not ends:
                ctx.tracer.start()
            with span("pb:train_step"):
                trainer.train(1)
            ends.append(time.perf_counter() - t0)
            if ctx.tracer is not None and ctx.tracer.active and len(ends) == ctx.cell["trace_steps"]:
                ctx.tracer.stop()
                traced_until = time.perf_counter() - t0
            if ends[-1] >= ctx.seconds:
                break
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    host = gc_clock.close()
    if ctx.tracer is not None and ctx.tracer.active:
        ctx.tracer.stop()

    del trainer, state, reader, mnt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref_b = reference_batches(docs, mix, order_seed, CHECKED_STEPS)
    prog["batch_tokens_wrong"] = int(sum(
        (np.asarray(c[k]) != r[k]).sum() for c, r in zip(consumed, ref_b) for k in r)
        + sum(r[k].size for r in ref_b[len(consumed):] for k in r))
    readings = reference_readings(ctx, arch, lay, ref_b, prog, FP32)
    check_s = time.perf_counter() - t_check
    for name, fn in ctx.extra_readings.items():
        readings[name] = fn(ctx, arch, lay, ref_b, prog)
    return {"kind": "train", "setup_s": setup_s, "step_ends": ends,
            "window_s": ends[-1] if ends else 0.0, "tokens_per_step": b * t,
            "traced_until": traced_until,
            "batch_s": batch_s[n_batch_setup:], "memory_peak_bytes": peak, "host": host,
            "attempted": len(ends), "failed": 0, "check_s": check_s,
            "numbers": readings["program"], "readings": readings}


def reference_run(ctx, arch, lay, batches, prec, rows=None):
    """The reference's three steps from the seed's weights; returns its
    losses, gradient norms, first gradient by leaf and change by leaf."""
    strict_fp32()
    dev, pdt = ctx.device, param_dtype(ctx)
    params = {}
    for path, w in weights.make(lay, ctx.seed, pdt, dev).items():
        params[path] = w.float()
    sel = slice(None) if rows is None else slice(0, rows)
    tb = [{k: torch.as_tensor(np.ascontiguousarray(v[sel]), dtype=torch.long, device=dev)
           for k, v in bt.items()} for bt in batches]
    out = ref_train.train(arch, params, ctx.cell["optimizer"], tb, prec)
    out["change"] = change_norms(params, lay, ctx.seed, pdt, dev)
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def reference_readings(ctx, arch, lay, batches, prog, prec) -> Dict:
    ref = reference_run(ctx, arch, lay, batches, prec)
    ctx.reference = ref
    return {"program": check.train_numbers(prog, ref, ref["change"])}


def control_readings(ctx, arch, lay, batches, prog) -> Dict:
    """The control: the reference in fp8 in the program's place."""
    ctl = reference_run(ctx, arch, lay, batches, FP8)
    return check.train_numbers({**ctl, "batch_tokens_wrong": 0}, ctx.reference,
                               ctx.reference["change"])


def half_batch_readings(ctx, arch, lay, batches, prog) -> Dict:
    """The fault: half of the batch left out, the mean over the rest."""
    half = reference_run(ctx, arch, lay, batches, FP32, rows=ctx.traffic["batch"] // 2)
    return check.train_numbers({**half, "batch_tokens_wrong": 0}, ctx.reference,
                               ctx.reference["change"])

