"""The ``serve_hybrid`` driver: the ``serve`` driver's waves for the published
Zamba2 hybrid (``zamba2-7b-instruct``), through the same ``BatchServer``.

Everything but the model is ``serve``'s: the same set-up (weights drawn on the
device, a server of ``batch`` slots and a cache of the longest prompt plus the
longest answer, one warm-up wave at the longest prompt), the same window of
whole waves, the same step clock (``StepClock``) and traced decode steps, the
same sample of finished requests (``draw_sample``) and passes over it
(``_passes``), and the same record.  The weights come from ``weights_hybrid``
(the hybrid's layout and Mamba2's own initial values) and the check from the
hybrid's plain reference (``reference.hybrid``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from .. import traffic, weights, weights_hybrid
from ..reference import hybrid as ref_hybrid
from ..reference import hybrid_layout
from ..reference.precision import FP8, FP32, strict_fp32
from ..trace import span
from . import GcClock, param_dtype
from .serve import StepClock, _passes, draw_sample


def run(ctx) -> Dict:
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serve.server import BatchServer, Request

    arch, mix, seed, dev = ctx.config["arch"], ctx.traffic, ctx.seed, ctx.device
    pdt = param_dtype(ctx)
    cfg = ArchConfig(**arch)
    lay = hybrid_layout.layout(arch)
    b = mix["batch"]
    smax = mix["prompt_tokens"][1] + mix["new_tokens"][1]
    params = weights.nest(weights_hybrid.make(lay, seed, pdt, dev))
    server = BatchServer(cfg, params, batch=b, smax=smax, device=dev)
    clock = StepClock(ctx)
    server.api = clock.wrap(server.api)
    if ctx.hooks.get("server"):
        ctx.hooks["server"](server)
    warm = traffic.rng(seed, 4).integers(0, cfg.vocab, (b, mix["prompt_tokens"][1]))
    server.serve([Request(-2 - i, p.tolist(), mix["warmup_new"]) for i, p in enumerate(warm)])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t_start
    gc_clock = GcClock().open()

    waves: List[Dict] = []
    gen = traffic.waves(mix, cfg.vocab, seed)
    rid = 0
    clock.t0 = t0 = time.perf_counter()
    while ctx.seconds > 0:
        prompts, news = next(gen)
        reqs = [Request(rid + i, p.tolist(), n) for i, (p, n) in enumerate(zip(prompts, news))]
        rid += len(reqs)
        wave = {"entries": [], "end": None, "reqs": reqs,
                "max_p": max(len(p) for p in prompts)}
        clock.wave = wave
        wave["start"] = time.perf_counter()
        with span("pb:wave"):
            server.serve(reqs)
        wave["end"] = time.perf_counter()
        waves.append(wave)
        if wave["end"] - t0 >= ctx.seconds:
            break
    clock.wave = None
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    host = gc_clock.close()
    if ctx.tracer is not None and ctx.tracer.active:
        ctx.tracer.stop()

    for w in waves:
        w["start"] -= t0
        w["entries"] = [e - t0 for e in w["entries"]]
        w["end"] -= t0
    window_s = waves[-1]["end"] if waves else 0.0
    finished = [(w, r) for w in waves for r in w["reqs"]]
    failed = sum(1 for _, r in finished if r.out is None or len(r.out) != r.max_new)
    del server, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    sample = draw_sample(finished, ctx.cell["check"]["sample"], seed)
    readings = {"program": {"logit_gap": served_gap(ctx, arch, lay, sample)}}
    check_s = time.perf_counter() - t_check
    for name, fn in ctx.extra_readings.items():
        readings[name] = fn(ctx, arch, lay, sample)
    return {"kind": "serve", "setup_s": setup_s, "window_s": window_s,
            "batch": b, "traced_until": clock.traced_until,
            "waves": [{k: w[k] for k in ("start", "entries", "end", "max_p")} |
                      {"new": [r.max_new for r in w["reqs"]]} for w in waves],
            "memory_peak_bytes": peak, "host": host,
            "attempted": sum(len(w["reqs"]) for w in waves), "failed": failed,
            "check_s": check_s,
            "numbers": readings["program"], "readings": readings}


def _reference(ctx, arch, w, prec):
    return lambda rows: ref_hybrid.forward_logits(
        arch, w, torch.tensor(rows, dtype=torch.long, device=ctx.device), prec)


def _gaps(ctx, arch, lay, sample, pick) -> float:
    """The widest gap, below the reference's best logit, of the token that
    ``pick(reference logits, control logits or None, the served tokens)`` names
    at each compared position."""
    strict_fp32()
    w = weights_hybrid.make(lay, ctx.seed, param_dtype(ctx), ctx.device)
    ref = _reference(ctx, arch, w, FP32)
    ctl = _reference(ctx, arch, w, FP8) if pick is _control else None
    worst = 0.0
    for rows, p0, outs in _passes(sample, ctx.cell["check"]["rows_per_pass"]):
        z = ref(rows)
        zc = ctl(rows) if ctl is not None else [None] * len(outs)
        for zr, cr, out in zip(z, zc, outs):
            if len(out) == 0 or not all(0 <= t < arch["vocab"] for t in out):
                return float("inf")
            zo = zr[p0:p0 + len(out)]
            picked = zo.gather(-1, pick(zo, cr, out, p0)[:, None])[:, 0]
            worst = max(worst, float((zo.max(-1).values - picked).max()))
    return worst


def _served(zo, cr, out, p0):
    return torch.tensor(out, device=zo.device)


def _control(zo, cr, out, p0):
    return cr[p0:p0 + len(out)].argmax(-1)


def served_gap(ctx, arch, lay, sample) -> float:
    """The widest gap by which a served token's logit lies below the reference's best."""
    if not sample:
        return float("inf")
    return _gaps(ctx, arch, lay, sample, _served)


def control_readings(ctx, arch, lay, sample) -> Dict:
    """The control: at each served position, the gap of the token that the
    reference in fp8 puts first."""
    return {"logit_gap": _gaps(ctx, arch, lay, sample, _control)}
