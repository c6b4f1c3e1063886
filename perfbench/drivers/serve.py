"""The ``serve`` driver: waves through ``BatchServer.serve``, one call a wave, in a closed loop.

Set-up draws the weights on the device, builds the server with ``batch``
slots and a cache of the longest prompt plus the longest answer, and
serves one warm-up wave at the longest prompt.  The window then serves the
traffic's waves one after another and closes at the end of the first wave
that ends ``seconds`` or more after it opened, so it holds whole waves.

The steps are timed by a wrapper around the server's ``api.prefill`` and
``api.decode`` that notes when each call is entered and adds no
synchronisation: the server reads each step's tokens to the host
(``.tolist()``) before it makes the next call, so the entry of a call is
the end of the step before it, and the return of ``serve`` the end of its
last step.  A gap between tokens runs from the end of one step of a wave
to the end of the next.  The server decodes a wave until its longest
request is done, so a request that asked for fewer tokens gets none from
the wave's last steps: the record keeps each request's length.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import torch

from .. import traffic, weights
from ..reference import layout as ref_layout
from ..reference import model as ref_model
from ..reference.precision import FP8, FP32, strict_fp32
from ..trace import span
from . import GcClock, param_dtype


class StepClock:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t0 = None
        self.wave = None
        self.decodes = 0
        self.traced_until = None

    def note(self, kind: str) -> None:
        now = time.perf_counter()
        if self.wave is None:
            return
        self.wave["entries"].append(now)
        if self.t0 is None:
            return
        tracer, cell = self.ctx.tracer, self.ctx.cell
        if kind == "decode" and tracer is not None:
            self.decodes += 1
            first = cell["trace_decode_from"]
            if self.decodes == first:
                tracer.start()
            elif self.decodes == first + cell["trace_decode_steps"] and tracer.active:
                tracer.stop()
                self.traced_until = time.perf_counter() - self.t0

    def wrap(self, api):
        def prefill(*a, **k):
            self.note("prefill")
            with span("pb:prefill"):
                return api.prefill(*a, **k)

        def decode(*a, **k):
            self.note("decode")
            with span("pb:decode"):
                return api.decode(*a, **k)
        return dataclasses.replace(api, prefill=prefill, decode=decode)


def run(ctx) -> Dict:
    from repro_torch.configs.base import ArchConfig
    from repro_torch.serve.server import BatchServer, Request

    arch, mix, seed, dev = ctx.config["arch"], ctx.traffic, ctx.seed, ctx.device
    pdt = param_dtype(ctx)
    cfg = ArchConfig(**arch)
    lay = ref_layout.layout(arch)
    b = mix["batch"]
    smax = mix["prompt_tokens"][1] + mix["new_tokens"][1]
    params = weights.nest(weights.make(lay, seed, pdt, dev))
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


def draw_sample(finished, n: int, seed: int):
    """``n`` finished requests drawn from the seed, the longest (prompt and
    answer) among them."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: len(finished[i][1].prompt) + finished[i][1].max_new)
    rest = [i for i in range(len(finished)) if i != longest]
    pick = traffic.rng(seed, 3).permutation(rest)[:max(n - 1, 0)]
    return [finished[i] for i in [longest, *sorted(int(i) for i in pick)]]


def _passes(sample, rows_per_pass: int):
    """The sampled requests as the rows their waves computed, in passes:
    each prompt left-padded with token 0 to its wave's longest, then its
    output tokens but the last, then token 0 up to the pass's longest row
    (after every position compared, so causal attention never sees it).
    Yields (rows, p0, outs): the position p0 + j predicted output token j."""
    by_wave: Dict[int, list] = {}
    for wave, r in sample:
        by_wave.setdefault(id(wave), []).append((wave, r))
    for group in by_wave.values():
        for i in range(0, len(group), rows_per_pass):
            part = group[i:i + rows_per_pass]
            max_p = part[0][0]["max_p"]
            rows = [[0] * (max_p - len(r.prompt)) + list(r.prompt) + list(r.out[:-1])
                    for _, r in part]
            width = max(map(len, rows))
            yield ([row + [0] * (width - len(row)) for row in rows], max_p - 1,
                   [list(r.out) for _, r in part])


def _reference(ctx, arch, lay, prec):
    strict_fp32()
    w = weights.make(lay, ctx.seed, param_dtype(ctx), ctx.device)
    return lambda rows: ref_model.forward_logits(
        arch, w, torch.tensor(rows, dtype=torch.long, device=ctx.device), prec)


def served_gap(ctx, arch, lay, sample) -> float:
    """The widest gap by which a served token's logit lies below the reference's best."""
    if not sample:
        return float("inf")
    ref = _reference(ctx, arch, lay, FP32)
    worst = 0.0
    for rows, p0, outs in _passes(sample, ctx.cell["check"]["rows_per_pass"]):
        z = ref(rows)
        for zr, out in zip(z, outs):
            if len(out) == 0 or not all(0 <= t < arch["vocab"] for t in out):
                return float("inf")
            zo = zr[p0:p0 + len(out)]
            picked = zo.gather(-1, torch.tensor(out, device=zo.device)[:, None])[:, 0]
            worst = max(worst, float((zo.max(-1).values - picked).max()))
    return worst


def control_readings(ctx, arch, lay, sample) -> Dict:
    """The control: at each served position, the gap of the token that the
    reference in fp8 puts first."""
    ref = _reference(ctx, arch, lay, FP32)
    ctl = _reference(ctx, arch, lay, FP8)
    worst = 0.0
    for rows, p0, outs in _passes(sample, ctx.cell["check"]["rows_per_pass"]):
        z, zc = ref(rows), ctl(rows)
        for zr, cr, out in zip(z, zc, outs):
            zo, co = zr[p0:p0 + len(out)], cr[p0:p0 + len(out)]
            picked = zo.gather(-1, co.argmax(-1, keepdim=True))[:, 0]
            worst = max(worst, float((zo.max(-1).values - picked).max()))
    return {"logit_gap": worst}
