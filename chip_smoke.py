#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each fatal on failure:
  (a) device: the card's name and power limit (nvidia-smi);
  (b) build: nvcc compiles the port's CUDA sources for sm_90a;
  (c) kernels: each kernel against its plain PyTorch version on the card,
      with its time, the plain version's, one library call's and its bound;
  (d) serving: full-width codeqwen1.5-7b (random bf16 weights from a seed)
      serves 8 requests through ``BatchServer``; the flash kernel's launch
      count over that run is checked, then prefill/decode consistency and
      kernel-path vs plain-path prefill logits; last, one wave's prefill and
      decode steps run under torch.profiler for device time by kernel;
  (e) output: a ``kernels`` JSON line, a ``serving`` JSON line, the
      nvidia-smi line, and last the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serve.server import BatchServer, Request  # noqa: E402

# H100 SXM published dense peaks (NVIDIA data sheet), at a 700 W power limit
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_S = 3.35e12
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}   # tests/test_kernels_pallas.py
ARCH = "codeqwen1.5-7b"
# Full-width serving vs itself and vs the plain attention path: bf16 weights
# and activations (8-bit mantissa) through 32 layers, and a decode path whose
# attention rounds logits and probabilities to bf16 where the flash kernel
# keeps them in fp32.  Checked as |a-b| <= tol*(1 + |b|).
SERVE_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ (a) device

def device_line() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs "
                 "an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ (c) kernels

def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(tq: int, tk: int, q_offset: int, window: int) -> int:
    """(query, key) pairs the causal/window mask lets through: the work this input needs."""
    pos = q_offset + torch.arange(tq)
    hi = torch.clamp(pos + 1, max=tk)
    lo = torch.clamp(pos - window + 1, min=0) if window else torch.zeros_like(pos)
    return int(torch.clamp(hi - lo, min=0).sum())


def flash_case(b, tq, tk, kv, g, hd, window, q_offset, dtype, seed, timed=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, tq, kv, g, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, tk, kv, hd), generator=gen, device="cuda").to(dtype)
    out, lse = flash_attention_fwd(q, k, v, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    want, want_lse = ref._flash_fwd_impl(q, k, v, q_offset, window, 512, 1024)
    tol = TOL[dtype]
    err = (out.float() - want.float()).abs()
    lse_err = (lse - want_lse).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all()
              and (lse_err <= 2e-3 + 2e-3 * want_lse.abs()).all()
              and torch.isfinite(out).all())
    case = {"shape": {"B": b, "Tq": tq, "Tk": tk, "KV": kv, "G": g, "hd": hd},
            "window": window, "q_offset": q_offset, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": float(err.max()), "lse_max_abs_err": float(lse_err.max()),
            "tolerance": tol, "ok": ok}
    log(f"  case {json.dumps(case)}")
    if not ok:
        raise AssertionError(f"flash kernel disagrees with its plain version: {case}")
    if timed:
        flops = 4 * hd * b * kv * g * visible_pairs(tq, tk, q_offset, window)
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size() \
            + lse.numel() * 4
        t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / HBM_BYTES_S * 1e3
        case["ms"] = cuda_ms(lambda: flash_attention_fwd(q, k, v, window, q_offset), 20)
        case["plain_ms"] = cuda_ms(
            lambda: ref._flash_fwd_impl(q, k, v, q_offset, window, 512, 1024), 5)
        if not (g == 1 and window == 0 and q_offset == 0 and tq == tk):
            raise ValueError("the SDPA yardstick computes plain causal MHA only")
        qs, ks, vs = (x.reshape(b, x.shape[1], kv, hd).transpose(1, 2).contiguous()
                      for x in (q, k, v))
        case["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True), 20)
        case.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes")
    return case


def phase_kernels():
    log("(c) flash kernel vs plain version on the card")
    main = flash_case(4, 2048, 2048, 32, 1, 128, 0, 0, torch.bfloat16, 10, timed=True)
    others = [flash_case(1, 1000, 1100, 2, 4, 64, 256, 100, torch.float32, 11),
              flash_case(2, 333, 333, 4, 2, 32, 0, 0, torch.bfloat16, 12)]
    return main, others


# ------------------------------------------------------------------ (d) serving

def rel_close(a: torch.Tensor, b: torch.Tensor, tol: float):
    a, b = a.float(), b.float()
    err = float(((a - b).abs() / (1 + b.abs())).max())
    return err <= tol, err


def timed_api(api, stats):
    def wrap(name, fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stats[name] += time.perf_counter() - t0
            return out
        return call
    return dataclasses.replace(api, prefill=wrap("prefill", api.prefill),
                               decode=wrap("decode", api.decode))


def phase_serving():
    cfg = get_arch(ARCH)
    log(f"(d) serving {ARCH} at full width: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(0, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    log(f"  init {n_params / 1e9:.3f} B params (bf16) in {time.perf_counter() - t0:.1f} s")

    batch, smax, max_new, n_req = 4, 4096, 32, 8
    gen = torch.Generator().manual_seed(1)
    lengths = torch.randint(1024, 2049, (n_req,), generator=gen).tolist()
    reqs = [Request(rid=i, prompt=torch.randint(0, cfg.vocab, (n,), generator=gen).tolist(),
                    max_new=max_new) for i, n in enumerate(lengths)]
    srv = BatchServer(cfg, params, batch=batch, smax=smax, device="cuda")
    srv.serve([Request(rid=0, prompt=list(range(64)), max_new=2)])      # warm-up
    stats = {"prefill": 0.0, "decode": 0.0}
    srv.api = timed_api(srv.api, stats)
    torch.cuda.reset_peak_memory_stats()

    flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    done = srv.serve(reqs)
    wall = time.perf_counter() - t0
    launches = flash_attention_fwd.launches

    waves = -(-n_req // batch)
    if launches != cfg.n_layers * waves:
        raise AssertionError(f"flash kernel launched {launches} times on the serving "
                             f"path, expected {cfg.n_layers} layers x {waves} waves")
    if sorted(r.rid for r in done) != list(range(n_req)):
        raise AssertionError("not every request was served")
    for r in done:
        if len(r.out) != max_new or not all(0 <= t < cfg.vocab for t in r.out):
            raise AssertionError(f"request {r.rid}: bad output {r.out}")
    padded = sum(batch * max(lengths[w * batch:(w + 1) * batch]) for w in range(waves))
    serving = {
        "arch": ARCH, "requests": n_req, "batch": batch, "smax": smax,
        "max_new": max_new, "prompt_lengths": lengths, "waves": waves,
        "flash_launches": launches, "prompt_tokens": sum(lengths),
        "prefill_padded_tokens": padded,
        "prefill_s": stats["prefill"], "decode_s": stats["decode"], "wall_s": wall,
        "prefill_tok_s": sum(lengths) / stats["prefill"],
        "decode_tok_s": n_req * (max_new - 1) / stats["decode"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"  served: {json.dumps(serving)}")
    serving.update(check_consistency(cfg, api, params))
    serving["profile"] = profile_wave(cfg, api, params, batch, max(lengths), smax)
    return serving


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def check_consistency(cfg, api, params):
    """decode(prefill(x)) vs prefill(x + token) (tests/test_models_smoke.py), and
    kernel-path vs plain-path prefill logits, on the full-width weights."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, t = 2, 512
    toks = torch.randint(0, cfg.vocab, (b, t), generator=gen, device="cuda")
    with torch.inference_mode():
        logits_p, cache = api.prefill(params, toks, t + 8)
        nxt = logits_p[:, -1, :cfg.vocab].argmax(-1)
        logits_d, _ = api.decode(params, nxt[:, None], cache, t)
        full, _ = api.prefill(params, torch.cat([toks, nxt[:, None]], 1), t + 8)
        ok_d, err_d = rel_close(logits_d[:, 0], full[:, -1], SERVE_TOL)

        kernel_launches = flash_attention_fwd.launches
        saved = ops.flash_attention
        ops.flash_attention = lambda q, k, v, window=0, q_offset=0: ref.flash_attention(
            q, k, v, q_offset=q_offset, window=window)
        try:
            plain_p, _ = api.prefill(params, toks, t + 8)
        finally:
            ops.flash_attention = saved
        if flash_attention_fwd.launches != kernel_launches:
            raise AssertionError("the plain-path prefill launched the kernel")
        ok_k, err_k = rel_close(logits_p, plain_p, SERVE_TOL)
    res = {"consistency_B": b, "consistency_T": t, "tolerance": SERVE_TOL,
           "decode_vs_prefill_err": err_d, "kernel_vs_plain_prefill_err": err_k,
           "logit_absmax": float(full.float().abs().max())}
    log(f"  consistency: {json.dumps(res)}")
    if not (ok_d and ok_k and torch.isfinite(logits_d).all()):
        raise AssertionError(f"full-width consistency check failed: {res}")
    return res


def _device_summary(prof, wall_s: float):
    """Device time by kernel from a profiler run; the idle share is of ``wall_s``."""
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        return {"device_time": "not measured (the profiler recorded no device events)"}
    busy_s = sum(us for _, us, _ in rows) / 1e6
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_s * 1e3,
            "idle_share": 1 - busy_s / wall_s,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": n,
                     "share_of_busy": us / 1e6 / busy_s} for k, us, n in rows[:8]]}


def profile_wave(cfg, api, params, batch: int, t: int, smax: int, steps: int = 4):
    """Where the time goes in one serving wave: a prefill of [batch, t] and
    ``steps`` decode steps, each under torch.profiler (which adds host time)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (batch, t), generator=gen, device="cuda")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    res = {"batch": batch, "prefill_T": t, "decode_steps": steps}
    with torch.inference_mode():
        for phase in ("prefill", "decode"):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                if phase == "prefill":
                    logits, cache = api.prefill(params, toks, smax)
                else:
                    for i in range(steps):
                        nxt = logits[:, -1, :cfg.vocab].argmax(-1)
                        logits, cache = api.decode(params, nxt[:, None], cache, t + i)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            res[phase] = _device_summary(prof, wall)
    log(f"  profile: {json.dumps(res)}")
    return res


# ------------------------------------------------------------------ main

def main() -> None:
    smi = device_line()
    name = torch.cuda.get_device_name(0)
    log(f"(a) device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build("flash_attention")
    build_s = time.perf_counter() - t0
    log(f"(b) built flash_attention.cu in {build_s:.1f} s")
    for line in _build.build_logs.get("flash_attention", "").splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")):
            log(f"  ptxas: {line.strip()}")

    main_case, other_cases = phase_kernels()
    serving = phase_serving()

    kernel = {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:70",
        "launches": serving["flash_launches"],
        "max_abs_err": main_case["max_abs_err"], "tolerance": main_case["tolerance"],
        "ms": main_case["ms"], "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True)",
        "shape": main_case["shape"], "dtype": main_case["dtype"],
        "flops": main_case["flops"], "bytes": main_case["bytes"],
        "other_cases": other_cases,
    }
    print(json.dumps({"kernels": [kernel], "device": name, "nvidia_smi": smi,
                      "build_s": build_s}))
    print(json.dumps({"serving": serving, "device": name, "nvidia_smi": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
