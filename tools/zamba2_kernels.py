"""Times the kernels Zamba2-7B's published block added, alone, at its serving shapes.

    python3 tools/zamba2_kernels.py [--reps 20]

K1 at head dim 224 (a wave's prefill at a site: B=32 x T=2048, 32 heads, bf16, the
block's softmax scale), K5 at head dim 224 (a decode step at a site: B=32, 2,304
slots of which 2,100 valid), K3 with B and C in 2 groups (a wave's prefill in a
Mamba2 layer: Bt=32 x T=2048, 112 heads of (64, 64)) and K6 (a decode step in a
Mamba2 layer: B=32, the same heads and groups): each one's mean device time
over ``--reps`` launches after a warm-up (CUDA events), its bound from
``kernels/work.py`` at the H100's published peaks (bytes at 3.35 TB/s; flops at
989 TFLOP/s bf16, 67 fp32, 494.7 TF32) and the share, and its largest error against
its plain version.  Prints one JSON line with the device's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.kernels import ref, work
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.mamba2_ssd import ssd_fwd
from repro_torch.kernels.mamba2_step import mamba2_step
from repro_torch.launch.roofline import PEAK_FLOPS

PEAK_BYTES = 3.35e12
SCALE = (224 / 2) ** -0.5


def device_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def row(name, ms, flops, nbytes, rate, err, shape) -> dict:
    bound = max(flops / PEAK_FLOPS[rate], nbytes / PEAK_BYTES) * 1e3
    by = "flops" if flops / PEAK_FLOPS[rate] > nbytes / PEAK_BYTES else "bytes"
    return {"kernel": name, "ms": ms, "bound_ms": bound, "bound_by": by,
            "share_pct": 100 * bound / ms, "max_abs_err": err, "shape": shape}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    reps = ap.parse_args().reps
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []

    b, t, h, hd = 32, 2048, 32, 224
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
               for s in ((b, t, h, 1, hd), (b, t, h, hd), (b, t, h, hd)))
    got = flash_attention_fwd(q, k, v, scale=SCALE)[0]
    want = ref._flash_fwd_impl(q[:1, :512], k[:1, :512], v[:1, :512], 0, 0, 512, 1024,
                               SCALE)[0]
    err = float((got[:1, :512].float() - want.float()).abs().max())
    ms = device_ms(lambda: flash_attention_fwd(q, k, v, scale=SCALE), reps)
    out.append(row("K1 hd 224", ms, *work.flash_fwd_work(b, t, t, h, 1, hd, 0, 0, 2), "bf16",
                   err, [b, t, h, 1, hd]))
    del q, k, v, got

    smax, n_valid = 2304, 2100
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn((b, smax, h, hd), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))
    got = decode_attention(q, kc, vc, n_valid, SCALE)
    want = ref.decode_attention(q.float(), kc.float(), vc.float(), n_valid, SCALE)
    err = float((got.float() - want).abs().max())
    ms = device_ms(lambda: decode_attention(q, kc, vc, n_valid, SCALE), 10 * reps)
    out.append(row("K5 hd 224", ms, *work.decode_attention_work(b, n_valid, h, 1, hd, 2),
                   "fp32", err, [b, smax, h, 1, hd, n_valid]))
    del q, kc, vc, got, want

    nh, p, n, g = 112, 64, 64, 2
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    x, dt = r(b, t, nh, p) * 0.5, torch.nn.functional.softplus(r(b, t, nh) - 1.0)
    A, B, C, s0 = -r(nh).abs(), r(b, t, g, n) * 0.5, r(b, t, g, n) * 0.5, r(b, nh, p, n) * 0.2
    y, _ = ssd_fwd(x, dt, A, B, C, s0)
    want, _ = ref.mamba2_ssd(x[:1, :512], dt[:1, :512], A, B[:1, :512], C[:1, :512], s0[:1])
    err = float((y[:1, :512] - want).abs().max())
    ms = device_ms(lambda: ssd_fwd(x, dt, A, B, C, s0), reps)
    flops, _, nbytes = work.ssd_work(b, t, nh, p, n, 128, g)
    out.append(row("K3 G 2", ms, flops, nbytes, "tf32", err, [b, t, nh, p, n, g]))
    del x, dt, B, C, y, want

    din, c = nh * p, nh * p + 2 * g * n
    bf = torch.bfloat16
    xs = (r(b, din + c + nh).to(bf), r(b, c, 3).to(bf), (r(4, c) * 0.2).to(bf),
          (r(c) * 0.02).to(bf), r(nh) - 4.0, -torch.arange(1, nh + 1, device=dev).float(),
          torch.ones(nh, device=dev), r(b, nh, p, n) * 0.2, torch.ones(din, device=dev, dtype=bf))
    mine = [x.clone() for x in xs]
    got = mamba2_step(*mine, g, 1e-5)
    want = ref.mamba2_step(*[x.clone() for x in xs], g, 1e-5)
    err = float((got.float() - want.float()).abs().max())
    ms = device_ms(lambda: mamba2_step(*mine, g, 1e-5), 10 * reps)
    out.append(row("K6", ms, *work.mamba2_step_work(b, nh, p, n, g), "fp32", err,
                   [b, nh, p, n, g]))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": smi, "kernels": out}))


if __name__ == "__main__":
    main()
