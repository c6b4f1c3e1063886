"""Each flash path against float64, on one card: which side of a disagreement is wrong.

    python3 tools/flash_fp64_check.py

For causal GQA shapes at T=2048 (the trained archs' kv heads and groups, mixtral-8x22b's
window, and one with scores four times as large), in fp32 and bf16: the forward and
backward kernels (K1, K1-bwd) and the plain versions (``ref._flash_fwd_impl`` /
``_flash_bwd_impl``), each against autograd of the naive attention in float64 on the
same inputs, as the largest difference over the float64 value's largest.  One JSON line
a shape.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)

# (B, T, KV, G, hd, window, input scale)
SHAPES = ((1, 2048, 32, 1, 128, 0, 1.0), (1, 2048, 10, 4, 128, 0, 1.0),
          (1, 2048, 8, 8, 128, 0, 1.0), (1, 2048, 8, 6, 128, 4096, 1.0),
          (1, 2048, 10, 4, 128, 0, 4.0), (1, 2048, 2, 2, 128, 0, 1.0),
          (1, 2048, 4, 4, 64, 0, 1.0), (1, 2048, 4, 4, 128, 0, 1.0),
          (1, 2048, 4, 3, 128, 0, 1.0), (1, 2048, 4, 8, 128, 0, 1.0))


def naive64(q, k, v, window):
    t, hd = q.shape[1], q.shape[-1]
    s = torch.einsum("bqkgh,bskh->bkgqs", q, k) / hd ** 0.5
    pos = torch.arange(t, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, -1), v)


def rel(a, want):
    return float((a.double() - want).abs().max() / want.abs().max())


def main() -> None:
    print(cs.device_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs._build.build_all(["flash_attention", "flash_attention_bwd"])
    for b, t, kv, g, hd, window, scale in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(7)
        q = torch.randn((b, t, kv, g, hd), generator=gen, device="cuda", dtype=torch.float64)
        k = torch.randn((b, t, kv, hd), generator=gen, device="cuda", dtype=torch.float64)
        v = torch.randn((b, t, kv, hd), generator=gen, device="cuda", dtype=torch.float64)
        do = torch.randn((b, t, kv, g, hd), generator=gen, device="cuda", dtype=torch.float64)
        q, k = q * scale, k * scale
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o64 = naive64(*leaves, window)
        want = torch.autograd.grad(o64, leaves, do)
        o64 = o64.detach()
        res = {"shape": [b, t, kv, g, hd], "window": window, "scale": scale}
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd, dod = (x.to(dt) for x in (q, k, v, do))
            out, lse = flash_attention_fwd(qd, kd, vd, window=window)
            got = flash_attention_bwd(qd, kd, vd, out, lse, dod, window, 0)
            p_out, p_lse = ref._flash_fwd_impl(qd, kd, vd, 0, window, 512, 1024)
            plain = ref._flash_bwd_impl(qd, kd, vd, p_lse, dod, 0, window, 512, 1024)
            res[str(dt).split(".")[-1]] = {
                "out_kernel": rel(out, o64), "out_plain": rel(p_out, o64),
                "lse_kernel_vs_plain": float((lse - p_lse).abs().max()),
                "dq_dk_dv_kernel": [rel(a, w) for a, w in zip(got, want)],
                "dq_dk_dv_plain": [rel(a, w) for a, w in zip(plain, want)]}
        print(json.dumps(res), flush=True)
        del leaves, want, o64
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
