"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [--device cuda|cpu]``.

Random-initialises the reduced configuration of ``--arch`` in fp32 from a
fixed seed, the reference's on either device (there is no checkpoint
restore), then serves a batch of synthetic requests through prefill + cached decode and
prints the generated tokens.  Every family is served (``--arch mixtral-8x22b``,
``--arch arctic-480b``, ``--arch rwkv6-1.6b``, ``--arch zamba2-7b``, the
dense ones), and the port's own ``--arch zamba2-7b-instruct``, the published
Zamba2-7B hybrid."""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from ..configs import ARCH_NAMES, PORT_ARCHS, get_arch
from ..models import get_model
from ..serve.server import BatchServer, Request


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b", choices=ARCH_NAMES + list(PORT_ARCHS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).reduced()
    api = get_model(cfg)
    params = api.init(0, torch.float32, args.device)
    srv = BatchServer(cfg, params, batch=args.batch, smax=96, device=args.device)
    reqs = [Request(rid=i, prompt=[(7 * i + j) % cfg.vocab
                                   for j in range(5 + i % 3)],
                    max_new=args.max_new)
            for i in range(args.requests)]
    done = srv.serve(reqs)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt={r.prompt} -> {r.out}")
    print(f"served {len(done)} requests in batches of {args.batch}")


if __name__ == "__main__":
    main()
