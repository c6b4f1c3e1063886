"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--device cuda|cpu]``.

Trains the reduced configuration of ``--arch`` end to end: writes a token
dataset into a volume on a local directory (``--root``; by default a fresh
temporary directory, removed at exit), trains through ``Trainer`` with
checkpoints on that volume, and, with ``--crash-at``, injects a crash and
resumes from the last checkpoint.  The same flags as
``repro.launch.train``, plus ``--device`` and ``--root``.  Every family
trains (``--arch rwkv6-1.6b`` and ``--arch zamba2-7b`` through their scans'
backward kernels on the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import List, Optional

import numpy as np

from ..configs import ARCH_NAMES, get_arch
from ..configs.base import ArchConfig
from ..storage.datapipe import ShardReader, ShardWriter
from ..storage.volume import LocalMount
from ..train import optimizer as opt
from ..train.trainer import Trainer, TrainerConfig


def reduced_config(arch: str, device: str) -> ArchConfig:
    """The reduced configuration of ``arch``, as the reference's launchers run it.
    On the card, the ssm and hybrid families' scan head size (32) and SSD state
    (16) are raised to 64: the only sizes the WKV6 and SSD kernels are compiled for."""
    cfg = get_arch(arch).reduced()
    if device == "cuda" and cfg.family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(cfg, ssm_head_dim=64,
                                  ssm_state=64 if cfg.family == "hybrid" else cfg.ssm_state)
    return cfg


def write_dataset(mnt, vocab: int, n_docs: int = 8) -> None:
    """Arithmetic token sequences, (start + 3 i) mod min(vocab, 97), as the
    reference writes them."""
    w = ShardWriter(mnt, "/data", tokens_per_shard=8192)
    rng = np.random.RandomState(0)
    for _ in range(n_docs):
        start = rng.randint(0, min(vocab, 97))
        w.add_document([(start + 3 * i) % min(vocab, 97) for i in range(4000)])
    w.finish()


def run(args, root: str) -> Trainer:
    cfg = reduced_config(args.arch, args.device)
    print(f"arch={cfg.name} (reduced: {cfg.n_layers}L d={cfg.d_model}) on {args.device}, "
          f"volume {root}")
    mnt = LocalMount(root)
    write_dataset(mnt, cfg.vocab)
    oc = opt.opt_config_for(cfg, lr=1e-3, warmup_steps=5, total_steps=args.steps)
    tc = TrainerConfig(ckpt_every=args.ckpt_every, max_steps=args.steps)
    reader = ShardReader(mnt, "/data", rank=0, world=1, batch=args.batch, seq_len=args.seq)
    trainer = Trainer(cfg, oc, tc, mnt, reader, device=args.device)
    try:
        trainer.train(args.steps, crash_at=args.crash_at)
    except RuntimeError as e:
        if args.crash_at is None or "injected" not in str(e):
            raise
        print(f"!! {e} -- resuming from the checkpoint on the volume")
        trainer = Trainer(cfg, oc, tc, mnt, reader, device=args.device)
        if not trainer.resume():
            raise RuntimeError("no checkpoint to resume from") from e
        print(f"resumed at step {trainer.step}")
        trainer.train(args.steps - trainer.step)
    for h in trainer.history:
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  |g| {h['grad_norm']:.3f}")
    print(f"checkpoints on volume: {trainer.ckpt.list_steps()}")
    return trainer


def main(argv: Optional[List[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a crash at this step, then resume")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--root", default=None,
                    help="the volume's directory (default: a fresh temporary one)")
    args = ap.parse_args(argv)
    if args.root is not None:
        return run(args, args.root)
    with tempfile.TemporaryDirectory(prefix="repro_torch_volume_") as root:
        return run(args, root)


if __name__ == "__main__":
    main()
