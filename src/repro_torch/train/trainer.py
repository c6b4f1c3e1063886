"""Trainer: the training loop over the model, the optimizer and a volume.

Mirrors ``repro.train.trainer``:
  * a checkpoint every ``ckpt_every`` steps through ``CheckpointManager``
    (crash-safe commit order, CRC-checked restore), of the state tree
    ``{params, mu, nu, master, step}``;
  * ``Trainer.resume()`` restores params, optimizer state and step from the
    volume, and ``ShardReader.batch_at`` replays the same batches, so a
    crash and resume reproduce the uninterrupted run bit for bit;
  * a checkpoint written with one shard count restores with another.
The train step runs eagerly (``make_train_step``), where the reference
jits it.  ``resume`` fills the trainer's own tensors in place, so a state
of tens of GB is never held twice on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import obs, resolve_device
from ..configs.base import ArchConfig
from ..models import get_model
from ..storage.checkpoint import CheckpointManager
from ..storage.datapipe import ShardReader
from . import optimizer as opt
from .train_step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    ckpt_every: int = 5
    ckpt_base: str = "/ckpt"
    log_every: int = 1
    max_steps: int = 100
    micro_batches: int = 1        # kept from the reference, which never reads it either


class Trainer:
    def __init__(self, cfg: ArchConfig, oc: opt.OptConfig, tc: TrainerConfig,
                 mount, reader: ShardReader, seed: int = 0,
                 param_dtype=torch.float32, device="cuda"):
        self.cfg = cfg
        self.oc = oc
        self.tc = tc
        self.reader = reader
        self.device = resolve_device(device)
        self.api = get_model(cfg)
        self.ckpt = CheckpointManager(mount, tc.ckpt_base, shards=2)
        self.step_fn = make_train_step(cfg, oc)
        self.params = self.api.init(seed, param_dtype, self.device)
        self.opt_state = opt.init_opt_state(oc, self.params)
        self.step = 0
        self.history: list = []

    # ---- persistence ---------------------------------------------------------
    def state_tree(self) -> Dict[str, Any]:
        return {"params": self.params,
                "mu": self.opt_state.mu, "nu": self.opt_state.nu,
                "master": self.opt_state.master,
                "step": self.opt_state.step}

    def save(self, crash_after: Optional[int] = None) -> None:
        self.ckpt.save(self.step, self.state_tree(), crash_after=crash_after)

    def resume(self) -> bool:
        """Restore the latest checkpoint into this trainer; False if there is none."""
        if self.ckpt.latest_step() is None:
            return False
        _, self.step = self.ckpt.restore(self.state_tree())
        return True

    # ---- loop ------------------------------------------------------------------
    def train(self, n_steps: Optional[int] = None,
              crash_at: Optional[int] = None) -> list:
        n = n_steps if n_steps is not None else self.tc.max_steps
        target = self.step + n
        while self.step < target:
            with obs.span("train.step"):
                batch = {k: torch.from_numpy(v).to(self.device, torch.long)
                         for k, v in self.reader.batch_at(self.step).items()}
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                self.step += 1
                if self.step % self.tc.log_every == 0:
                    self.history.append(
                        {"step": self.step,
                         "loss": float(metrics["loss"]),
                         "grad_norm": float(metrics["grad_norm"])})
            if crash_at is not None and self.step == crash_at:
                raise RuntimeError(f"injected trainer crash at step {self.step}")
            if self.step % self.tc.ckpt_every == 0:
                self.save()
        return self.history
