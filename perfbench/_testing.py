"""Small cells for the CPU tests: a cell of the benchmark with its widths and
depth cut to a few hundred thousand parameters, run on the CPU by the same
drivers, readers and comparison as a run on the card."""

from __future__ import annotations

import copy
import time

import torch

from . import manifest
from .run import Ctx

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=300)


def tiny_ctx(cell: str, seed: int = 2**31 + 77, seconds: float = 0.5,
             param_dtype: str = "float32", **arch) -> Ctx:
    """A context for ``cell`` at a tiny size on the CPU, its weights in
    ``param_dtype`` (float32: the program then agrees with the reference to
    rounding, so only a fault moves the numbers)."""
    found = copy.deepcopy(manifest.cell(manifest.load(), cell))
    conf, mix = found["config"], found["traffic"]
    conf["arch"].update(TINY, **arch)
    conf["param_dtype"] = param_dtype
    if mix["kind"] == "train":
        mix.update(seq_len=32, tokens_per_shard=256)
    else:
        mix.update(prompt_tokens=[8, 24], new_tokens=[1, 4], batch=4, length_grid=8)
    found["cell"]["check"] = {"sample": 32, "rows_per_pass": 8} if "check" in found["cell"] else {}
    return Ctx(name=cell, seed=seed, seconds=seconds, traced=False, chips=1,
               device=torch.device("cpu"), t_start=time.perf_counter(),
               **{k: found[k] for k in ("cell", "config", "traffic")})
