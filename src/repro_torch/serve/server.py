"""Batched serving through fixed batch slots: prefill, then cached decode.

The same semantics as ``repro.serve.server``: requests are served in waves
of ``batch`` slots, a short wave is filled with dummy requests, prompts are
left-padded with token 0 (and, as in the reference, no pad mask is applied,
so pad tokens are attended to), decoding is greedy over the real vocab, and
the cache length starts at the wave's longest prompt.  The cache is what
the model's ``prefill`` returns (a KV cache, or rwkv6's and zamba2's
recurrent state) and is handed back to ``decode`` unread.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..models import get_model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: Optional[List[int]] = None


class BatchServer:
    """``temperature`` is accepted and never read, as in the reference:
    decoding is greedy."""

    def __init__(self, cfg: ArchConfig, params, batch: int = 4,
                 smax: int = 128, temperature: float = 0.0, device="cuda"):
        self.cfg = cfg
        self.api = get_model(cfg)
        self.params = params
        self.batch = batch
        self.smax = smax
        self.device = resolve_device(device)

    @torch.inference_mode()
    def serve(self, requests: List[Request]) -> List[Request]:
        """Serve a queue of requests through fixed batch slots."""
        queue = list(requests)
        done: List[Request] = []
        vocab = self.cfg.vocab
        while queue:
            wave = queue[: self.batch]
            queue = queue[self.batch:]
            # pad the wave to full batch with a dummy
            while len(wave) < self.batch:
                wave.append(Request(rid=-1, prompt=[0], max_new=0))
            max_p = max(len(r.prompt) for r in wave)
            toks = torch.zeros((self.batch, max_p), dtype=torch.long)
            for i, r in enumerate(wave):
                toks[i, max_p - len(r.prompt):] = torch.tensor(r.prompt)  # left-pad
            logits, cache = self.api.prefill(self.params, toks.to(self.device),
                                             self.smax)
            cur = logits[:, -1, :vocab].argmax(-1)
            outs = [[t] for t in cur.tolist()]
            cache_len = max_p
            steps = max((r.max_new for r in wave), default=0)
            for _ in range(max(steps - 1, 0)):
                logits, cache = self.api.decode(self.params, cur[:, None], cache,
                                                cache_len)
                cache_len += 1
                cur = logits[:, -1, :vocab].argmax(-1)
                for out, t in zip(outs, cur.tolist()):
                    out.append(t)
            del cache   # free this wave's cache before the next wave allocates one
            for i, r in enumerate(wave):
                if r.rid >= 0:
                    r.out = outs[i][: r.max_new]
                    done.append(r)
        return done
