"""Public entry points for the port's kernels.

Dispatch by where the tensors lie: a CUDA tensor launches the hand-written
kernel (which raises on what it does not take), a CPU tensor takes the
plain PyTorch version in ``ref``.  There is no fallback from the one to
the other.
"""

from __future__ import annotations

import torch

from . import ref
from .flash_attention import flash_attention_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention.
    q [B,Tq,KV,G,hd]; k/v [B,Tk,KV,hd] -> [B,Tq,KV,G,hd]."""
    if q.is_cuda:
        return flash_attention_fwd(q, k, v, window=window, q_offset=q_offset)[0]
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, q_offset=q_offset, window=window)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")
