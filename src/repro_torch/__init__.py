"""PyTorch/CUDA port of the ``repro`` model harness, for one NVIDIA Hopper card.

Mirrors ``repro``'s layout (``configs``, ``kernels``, ``models``, ``serve``,
``launch``) and imports nothing from it.  Entry points take an explicit
``device`` (default ``"cuda"``); asking for a card that is not there raises
instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
