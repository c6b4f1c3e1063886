"""The products the reference computes in.

``FP32`` is the reference itself: float32 operands and float32 products
(TF32 is switched off on the card by ``strict_fp32``).  ``FP8`` is the
control: each operand of every product rounded to float8 e4m3 with one
scale a tensor (its largest magnitude to 448) before a float32 product, the
step below the bfloat16 that the configurations state.  The rounding
passes the gradient straight through, so the control trains too.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """No TF32 in float32 products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class Precision:
    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFp8.apply(x) if self.name == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.cast(x) @ self.cast(w)

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.cast(a), self.cast(b))


FP32 = Precision("fp32")
FP8 = Precision("fp8")
