"""zamba2-7b — [arXiv:2411.15242; unverified]

Hybrid: 81 Mamba2 layers (d_model=3584, ssm_state=64) + ONE shared
attention+MLP block (32H kv=32, d_ff=14336) invoked periodically —
the zamba2 design: shared weights reused at every call site.
Sub-quadratic => runs the long_500k cell.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,          # shared block applied after every 6 mamba layers
    notes="mamba2 backbone; the shared attn block's KV cache exists only at"
          " its ~13 call sites",
)
