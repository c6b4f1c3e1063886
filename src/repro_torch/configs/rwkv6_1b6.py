"""rwkv6-1.6b (Finch) — [arXiv:2404.05892; unverified]

Attention-free RNN, 24L d_model=2048 d_ff=7168 vocab=65536.
Data-dependent decay (the Finch contribution), token-shift mixing,
head size 64.  Sub-quadratic => runs the long_500k cell.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # wkv heads = d_model / head_size
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    ssm_head_dim=64,
    notes="attention-free; state = [H, K, V] per sequence; decode is O(1)",
)
