"""phi3-medium-14b — [arXiv:2404.14219; unverified]

Dense decoder, 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
RoPE, SwiGLU, GQA.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab=100352,
    rope_theta=10_000.0,
    notes="kv=10 heads: KV replicated across the 16-way model axis (10 % 16 != 0)",
)
