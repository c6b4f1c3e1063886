"""minicpm-2b — [arXiv:2404.06395; hf]

Dense llama-like decoder, 40L d_model=2304 36H (kv=36) d_ff=5760
vocab=122753.  Distinctives: WSD (warmup-stable-decay) LR schedule and
µP-style depth-scaled residuals (scale_depth/sqrt(L)) from the paper.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    head_dim=64,
    tie_embeddings=True,
    lr_schedule="wsd",
    depth_scaled_residual=True,
    notes="WSD schedule implemented in train/optimizer.py; vocab 122753 is odd"
          " -> padded to 122768 (divisible by 16) for TP, documented",
)
