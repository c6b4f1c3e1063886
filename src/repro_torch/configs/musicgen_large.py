"""musicgen-large — [arXiv:2306.05284; hf]

Decoder-only transformer over EnCodec tokens: 48L d_model=2048 32H (kv=32)
d_ff=8192 vocab=2048.  The EnCodec/text-conditioning frontend is a STUB per
the assignment: ``input_specs()`` provides precomputed token ids (the
4-codebook delay pattern collapsed to a single stream for the backbone).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    notes="backbone only; modality frontend stubbed (precomputed frame tokens)",
)
