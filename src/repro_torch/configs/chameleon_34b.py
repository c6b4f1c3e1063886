"""chameleon-34b — [arXiv:2405.09818; unverified]

Early-fusion VLM: one decoder over a mixed text+VQ-image token stream.
48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536, qk-norm
(chameleon's stability fix).  The VQ image tokenizer is a STUB:
``input_specs()`` provides precomputed mixed token ids.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    qk_norm=True,
    notes="backbone only; VQ frontend stubbed; qk-norm per the paper",
)
