"""codeqwen1.5-7b — [hf:Qwen/CodeQwen1.5-7B; hf]

Dense decoder, 32L d_model=4096 32H (GQA kv=32 == MHA) d_ff=13440
vocab=92416.  Qwen1.5 family: QKV bias, RoPE, SwiGLU, RMSNorm.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    notes="qwen1.5 arch; kv=32 of 32 heads => effectively MHA",
)
