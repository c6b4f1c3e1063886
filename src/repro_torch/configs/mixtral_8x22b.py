"""mixtral-8x22b — [arXiv:2401.04088; hf]

MoE decoder: 56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
8 experts top-2.  The assignment spec lists SWA — window 4096 — which
also makes the long_500k decode cell runnable (KV bounded by the window).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    top_k=2,
    d_expert=16384,
    swa_window=4096,
    optimizer_moment_dtype="bfloat16",
    notes="281 GB bf16 params -> FSDP over data; experts sharded 8-way over"
          " the model axis (EP) then TP 2-way within expert",
)
