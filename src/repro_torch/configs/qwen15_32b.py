"""qwen1.5-32b — [hf:Qwen/Qwen1.5-0.5B (family); hf]

Dense decoder, 64L d_model=5120 40H (GQA kv=40 == MHA) d_ff=27392
vocab=152064.  QKV bias.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    # bf16 KV cache at decode_32k = 5.5 TB > one pod's 4 TB HBM -> int8 KV
    # for that cell (DESIGN.md §Memory-driven config decisions)
    kv_cache_dtype_decode_32k="int8",
    notes="MHA (kv=40); fp32 Adam moments would be 384 GB -> ZeRO-1 shards"
          " them over the data axis",
)
