"""arctic-480b — [hf:Snowflake/snowflake-arctic-base; hf]

Dense-MoE hybrid: 35L d_model=7168 56H (GQA kv=8) vocab=32000,
MoE 128 experts top-2 with d_expert=4864, PLUS a dense residual MLP
(d_ff=4864) in parallel with every MoE layer (the arctic design).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    d_expert=4864,
    dense_residual=True,
    # 960 GB of bf16 params: fp32 Adam is impossible on one pod; bf16 moments
    # + no fp32 master copy (DESIGN.md §Memory-driven config decisions)
    optimizer_moment_dtype="bfloat16",
    use_master_weights=False,
    notes="128e top-2 + dense residual branch; experts sharded 8-per-group"
          " over the 16-way model axis (EP), params FSDP over data",
)
