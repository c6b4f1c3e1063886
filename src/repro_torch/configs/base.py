"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; every workload shape
is a ``ShapeConfig``.  The dry-run grid is the cross product (minus the
documented skips, see ``runnable_cells``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "runnable_cells"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # attention details
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False                  # qwen1.5 family
    qk_norm: bool = False                   # chameleon
    rope_theta: float = 10_000.0
    swa_window: int = 0                     # 0 => full attention

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                       # expert FFN hidden (arctic: 4864)
    dense_residual: bool = False            # arctic: dense MLP in parallel
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0                      # mamba2 state size N
    ssm_head_dim: int = 64                  # rwkv/mamba head size
    attn_every: int = 0                     # zamba2: shared attn block period
    ssm_expand: int = 2                     # mamba2 expansion factor

    # the published Zamba2 hybrid (port-only; every default leaves the others as they are)
    hybrid_layer_ids: Tuple[int, ...] = ()  # layers that run a shared block first
    shared_blocks: int = 1                  # shared blocks, site j using block j % n
    ssm_groups: int = 1                     # groups of mamba2's B and C
    adapter_rank: int = 0                   # each site's LoRA on the shared MLP's input
    mlp_act: str = "silu"                   # gate activation: "silu" (SwiGLU), "gelu" (GeGLU)
    attn_concat_embed: bool = False         # attention input [h | embeddings], width 2d
    attn_scale: Optional[float] = None      # softmax scale (None: 1/sqrt(head dim))
    rms_eps: float = 1e-6

    # training / numerics
    tie_embeddings: bool = False
    optimizer_moment_dtype: str = "float32"  # "bfloat16" for the huge MoEs
    use_master_weights: bool = True
    lr_schedule: str = "cosine"             # "wsd" for minicpm
    depth_scaled_residual: bool = False     # minicpm (µP-ish)

    # serving
    kv_cache_dtype: str = "bfloat16"        # "int8" where HBM requires it
    kv_cache_dtype_decode_32k: Optional[str] = None  # per-cell override

    notes: str = ""

    def __post_init__(self):
        object.__setattr__(self, "hybrid_layer_ids", tuple(self.hybrid_layer_ids))

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    # ---- parameter counting (for MODEL_FLOPS and memory budgeting) --------
    def param_count(self) -> int:
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":            # rwkv6
            # tmix: r,k,v,g,o (d*d each) + decay/lora small; cmix: 2 mats
            per_layer = 5 * d * d + 2 * d * int(3.5 * d)
            return emb + L * per_layer
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        mlp_dense = 3 * d * f               # SwiGLU: w1, w3, w2
        if self.family == "moe":
            fe = self.d_expert or f
            moe = self.n_experts * 3 * d * fe + d * self.n_experts
            per_layer = attn + moe + (mlp_dense if self.dense_residual else 0)
        elif self.family == "hybrid" and self.hybrid_layer_ids:
            din, gn, r = self.ssm_expand * d, self.ssm_groups * self.ssm_state, self.adapter_rank
            nh = din // self.ssm_head_dim
            mamba = (d * (2 * din + 2 * gn + nh) + 4 * (din + 2 * gn) + (din + 2 * gn)
                     + 3 * nh + din + din * d + d)
            shared = (2 * d + 2 * d * 3 * H * hd + H * hd * d + d
                      + d * 2 * f + f * d)
            site = d * d + d * r + r * 2 * f
            return (emb + L * mamba + self.shared_blocks * shared
                    + len(self.hybrid_layer_ids) * site + d)
        elif self.family == "hybrid":
            din = self.ssm_expand * d
            mamba = (d * 2 * din              # in_proj (x, z)
                     + din * (2 * self.ssm_state)   # B, C projections
                     + din + din * d)               # dt + out_proj
            n_attn = (L // self.attn_every) if self.attn_every else 0
            # the shared block is ONE set of weights reused at every call site
            shared = attn + mlp_dense
            return emb + L * mamba + shared
        else:
            per_layer = attn + mlp_dense
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Per-token active parameters (= dense count unless MoE)."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        fe = self.d_expert or f
        active_moe = self.top_k * 3 * d * fe + d * self.n_experts
        dense = 3 * d * f if self.dense_residual else 0
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + active_moe + dense)

    # ---- reduced config for CPU smoke tests --------------------------------
    def reduced(self) -> "ArchConfig":
        small = replace(
            self,
            n_layers=min(self.n_layers, 2 if not self.attn_every else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            d_expert=64 if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            attn_every=2 if self.attn_every else 0,
            swa_window=min(self.swa_window, 64) if self.swa_window else 0,
        )
        if not self.hybrid_layer_ids:
            return small
        # 4 layers (more with more blocks), a site at every other one: each block
        # runs at least once
        n = min(self.n_layers, max(4, 2 * self.shared_blocks))
        return replace(small, n_layers=n, hybrid_layer_ids=tuple(range(1, n, 2)),
                       adapter_rank=min(self.adapter_rank, 8))


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs whose attention is sub-quadratic / state-based and can run long_500k
_LONG_OK = {"rwkv6-1.6b", "zamba2-7b", "mixtral-8x22b"}


def runnable_cells(arch_names: List[str]) -> List[Tuple[str, str]]:
    """The dry-run grid: every (arch, shape) minus the documented skips.

    ``long_500k`` needs sub-quadratic attention — skipped for pure
    full-attention archs (see DESIGN.md §Shape-cell skips)."""
    cells = []
    for a in arch_names:
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            cells.append((a, s))
        if a in _LONG_OK:
            cells.append((a, "long_500k"))
    return cells
