"""zamba2-7b-instruct — Zyphra/Zamba2-7B-Instruct at its published widths
(huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json; arXiv:2411.15242).

81 Mamba2 layers (d 3584, expand 2: 112 heads of 64, state 64, B and C in 2
groups, a causal conv of width 4 with bias over x | B | C) and TWO shared
transformer blocks used at the 13 ``hybrid_layer_ids``, site j by block j % 2.
A site runs its block on [h | embeddings] (width 7168: 32 heads of 224, RoPE on
all 224 dims, softmax scale (224/2)^-1/2), the block's GeGLU MLP with the
site's own rank-128 adapter on its gate/up projection, then the site's own
linear; the result joins the site's Mamba2 input, not the residual.  RMS norms
take eps 1e-5; the head is tied to the embedding.

A port-only entry: the JAX package has no such config, so it stays out of
``ARCH_NAMES`` (the list the two packages share) and is served through the
port's normal path (``get_model`` -> ``BatchServer``).  Training it and placing
it on a mesh are not supported and raise.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=224,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    shared_blocks=2,
    ssm_groups=2,
    adapter_rank=128,
    mlp_act="gelu",
    attn_concat_embed=True,
    attn_scale=(224 / 2) ** -0.5,
    rms_eps=1e-5,
    tie_embeddings=True,
    notes="the published Zamba2-7B block: two shared blocks over [h | embeddings],"
          " per-site adapters and linears, grouped B/C, gated group norm",
)
