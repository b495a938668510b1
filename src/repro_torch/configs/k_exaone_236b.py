"""K-EXAONE 236B-A23B — a 128-expert top-8 MoE behind one dense layer, with
windowed and global attention in the pattern ``LLLG``.
[hf:LGAI-EXAONE/K-EXAONE-236B-A23B]

Published spec (its ``config.json``, ``model_type`` ``exaone_moe``): 48L
d_model=6144 64H (GQA kv=8, head 128) vocab=153600 untied; layer 0 a dense
SwiGLU of 18432, layers 1–47 128 experts of 2048, top-8 by sigmoid scores
with a bias used only to select, the gates normalised and scaled by 2.5,
one shared expert of 2048; sliding window 128 on three of every four
layers, RoPE (θ 1e6) on those only; QK RMSNorm and the sub-layers'
outputs normalised before the residual add (EXAONE 4.0).  Routing is
dropless, as published: ``capacity_factor`` E/k = 16 makes every
per-row buffer wider than the row.  The multi-token-prediction layer is
not held.  The JAX package has no such model: it is not in ``ARCHS``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="k-exaone-236b-a23b",
    family="moe",
    n_layers=48,
    d_model=6144,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab=153600,
    rope_theta=1_000_000.0,
    window=128,
    local_global_period=4,
    qk_norm=True,
    post_norms=True,
    rope_local_only=True,
    n_experts=128,
    topk=8,
    shared_expert=True,
    capacity_factor=16.0,
    first_dense_layers=1,
    dense_d_ff=18432,
    router_scoring="sigmoid",
    routed_scaling=2.5,
    norm_eps=1e-5,
    big_model=True,
    source="hf:LGAI-EXAONE/K-EXAONE-236B-A23B",
)

REDUCED = ModelConfig(
    name="k-exaone-reduced",
    family="moe",
    n_layers=5,
    d_model=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=64,
    d_ff=256,
    vocab=1024,
    rope_theta=1_000_000.0,
    window=8,
    local_global_period=4,
    qk_norm=True,
    post_norms=True,
    rope_local_only=True,
    n_experts=16,
    topk=4,
    shared_expert=True,
    capacity_factor=4.0,
    first_dense_layers=1,
    dense_d_ff=512,
    router_scoring="sigmoid",
    routed_scaling=2.5,
    source="reduced variant of hf:LGAI-EXAONE/K-EXAONE-236B-A23B",
)
