"""Gemma-3 1B — dense decoder with 5:1 local:global attention (every 6th
layer global), 128k-class context via sliding windows.
[hf:google/gemma-3-1b-pt]

Assigned spec: 26L d_model=1152 4H (GQA kv=1 — MQA) d_ff=6912 vocab=262144.
head_dim = d_model/4 = 288, kept exact (the decode-attention kernels are
built for it).  Sub-quadratic for long_500k via the dominant
sliding-window layers (global layers attend the full cache — O(S) per
decoded token).  Same values as ``repro.configs.gemma3_1b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    window=1024,
    local_global_period=6,     # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt",
)

REDUCED = ModelConfig(
    name="gemma3-1b-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=4,
    n_kv_heads=1,
    d_ff=512,
    vocab=1024,
    window=32,
    local_global_period=2,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    sub_quadratic=True,
    source="reduced variant of hf:google/gemma-3-1b-pt",
)
