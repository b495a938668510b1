"""RecurrentGemma-2B / Griffin — hybrid: RG-LRU recurrent blocks + local
(2048-window) MQA attention, pattern (rec, rec, attn).  [arXiv:2402.19427]

Assigned spec: 26L d_model=2560 10H (GQA kv=1 — MQA) d_ff=7680 vocab=256000.
26 = 8×(rec,rec,attn) + 2 trailing recurrent blocks.  Sub-quadratic
(O(1) recurrent state + fixed-window attention) → long_500k eligible.
Same values as ``repro.configs.recurrentgemma_2b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    rglru_period=3,
    window=2048,
    lru_width=2560,
    conv_width=4,
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2402.19427",
)

REDUCED = ModelConfig(
    name="recurrentgemma-2b-reduced",
    family="hybrid",
    n_layers=3,                # one (rec, rec, attn) superblock
    d_model=256,
    n_heads=4,
    n_kv_heads=1,
    d_ff=512,
    vocab=1024,
    rglru_period=3,
    window=32,
    lru_width=256,
    conv_width=4,
    tie_embeddings=True,
    sub_quadratic=True,
    source="reduced variant of arXiv:2402.19427",
)
