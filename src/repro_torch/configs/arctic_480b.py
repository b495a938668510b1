"""Snowflake Arctic 480B — 128-expert top-2 MoE with a parallel dense-FFN
residual branch.  [hf:Snowflake/snowflake-arctic-base]

Assigned spec: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual.  One layer's expert weights are ~26.8 GB
of bf16, so the card serves it at full width and reduced depth.
Same values as ``repro.configs.arctic_480b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    topk=2,
    moe_dense_residual=True,
    big_model=True,
    source="hf:Snowflake/snowflake-arctic-base",
)

REDUCED = ModelConfig(
    name="arctic-480b-reduced",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab=1024,
    n_experts=4,
    topk=2,
    moe_dense_residual=True,
    source="reduced variant of hf:Snowflake/snowflake-arctic-base",
)
