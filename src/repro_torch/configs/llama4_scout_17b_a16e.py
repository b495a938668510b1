"""Llama-4 Scout 17B-active / 16-expert MoE with shared expert.
[hf:meta-llama/Llama-4-Scout-17B-16E]

Assigned spec: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 16e top-1 + shared expert; the text decoder only (modality fusion is
outside the assigned scope, as in the JAX package).  One layer's expert
weights are ~4 GB of bf16, so the card serves it at full width and
reduced depth.  Same values as ``repro.configs.llama4_scout_17b_a16e``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    topk=1,
    shared_expert=True,
    rope_theta=500_000.0,
    big_model=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

REDUCED = ModelConfig(
    name="llama4-scout-reduced",
    family="moe",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab=1024,
    n_experts=4,
    topk=1,
    shared_expert=True,
    rope_theta=500_000.0,
    source="reduced variant of hf:meta-llama/Llama-4-Scout-17B-16E",
)
