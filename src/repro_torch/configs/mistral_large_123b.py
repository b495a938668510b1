"""Mistral-Large-Instruct-2407 (123B) — deep dense decoder.
[hf:mistralai/Mistral-Large-Instruct-2407]

Assigned spec: 88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
Largest dense model in the pool: its bf16 weights (~246 GB) do not fit
one 80 GB card, so the card serves it at full width and reduced depth.
Same values as ``repro.configs.mistral_large_123b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    rope_theta=1_000_000.0,
    big_model=True,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

REDUCED = ModelConfig(
    name="mistral-large-123b-reduced",
    family="dense",
    n_layers=2,
    d_model=384,
    n_heads=6,
    n_kv_heads=2,
    d_ff=768,
    vocab=1024,
    rope_theta=1_000_000.0,
    source="reduced variant of hf:mistralai/Mistral-Large-Instruct-2407",
)
