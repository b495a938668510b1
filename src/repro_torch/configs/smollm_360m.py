"""SmolLM-360M — small llama-architecture dense model.
[hf:HuggingFaceTB/SmolLM-135M (family card)]

Assigned spec: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
Same values as ``repro.configs.smollm_360m``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

REDUCED = ModelConfig(
    name="smollm-360m-reduced",
    family="dense",
    n_layers=2,
    d_model=320,
    n_heads=5,
    n_kv_heads=5,
    d_ff=640,
    vocab=1024,
    tie_embeddings=True,
    source="reduced variant of hf:HuggingFaceTB/SmolLM-135M",
)
