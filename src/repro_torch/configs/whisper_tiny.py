"""Whisper-tiny — encoder-decoder speech model.  [arXiv:2212.04356]

Assigned spec: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865; conv
frontend is a STUB (input_specs feeds precomputed (B, 1500, 384) frame
embeddings).  Decoder positions are learned (448-entry table, clamped for
shape-level decode_32k exercise).
Same values as ``repro.configs.whisper_tiny``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,            # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    enc_layers=4,
    enc_seq=1500,
    use_rope=False,
    max_dec_pos=448,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)

REDUCED = ModelConfig(
    name="whisper-tiny-reduced",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=1024,
    enc_layers=2,
    enc_seq=64,
    use_rope=False,
    max_dec_pos=448,
    tie_embeddings=True,
    source="reduced variant of arXiv:2212.04356",
)
