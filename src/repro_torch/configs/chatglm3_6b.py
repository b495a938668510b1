"""ChatGLM3-6B — dense decoder with 2D/partial RoPE (rotation on half the
head dim) and aggressive GQA (kv=2).  [arXiv:2406.12793]

Assigned spec: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
Same values as ``repro.configs.chatglm3_6b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    rotary_pct=0.5,          # "RoPE 2d": rotate the leading half of head_dim
    source="arXiv:2406.12793",
)

REDUCED = ModelConfig(
    name="chatglm3-6b-reduced",
    family="dense",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=2,
    d_ff=512,
    vocab=1024,
    rotary_pct=0.5,
    source="reduced variant of arXiv:2406.12793",
)
