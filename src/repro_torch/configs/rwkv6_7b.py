"""RWKV-6 "Finch" 7B — attention-free linear recurrence with data-dependent
decay.  [arXiv:2404.05892]

Assigned spec: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536.
Sub-quadratic (O(1) decode state).  Same values as
``repro.configs.rwkv6_7b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14336,
    vocab=65536,
    rwkv_head_dim=64,
    sub_quadratic=True,
    source="arXiv:2404.05892",
)

REDUCED = ModelConfig(
    name="rwkv6-7b-reduced",
    family="ssm",
    n_layers=2,
    d_model=256,
    n_heads=0,
    n_kv_heads=0,
    d_ff=512,
    vocab=1024,
    rwkv_head_dim=64,
    sub_quadratic=True,
    source="reduced variant of arXiv:2404.05892",
)
