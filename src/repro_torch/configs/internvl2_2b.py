"""InternVL2-2B — VLM: InternViT vision encoder + InternLM2-1.8B language
decoder.  [arXiv:2404.16821]

Assigned spec (language decoder): 24L d_model=2048 16H (GQA kv=8)
d_ff=8192 vocab=92553.  The vision tower is a stub, as in the JAX
package: the engine feeds 256 precomputed patch embeddings (ViT width
1024), which the in-model ``img_proj`` maps to d_model and prepends to the
text prompt at the one-shot prefill.  Same values as
``repro.configs.internvl2_2b``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    n_img_tokens=256,
    source="arXiv:2404.16821",
)

REDUCED = ModelConfig(
    name="internvl2-2b-reduced",
    family="vlm",
    n_layers=2,
    d_model=256,
    n_heads=8,
    n_kv_heads=4,
    d_ff=512,
    vocab=1024,
    n_img_tokens=16,
    source="reduced variant of arXiv:2404.16821",
)
