"""ModelConfig — the port's own copy of ``repro.configs.base.ModelConfig``.

Field for field the same dataclass, so a configuration means the same model
in both packages; only the fields the ported families read are documented.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture's shapes and variants (frozen, hashable)."""
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # default: d_model // n_heads

    # attention variants ------------------------------------------------
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0
    window: Optional[int] = None        # sliding-window size (local layers)
    local_global_period: int = 0        # every period-th layer global
    use_rope: bool = True

    # MoE ----------------------------------------------------------------
    n_experts: int = 0
    topk: int = 0
    moe_dense_residual: bool = False
    shared_expert: bool = False
    capacity_factor: float = 1.25

    # SSM / hybrid ---------------------------------------------------------
    rwkv_head_dim: int = 64
    rglru_period: int = 0
    conv_width: int = 4
    lru_width: Optional[int] = None

    # encoder-decoder ------------------------------------------------------
    enc_layers: int = 0
    enc_seq: int = 0
    max_dec_pos: int = 448

    # VLM -------------------------------------------------------------------
    n_img_tokens: int = 0

    # misc --------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    big_model: bool = False
    sub_quadratic: bool = False
    source: str = ""

    @property
    def hd(self) -> int:
        """Head dim: ``head_dim`` or ``d_model // n_heads``."""
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)
