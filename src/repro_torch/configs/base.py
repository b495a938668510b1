"""ModelConfig — the port's own copy of ``repro.configs.base.ModelConfig``.

Field for field the same dataclass, so a configuration means the same model
in both packages, plus the port's own variants (``PORT_FIELDS``: the
layer kinds of K-EXAONE), whose defaults leave every configuration of the
JAX package the model it is there; only the fields the ported families
read are documented.
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
    qk_norm: bool = False               # RMSNorm of q and k over head dim
    post_norms: bool = False            # norm each sub-layer's output, none
    #                                     before it (EXAONE 4.0)
    rope_local_only: bool = False       # RoPE on windowed layers only

    # MoE ----------------------------------------------------------------
    n_experts: int = 0
    topk: int = 0
    moe_dense_residual: bool = False
    shared_expert: bool = False
    capacity_factor: float = 1.25
    first_dense_layers: int = 0         # leading layers with a SwiGLU
    dense_d_ff: Optional[int] = None    # their width (default d_ff)
    router_scoring: str = "softmax"     # | "sigmoid": + a selection bias
    routed_scaling: float = 1.0         # scale of the normalised gates

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
    def dense_ff(self) -> int:
        """Width of the leading dense layers: ``dense_d_ff`` or ``d_ff``."""
        return self.dense_d_ff or self.d_ff

    @property
    def hd(self) -> int:
        """Head dim: ``head_dim`` or ``d_model // n_heads``."""
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attn_free(self) -> bool:
        """True for the attention-free (ssm) family."""
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count, the reference's formula term for
        term (``repro.configs.base``; it feeds ``roofline.model_flops``)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd, H, Hkv = self.hd, self.n_heads, self.n_kv_heads
        if self.family == "ssm":
            # rwkv: time-mix (r, k, v, g, o ~ 5 d^2) + channel-mix (k: d -> f,
            # v: f -> d, r: d -> d)
            per = 5 * d * d + 2 * d * f + d * d
        else:
            attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
            mlp = 3 * d * f
            if self.n_experts:
                moe = self.n_experts * 3 * d * f + d * self.n_experts
                if self.moe_dense_residual or self.shared_expert:
                    moe += 3 * d * f
                mlp = moe
            per = attn + mlp
            if self.rglru_period:
                w = self.lru_width or d
                rec = d * w * 2 + w * d + w * self.conv_width + 2 * w * w
                att_layers = L // self.rglru_period
                return int(att_layers * (attn + 3 * d * f)
                           + (L - att_layers) * (rec + 3 * d * f) + 2 * V * d)
        total = L * per + V * d * (1 if self.tie_embeddings else 2)
        if self.n_experts and self.first_dense_layers:
            total += self.first_dense_layers * (3 * d * self.dense_ff - mlp)
        if self.enc_layers:
            total += self.enc_layers * (4 * d * d + 2 * d * f)  # encoder
            total += L * (d * d + 2 * d * Hkv * hd)             # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token runs through (moe: the routed experts only),
        for MODEL_FLOPS = 6 N_active D; the reference's formula."""
        if not self.n_experts:
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd, H, Hkv, V = self.hd, self.n_heads, self.n_kv_heads, self.vocab
        attn = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        act_mlp = self.topk * 3 * d * f + d * self.n_experts
        if self.moe_dense_residual or self.shared_expert:
            act_mlp += 3 * d * f
        dense = self.first_dense_layers * (3 * d * self.dense_ff - act_mlp)
        return int(L * (attn + act_mlp) + dense + 2 * V * d)


#: the port's fields that the JAX package's ModelConfig does not have
PORT_FIELDS = ("qk_norm", "post_norms", "rope_local_only",
               "first_dense_layers", "dense_d_ff", "router_scoring",
               "routed_scaling")


def jax_fields(cfg: ModelConfig) -> dict:
    """``dataclasses.asdict(cfg)`` without the port's own fields, which must
    hold their defaults (a configuration the JAX package also has);
    raises ``ValueError`` where one does not."""
    out = dataclasses.asdict(cfg)
    defaults = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    for name in PORT_FIELDS:
        if out.pop(name) != defaults[name]:
            raise ValueError(f"{cfg.name}: {name} is the port's own field, "
                             f"set to {getattr(cfg, name)!r}")
    return out
