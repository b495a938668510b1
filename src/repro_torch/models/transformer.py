"""Dense decoder-only transformer family (llama-style), decode path.

Port of ``repro.models.transformer`` for the dense family on either KV
backend (dense slab or paged pool): RMSNorm, interleaved RoPE, GQA,
SwiGLU; weights may be bf16 tensors or PackedWeights.  Parameters are a
dict whose ``"layers"`` entry is a list of per-layer dicts (the JAX
package stacks them along a leading axis for its layer scan; here the
scan is a Python loop).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import kvcache as KV
from repro_torch.core import paged_kvcache as PKV
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels.ref import NO_WINDOW as BIG_WINDOW

from . import common as C

# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Seeded random bf16 parameters (norm gains zero, embed 0.02, other
    weights ``1/sqrt(fan_in)``), drawn on ``device`` from one
    ``torch.Generator``.  The values differ from the JAX package's for the
    same seed (different generators); tests carry JAX's parameters across
    with :func:`repro_torch.convert.params_from_jax` instead."""
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1 "
            "items 7-8)")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    params: Dict[str, Any] = {
        "embed": C.dense_init(gen, (cfg.vocab, d), scale=0.02),
        "final_norm": torch.zeros(d, dtype=torch.bfloat16, device=device),
    }
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "ln1": torch.zeros(d, dtype=torch.bfloat16, device=device),
            "ln2": torch.zeros(d, dtype=torch.bfloat16, device=device),
            "wq": C.dense_init(gen, (d, H * hd)),
            "wk": C.dense_init(gen, (d, Hkv * hd)),
            "wv": C.dense_init(gen, (d, Hkv * hd)),
            "wo": C.dense_init(gen, (H * hd, d)),
            "w1": C.dense_init(gen, (d, f)),
            "w3": C.dense_init(gen, (d, f)),
            "w2": C.dense_init(gen, (f, d)),
        })
    params["layers"] = layers
    if not cfg.tie_embeddings:
        params["lm_head"] = C.dense_init(gen, (d, cfg.vocab), scale=0.02)
    return params


def init_cache(cfg: ModelConfig, policy: PrecisionPolicy, batch: int,
               max_seq: int, device="cuda") -> KV.KVCache:
    """Per-layer dense slabs stacked (L, batch, max_seq, H, Ds)."""
    return KV.init_cache(batch, max_seq, cfg.n_kv_heads, cfg.hd, policy.kv,
                         n_layers=cfg.n_layers, device=device)


def init_paged_cache(cfg: ModelConfig, policy: PrecisionPolicy, n_slots: int,
                     n_blocks: int, block_size: int, blocks_per_slot: int,
                     device="cuda") -> PKV.PagedKVCache:
    """Per-layer block pools stacked (L, n_blocks, block_size, H, Ds) with
    one block table shared by every layer (a logical block occupies the
    same pool index in every layer's pool)."""
    return PKV.init_paged(n_slots, n_blocks, block_size, cfg.n_kv_heads,
                          cfg.hd, policy.kv, blocks_per_slot=blocks_per_slot,
                          n_layers=cfg.n_layers, device=device)


# ---------------------------------------------------------------------------
# Per-layer pieces
# ---------------------------------------------------------------------------


def layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    """Per-layer attention window (BIG_WINDOW = global); with
    ``local_global_period`` every period-th layer is global."""
    if cfg.window is None:
        return BIG_WINDOW
    if cfg.local_global_period and \
            layer_idx % cfg.local_global_period == \
            cfg.local_global_period - 1:
        return BIG_WINDOW
    return cfg.window


def qkv(h, lp, cfg: ModelConfig, policy):
    """q (B, T, H, hd), k and v (B, T, Hkv, hd) projections."""
    B, T, _ = h.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = C.linear(h, lp["wq"], policy).reshape(B, T, H, hd)
    k = C.linear(h, lp["wk"], policy).reshape(B, T, Hkv, hd)
    v = C.linear(h, lp["wv"], policy).reshape(B, T, Hkv, hd)
    return q, k, v


def ffn(h, lp, cfg: ModelConfig, policy):
    """The layer's feed-forward block (SwiGLU for the dense family)."""
    return C.swiglu(h, lp, policy)


def lm_logits(params, h: torch.Tensor) -> torch.Tensor:
    """Logits over the vocabulary (tied embedding unless ``lm_head``)."""
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return torch.matmul(h, w.to(h.dtype))


# ---------------------------------------------------------------------------
# Decode: T new tokens per slot against the KV cache
# ---------------------------------------------------------------------------


def decode_step(params, cfg: ModelConfig, policy: PrecisionPolicy,
                tokens: torch.Tensor, cache, pos: torch.Tensor,
                max_live: Optional[int] = None,
                valid: Optional[torch.Tensor] = None,
                attn_block_s: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Any]:
    """tokens: (B, T); pos: (B,) position of each slot's first new token.

    T > 1 is the engine's chunked prefill / mixed prefill+decode step: the
    T queries attend causally to ``pos + t`` cached tokens each.
    ``cache`` is the dense :class:`KV.KVCache` slab or a
    :class:`PKV.PagedKVCache` pool; the new K/V are quantized and written
    into it in place (through the block table for paged) before each
    layer's attention.  ``valid`` ((B,), optional) marks slot b's first
    ``valid[b]`` rows as real: the rest are padding, their KV writes
    dropped, and the logits come from each slot's last valid row.
    ``max_live`` (tokens) bounds the paged kernel's walk at the batch's
    live-context high-water mark; ``attn_block_s`` is the dense kernel's
    tile height.  Returns ((B, V) logits, the cache)."""
    if not cfg.use_rope:
        raise NotImplementedError(
            "sinusoidal positions are not ported yet (ROADMAP queue 1 "
            "item 8)")
    dev = tokens.device
    x = params["embed"][tokens.long()].to(policy.compute_dtype)
    B, T, _ = x.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    if pos.dim() == 0:
        pos = pos.expand(B).contiguous()
    rope_pos = pos.long()[:, None] + torch.arange(T, device=dev)[None]
    # the same for every layer: RoPE tables and the pool rows written
    rotation = C.rope_rotation(rope_pos, cfg.hd, rotary_pct=cfg.rotary_pct,
                               theta=cfg.rope_theta)
    paged = isinstance(cache, PKV.PagedKVCache)
    rows = (PKV if paged else KV).write_rows(cache, pos, T, valid)
    for i, lp in enumerate(params["layers"]):
        cache_l = cache.layer(i)
        h = C.rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = qkv(h, lp, cfg, policy)
        q = C.apply_rope(q, rotation)
        k = C.apply_rope(k, rotation)
        if paged:
            PKV.append_paged(cache_l, k, v, pos, policy.kv, rows=rows)
        else:
            KV.append_per_slot(cache_l, k, v, pos, policy.kv, rows=rows)
        attn = C.attend_decode(q, cache_l, policy.kv, pos,
                               window=layer_window(cfg, i),
                               block_s=attn_block_s, max_live=max_live)
        x = x + C.linear(attn.reshape(B, T, -1), lp["wo"], policy)
        h2 = C.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + ffn(h2, lp, cfg, policy)
    if valid is None:
        h_sel = x[:, -1]
    else:
        # each slot reads its last *valid* row (idle slots clamp to row 0;
        # the engine discards their logits)
        idx = (valid.long() - 1).clamp(0, T - 1)
        h_sel = x[torch.arange(B, device=dev), idx]
    h_last = C.rms_norm(h_sel, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h_last), cache
