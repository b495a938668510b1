"""Decoder-only transformer (llama-style): the dense, moe and vlm families.

Port of ``repro.models.transformer`` on either KV backend (dense slab or
paged pool): RMSNorm, interleaved RoPE (or, with ``use_rope=False``,
sinusoidal positions added to the embeddings), GQA, a SwiGLU or MoE
feed-forward (:mod:`repro_torch.models.moe`, with arctic's dense residual
or llama4's shared expert beside it); weights may be bf16 tensors or
PackedWeights (expert stacks packed member by member).  The port's own
layer variants (K-EXAONE's; none in the JAX package): QK RMSNorm
(``qk_norm``), each sub-layer's output normalised before the residual add
and no norm before it (``post_norms``), RoPE on the windowed layers only
(``rope_local_only``), and leading dense layers of their own width in a
moe model (``first_dense_layers``, ``dense_d_ff``).  The three forwards
run one layer body, :func:`layer`.
:func:`decode_step` is the engine's chunked prefill and decode step;
:func:`prefill` the one-shot prefill of the vlm family, which prepends
the projected image embeddings to the prompt; :func:`hidden_states` the
full-sequence training forward.  Parameters are a dict whose
``"layers"`` entry is a list of per-layer dicts (the JAX package stacks
them along a leading axis for its layer scan; here the scan is a Python
loop).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import kvcache as KV
from repro_torch.core import paged_kvcache as PKV
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.kernels.ref import NO_WINDOW as BIG_WINDOW

from . import common as C
from . import moe as MOE

#: the vlm family's stub vision-tower width (``img_proj`` maps it to
#: d_model)
VIT_WIDTH = 1024

# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _stack_init(gen: torch.Generator, E: int, shape) -> torch.Tensor:
    """(E, K, N) bf16 stack of :func:`common.dense_init` members, drawn one
    member at a time (one member's f32 at a time)."""
    out = torch.empty((E,) + tuple(shape), dtype=torch.bfloat16,
                      device=gen.device)
    for e in range(E):
        out[e] = C.dense_init(gen, shape)
    return out


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Seeded random bf16 parameters of the JAX package's leaves (norm
    gains zero, embed and router 0.02, other weights ``1/sqrt(fan_in)``),
    drawn on ``device`` from one ``torch.Generator``: the dense family's
    SwiGLU, the moe family's ``router`` and expert stacks ``we1/we3/we2``
    (E, K, N) (with ``ws1/ws3/ws2`` for a dense residual or shared
    expert), the vlm family's ``img_proj`` (VIT_WIDTH, d_model).  The
    port's variants draw their own leaves (:func:`_variant_leaves`): a
    sigmoid router's ``router_bias`` (E,) at 0.02, the QK norms' gains
    ``q_norm`` / ``k_norm`` (hd,), ``post_attn_norm`` / ``post_ffn_norm``
    in place of ``ln1`` / ``ln2``, and a leading dense layer's SwiGLU at
    ``dense_ff``.  The
    values differ from the JAX package's for the same seed (different
    generators); tests carry JAX's parameters across with
    :func:`repro_torch.convert.params_from_jax` instead."""
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"family {cfg.family!r} is not a transformer")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, f = cfg.d_model, cfg.d_ff
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    params: Dict[str, Any] = {
        "embed": C.dense_init(gen, (cfg.vocab, d), scale=0.02),
        "final_norm": torch.zeros(d, dtype=torch.bfloat16, device=device),
    }
    layers = []
    for i in range(cfg.n_layers):
        lp = {
            "ln1": torch.zeros(d, dtype=torch.bfloat16, device=device),
            "ln2": torch.zeros(d, dtype=torch.bfloat16, device=device),
            "wq": C.dense_init(gen, (d, H * hd)),
            "wk": C.dense_init(gen, (d, Hkv * hd)),
            "wv": C.dense_init(gen, (d, Hkv * hd)),
            "wo": C.dense_init(gen, (H * hd, d)),
        }
        if routes(cfg, i):
            E = cfg.n_experts
            lp["router"] = C.dense_init(gen, (d, E), scale=0.02)
            lp["we1"] = _stack_init(gen, E, (d, f))
            lp["we3"] = _stack_init(gen, E, (d, f))
            lp["we2"] = _stack_init(gen, E, (f, d))
            if cfg.moe_dense_residual or cfg.shared_expert:
                lp["ws1"] = C.dense_init(gen, (d, f))
                lp["ws3"] = C.dense_init(gen, (d, f))
                lp["ws2"] = C.dense_init(gen, (f, d))
        else:
            fd = cfg.dense_ff
            lp["w1"] = C.dense_init(gen, (d, fd))
            lp["w3"] = C.dense_init(gen, (d, fd))
            lp["w2"] = C.dense_init(gen, (fd, d))
        _variant_leaves(gen, cfg, i, lp)
        layers.append(lp)
    params["layers"] = layers
    if not cfg.tie_embeddings:
        params["lm_head"] = C.dense_init(gen, (d, cfg.vocab), scale=0.02)
    if cfg.n_img_tokens:
        params["img_proj"] = C.dense_init(gen, (VIT_WIDTH, d))
    return params


def _variant_leaves(gen: torch.Generator, cfg: ModelConfig, i: int,
                    lp: Dict[str, Any]) -> None:
    """Layer ``i``'s leaves of the port's variants, in place (none for a
    configuration that sets none of them)."""
    d, dev = cfg.d_model, gen.device
    if cfg.post_norms:
        del lp["ln1"], lp["ln2"]
        lp["post_attn_norm"] = torch.zeros(d, dtype=torch.bfloat16,
                                           device=dev)
        lp["post_ffn_norm"] = torch.zeros(d, dtype=torch.bfloat16,
                                          device=dev)
    if cfg.qk_norm:
        lp["q_norm"] = torch.zeros(cfg.hd, dtype=torch.bfloat16, device=dev)
        lp["k_norm"] = torch.zeros(cfg.hd, dtype=torch.bfloat16, device=dev)
    if cfg.router_scoring == "sigmoid" and routes(cfg, i):
        lp["router_bias"] = C.dense_init(gen, (cfg.n_experts,), scale=0.02)


def init_cache(cfg: ModelConfig, policy: PrecisionPolicy, batch: int,
               max_seq: int, device="cuda") -> KV.KVCache:
    """Per-layer dense slabs stacked (L, batch, max_seq, H, Ds)."""
    return KV.init_cache(batch, max_seq, cfg.n_kv_heads, cfg.hd, policy.kv,
                         n_layers=cfg.n_layers, device=device)


def cache_spec(cfg: ModelConfig, policy: PrecisionPolicy, batch: int,
               max_seq: int) -> KV.KVCache:
    """:func:`init_cache` with no storage (meta tensors): the dry-run's
    stand-in."""
    return init_cache(cfg, policy, batch, max_seq, device="meta")


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


def routes(cfg: ModelConfig, layer_idx: int) -> bool:
    """Whether layer ``layer_idx`` routes (a moe layer past the leading
    ``first_dense_layers``)."""
    return bool(cfg.n_experts) and layer_idx >= cfg.first_dense_layers


def layer_rope(cfg: ModelConfig, layer_idx: int) -> bool:
    """Whether layer ``layer_idx`` rotates q and k: every layer, or with
    ``rope_local_only`` the windowed ones (a global layer has no
    positional encoding)."""
    return not cfg.rope_local_only or \
        layer_window(cfg, layer_idx) != BIG_WINDOW


def qkv(h, lp, cfg: ModelConfig, policy):
    """q (B, T, H, hd), k and v (B, T, Hkv, hd) projections; with
    ``qk_norm`` q and k are RMS-normalised over the head dimension
    (gains ``q_norm`` / ``k_norm``)."""
    B, T, _ = h.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = C.split_heads(C.linear(h, lp["wq"], policy), B, T, H, hd)
    k = C.split_heads(C.linear(h, lp["wk"], policy), B, T, Hkv, hd)
    v = C.split_heads(C.linear(h, lp["wv"], policy), B, T, Hkv, hd)
    if cfg.qk_norm:
        q = C.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = C.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    return q, k, v


def ffn(h, lp, cfg: ModelConfig, policy, layer_idx: int):
    """Layer ``layer_idx``'s feed-forward block: SwiGLU, or where it
    routes (:func:`routes`) the MoE FFN plus the dense residual / shared
    expert's SwiGLU."""
    if routes(cfg, layer_idx):
        y = MOE.moe_ffn(h, lp, cfg, policy)
        if cfg.moe_dense_residual or cfg.shared_expert:
            with trace.span("moe.shared"):
                y = y + C.swiglu(h, {"w1": lp["ws1"], "w3": lp["ws3"],
                                     "w2": lp["ws2"]}, policy)
        return y
    return C.swiglu(h, lp, policy)


def sublayer_out(y, lp, name: str, cfg: ModelConfig):
    """A sub-layer's output as the residual adds it: with ``post_norms``
    RMS-normalised by the gain ``lp[name]``, else as it is."""
    return C.rms_norm(y, lp[name], cfg.norm_eps) if cfg.post_norms else y


def layer(x, lp, cfg: ModelConfig, policy, layer_idx: int, rotation,
          attend):
    """One decoder layer on x (B, T, d), the body of every forward:
    ``attend(q, k, v)`` → (B, T, H, hd) is the forward's own attention
    (and cache write) over the rotated q and k; ``rotation`` the step's
    RoPE table or None (sinusoidal positions).  Pre-norm (``ln1``,
    ``ln2``) or, with ``post_norms``, ``x + norm(Attn(x))`` and
    ``x + norm(FFN(x))``."""
    B, T, _ = x.shape
    h = x if cfg.post_norms else C.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv(h, lp, cfg, policy)
    if rotation is not None and layer_rope(cfg, layer_idx):
        q = C.apply_rope(q, rotation)
        k = C.apply_rope(k, rotation)
    attn = attend(q, k, v)
    o = C.linear(C.merge_heads(attn, B, T, -1), lp["wo"], policy)
    x = x + sublayer_out(o, lp, "post_attn_norm", cfg)
    h2 = x if cfg.post_norms else C.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y = ffn(h2, lp, cfg, policy, layer_idx)
    return x + sublayer_out(y, lp, "post_ffn_norm", cfg)


def lm_logits(params, h: torch.Tensor) -> torch.Tensor:
    """Logits over the vocabulary (tied embedding unless ``lm_head``)."""
    w = params["lm_head"] if "lm_head" in params else params["embed"].T
    return torch.matmul(h, w.to(h.dtype))


# ---------------------------------------------------------------------------
# Full-sequence forward (training) — bf16 path
# ---------------------------------------------------------------------------


def hidden_states(params, cfg: ModelConfig, tokens: torch.Tensor,
                  img_embeds: Optional[torch.Tensor] = None,
                  policy: Optional[PrecisionPolicy] = None,
                  remat: bool = False) -> torch.Tensor:
    """tokens (B, S_text) → final normed hidden states (B, S, d), the
    training forward of ``repro.models.transformer.hidden_states``.

    vlm: ``img_embeds`` (B, n_img, VIT_WIDTH) are projected and
    prepended, so S = n_img + S_text.  Attention is causal
    :func:`repro_torch.core.attention.flash_attention` with each layer's
    window (the kernels on the card, forward and backward); ``remat``
    recomputes each layer in the backward pass."""
    x = C.embed_rows(params["embed"], tokens)
    if img_embeds is not None:
        proj = C.linear(img_embeds.to(x.dtype), params["img_proj"], policy)
        x = torch.cat([proj.to(x.dtype), x], dim=1)
    B, S, d = x.shape
    rotation = None
    if cfg.use_rope:
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        rotation = C.rope_rotation(pos, cfg.hd, rotary_pct=cfg.rotary_pct,
                                   theta=cfg.rope_theta)
    else:
        x = x + C.sinusoidal_pos(S, d, device=x.device)[None]

    def body(xc, lp, i):
        win = layer_window(cfg, i)
        win = None if win == BIG_WINDOW else win
        return layer(xc, lp, cfg, policy, i, rotation,
                     lambda q, k, v: A.flash_attention(q, k, v, causal=True,
                                                       window=win))

    for i, lp in enumerate(params["layers"]):
        if remat:
            x = checkpoint(body, x, lp, i, use_reentrant=False)
        else:
            x = body(x, lp, i)
    return C.rms_norm(x, params["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Prefill: the whole prompt (and image) at once → last-token logits + cache
# ---------------------------------------------------------------------------


def prefill(params, cfg: ModelConfig, policy: PrecisionPolicy,
            tokens: torch.Tensor, cache: KV.KVCache,
            img_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KV.KVCache]:
    """tokens (B, P) from position 0 into a dense slab; the vlm family's
    ``img_embeds`` (B, n_img, VIT_WIDTH) are projected by ``img_proj``
    and prepended, so the slab's first ``n_img + P`` rows are written.
    Attention is :func:`repro_torch.core.attention.flash_attention` (the
    flash-prefill kernel on the card) over the whole sequence; each
    layer's K/V are quantized into the slab at position 0.  Returns the
    last row's (B, V) logits and the cache.  Raises ``ValueError`` when
    the sequence does not fit the slab."""
    x = C.embed_rows(params["embed"], tokens).to(policy.compute_dtype)
    if img_embeds is not None:
        proj = C.linear(img_embeds.to(x.dtype), params["img_proj"], policy)
        x = torch.cat([proj.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if S > cache.max_seq:
        raise ValueError(
            f"prefill of {S} rows ({S - tokens.shape[1]} image + "
            f"{tokens.shape[1]} prompt) does not fit max_seq="
            f"{cache.max_seq}")
    rotation = None
    if cfg.use_rope:
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        rotation = C.rope_rotation(pos, cfg.hd, rotary_pct=cfg.rotary_pct,
                                   theta=cfg.rope_theta)
    else:
        x = x + C.sinusoidal_pos(S, x.shape[-1], device=x.device)[None]
    for i, lp in enumerate(params["layers"]):
        win = layer_window(cfg, i)

        def attend(q, k, v, i=i, win=win):
            attn = A.flash_attention(q, k, v, causal=True, window=None
                                     if win == BIG_WINDOW else win)
            KV.append(cache.layer(i), k, v, 0, policy.kv)
            return attn
        x = layer(x, lp, cfg, policy, i, rotation, attend)
    h_last = C.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h_last), cache


# ---------------------------------------------------------------------------
# Decode: T new tokens per slot against the KV cache
# ---------------------------------------------------------------------------


def _position_rows(n_ctx: int, d: int, pos: torch.Tensor, T: int,
                   per_slot: bool) -> torch.Tensor:
    """(B, T, d) rows of the ``n_ctx``-long sinusoidal table for tokens at
    ``pos + t``, as the reference reads them: per slot by a gather, a
    scalar position by a slice whose start is clamped to fit the table
    (``dynamic_slice``).  A per-slot row past the table (a mixed step's
    padding rows near the context end) reads the table's last row, never
    out of range; the reference's ``take`` fills it with NaN.  Such rows
    are neither written to the cache nor read for logits."""
    sp = C.sinusoidal_pos(n_ctx, d, device=pos.device)
    t = torch.arange(T, device=pos.device)
    if per_slot:
        idx = (pos.long()[:, None] + t[None]).clamp(max=n_ctx - 1)
    else:
        idx = (pos.long()[:1, None].clamp(0, n_ctx - T) + t[None]).expand(
            pos.shape[0], T)
    return sp[idx]


def decode_step(params, cfg: ModelConfig, policy: PrecisionPolicy,
                tokens: torch.Tensor, cache, pos: torch.Tensor,
                max_live: Optional[int] = None,
                valid: Optional[torch.Tensor] = None,
                attn_block_s: Optional[int] = None,
                attn_impl: str = "kernel",
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
    tile height; ``attn_impl`` picks the kernels (``"kernel"``) or the
    reference's gathered-view opt-out (``"xla"``,
    :func:`repro_torch.models.common.attend_decode`).  Returns ((B, V)
    logits, the cache)."""
    dev = tokens.device
    x = C.embed_rows(params["embed"], tokens).to(policy.compute_dtype)
    B, T, _ = x.shape
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    per_slot = pos.dim() == 1
    if not per_slot:
        pos = pos.expand(B).contiguous()
    paged = isinstance(cache, PKV.PagedKVCache)
    rotation = None
    if cfg.use_rope:
        # the same for every layer: RoPE tables and the pool rows written
        rope_pos = pos.long()[:, None] + torch.arange(T, device=dev)[None]
        rotation = C.rope_rotation(rope_pos, cfg.hd,
                                   rotary_pct=cfg.rotary_pct,
                                   theta=cfg.rope_theta)
    else:
        n_ctx = cache.max_context if paged else cache.max_seq
        x = x + _position_rows(n_ctx, x.shape[-1], pos, T, per_slot)
    rows = (PKV if paged else KV).write_rows(cache, pos, T, valid)
    for i, lp in enumerate(params["layers"]):
        with trace.span("model.layer"):
            cache_l = cache.layer(i)

            def attend(q, k, v, i=i, cache_l=cache_l):
                if paged:
                    PKV.append_paged(cache_l, k, v, pos, policy.kv,
                                     rows=rows)
                else:
                    KV.append_per_slot(cache_l, k, v, pos, policy.kv,
                                       rows=rows)
                return C.attend_decode(q, cache_l, policy.kv, pos,
                                       window=layer_window(cfg, i),
                                       block_s=attn_block_s,
                                       max_live=max_live, impl=attn_impl)
            x = layer(x, lp, cfg, policy, i, rotation, attend)
    with trace.span("model.head"):
        if valid is None:
            h_sel = x[:, -1]
        else:
            # each slot reads its last *valid* row (idle slots clamp to row
            # 0; the engine discards their logits)
            idx = (valid.long() - 1).clamp(0, T - 1)
            h_sel = x[torch.arange(B, device=dev), idx]
        h_last = C.rms_norm(h_sel, params["final_norm"], cfg.norm_eps)
        return lm_logits(params, h_last), cache
