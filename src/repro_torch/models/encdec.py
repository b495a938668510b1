"""Whisper-style encoder-decoder — the audio family.

Port of ``repro.models.encdec`` (prefill, decode and the training
forward).  The modality
frontend (mel spectrogram + two Conv1d) is a stub, as in the JAX package:
the encoder takes precomputed frame embeddings (B, enc_seq, d_model).  The
encoder's bidirectional self-attention and the decoder prompt's causal
self-attention run ``core.attention.flash_attention`` (the flash-prefill
kernel on the card); decoder steps attend over the quantized self-attention
slab and the write-once cross-attention slab in plain PyTorch, as the JAX
package does in XLA.  Every projection is a quantization-transparent
linear; LayerNorm with bias, sinusoidal encoder positions, learned decoder
positions (clamped to the 448-entry table), logits from ``embed.T``.
Parameters: ``encoder`` / ``decoder`` are lists of per-layer dicts.
:func:`hidden_states` (training) runs the encoder, then the decoder
teacher-forced over the whole target sequence, its cross attention
through ``flash_attention`` with T queries against the encoder's frames
(the kernels, forward and backward, on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import kvcache as KV
from repro_torch.core.precision import PrecisionPolicy, get_policy

from . import common as C


@dataclasses.dataclass
class EncDecCache:
    """Decoder state, batch on axis 1 of every leaf."""

    self_kv: KV.KVCache      # (L, B, max_seq, Hkv, Ds) decoder self-attention
    cross_kv: KV.KVCache     # (L, B, enc_seq, Hkv, Ds) encoder K/V, static


def init_cache(cfg: ModelConfig, policy: PrecisionPolicy, batch: int,
               max_seq: int, device="cuda") -> EncDecCache:
    """Zero self- and cross-attention slabs stacked over decoder layers."""
    def mk(S):
        return KV.init_cache(batch, S, cfg.n_kv_heads, cfg.hd, policy.kv,
                             n_layers=cfg.n_layers, device=device)
    return EncDecCache(self_kv=mk(max_seq), cross_kv=mk(cfg.enc_seq))


def cache_spec(cfg: ModelConfig, policy: PrecisionPolicy, batch: int,
               max_seq: int) -> EncDecCache:
    """:func:`init_cache` with no storage (meta tensors): the dry-run's
    stand-in."""
    return init_cache(cfg, policy, batch, max_seq, device="meta")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _ln(d: int, device) -> Dict[str, torch.Tensor]:
    return {"g": torch.ones(d, dtype=torch.bfloat16, device=device),
            "b": torch.zeros(d, dtype=torch.bfloat16, device=device)}


def _attn_params(gen, d, H, Hkv, hd, prefix=""):
    return {prefix + "wq": C.dense_init(gen, (d, H * hd)),
            prefix + "wk": C.dense_init(gen, (d, Hkv * hd)),
            prefix + "wv": C.dense_init(gen, (d, Hkv * hd)),
            prefix + "wo": C.dense_init(gen, (H * hd, d))}


def _mlp_params(gen, d, f, device):
    return {"w1": C.dense_init(gen, (d, f)),
            "b1": torch.zeros(f, dtype=torch.bfloat16, device=device),
            "w2": C.dense_init(gen, (f, d)),
            "b2": torch.zeros(d, dtype=torch.bfloat16, device=device)}


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Seeded random parameters of the JAX package's shapes and leaves
    (decoder cross-attention weights named ``x*``)."""
    d, f = cfg.d_model, cfg.d_ff
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    enc = [{"ln1": _ln(d, device), **_attn_params(gen, d, H, Hkv, hd),
            "ln2": _ln(d, device), **_mlp_params(gen, d, f, device)}
           for _ in range(cfg.enc_layers)]
    dec = [{"ln1": _ln(d, device), **_attn_params(gen, d, H, Hkv, hd),
            "lnx": _ln(d, device), "ln2": _ln(d, device),
            **_mlp_params(gen, d, f, device),
            **_attn_params(gen, d, H, Hkv, hd, prefix="x")}
           for _ in range(cfg.n_layers)]
    return {
        "encoder": enc,
        "decoder": dec,
        "embed": C.dense_init(gen, (cfg.vocab, d), scale=0.02),
        "dec_pos": C.dense_init(gen, (cfg.max_dec_pos, d), scale=0.01),
        "enc_ln_post": _ln(d, device),
        "final_ln": _ln(d, device),
    }


def _layer_norm(x, p, eps):
    return C.layer_norm(x, p["g"], p["b"], eps)


def _mlp(h, lp, policy):
    y = C.linear(h, lp["w1"], policy) + lp["b1"].to(h.dtype)
    y = C.gelu(y.float()).to(h.dtype)
    return C.linear(y, lp["w2"], policy) + lp["b2"].to(h.dtype)


def _proj(h, w, policy, heads, hd):
    B, T, _ = h.shape
    return C.split_heads(C.linear(h, w, policy), B, T, heads, hd)


# ---------------------------------------------------------------------------
# Encoder: bidirectional self-attention over stub frame embeddings
# ---------------------------------------------------------------------------


def encode(params, cfg: ModelConfig, frames: torch.Tensor,
           policy: Optional[PrecisionPolicy] = None) -> torch.Tensor:
    """frames (B, enc_seq, d_model) precomputed frontend embeddings →
    encoder output (B, enc_seq, d_model) bf16."""
    B, S, d = frames.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = frames.to(torch.bfloat16) + C.sinusoidal_pos(
        S, d, device=frames.device)[None]
    for lp in params["encoder"]:
        h = _layer_norm(x, lp["ln1"], cfg.norm_eps)
        q = _proj(h, lp["wq"], policy, H, hd)
        k = _proj(h, lp["wk"], policy, Hkv, hd)
        v = _proj(h, lp["wv"], policy, Hkv, hd)
        attn = A.flash_attention(q, k, v, causal=False)
        x = x + C.linear(C.merge_heads(attn, B, S, -1), lp["wo"], policy)
        h2 = _layer_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp(h2, lp, policy)
    return _layer_norm(x, params["enc_ln_post"], cfg.norm_eps)


def build_cross_cache(params, cfg: ModelConfig, policy: PrecisionPolicy,
                      enc_out: torch.Tensor, cache: EncDecCache
                      ) -> EncDecCache:
    """Project the encoder output through each decoder layer's cross K/V
    and store it quantized (written in place: write once, read every
    step)."""
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    for i, lp in enumerate(params["decoder"]):
        k = _proj(enc_out, lp["xwk"], policy, Hkv, hd)
        v = _proj(enc_out, lp["xwv"], policy, Hkv, hd)
        KV.append(cache.cross_kv.layer(i), k, v, 0, policy.kv)
    return cache


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _dec_pos_embed(params, pos: torch.Tensor) -> torch.Tensor:
    """Learned decoder positions, clamped to the table (positions past
    whisper's 448 reuse the last row)."""
    table = params["dec_pos"]
    return C.embed_rows(table, pos.long().clamp(0, table.shape[0] - 1))


def _decoder(params, cfg: ModelConfig, policy, x, cache: EncDecCache,
             self_attn) -> torch.Tensor:
    """The decoder layer walk shared by prefill and decode;
    ``self_attn(lp, h, i)`` appends layer i's K/V and attends."""
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    for i, lp in enumerate(params["decoder"]):
        h = _layer_norm(x, lp["ln1"], cfg.norm_eps)
        attn = self_attn(lp, h, i)
        x = x + C.linear(C.merge_heads(attn, B, T, -1), lp["wo"], policy)
        hx = _layer_norm(x, lp["lnx"], cfg.norm_eps)
        qx = _proj(hx, lp["xwq"], policy, H, hd)
        xattn = A.cross_attention(qx, cache.cross_kv.layer(i), policy.kv)
        x = x + C.linear(C.merge_heads(xattn, B, T, -1), lp["xwo"], policy)
        h2 = _layer_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp(h2, lp, policy)
    return x


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h_last = _layer_norm(x[:, -1], params["final_ln"], cfg.norm_eps)
    return torch.matmul(h_last, params["embed"].T.to(h_last.dtype))


def prefill(params, cfg: ModelConfig, policy: PrecisionPolicy,
            tokens: torch.Tensor, cache: EncDecCache,
            frames: Optional[torch.Tensor] = None,
            enc_out: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, EncDecCache]:
    """tokens (B, T) decoder prompt from position 0; frames (B, enc_seq,
    d) stub features (or a ready ``enc_out``) → (last-position logits,
    the cache with cross K/V and the prompt's self K/V written)."""
    if enc_out is None:
        if frames is None:
            raise ValueError("encoder input required at prefill")
        enc_out = encode(params, cfg, frames, policy)
    cache = build_cross_cache(params, cfg, policy, enc_out, cache)
    B, T = tokens.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = torch.arange(T, device=tokens.device)
    x = C.embed_rows(params["embed"], tokens).to(policy.compute_dtype)
    x = x + _dec_pos_embed(params, pos)[None]

    def self_attn(lp, h, i):
        q = _proj(h, lp["wq"], policy, H, hd)
        k = _proj(h, lp["wk"], policy, Hkv, hd)
        v = _proj(h, lp["wv"], policy, Hkv, hd)
        attn = A.flash_attention(q, k, v, causal=True)
        KV.append(cache.self_kv.layer(i), k, v, 0, policy.kv)
        return attn

    x = _decoder(params, cfg, policy, x, cache, self_attn)
    return _logits(params, cfg, x), cache


def decode_step(params, cfg: ModelConfig, policy: PrecisionPolicy,
                tokens: torch.Tensor, cache: EncDecCache, pos
                ) -> Tuple[torch.Tensor, EncDecCache]:
    """tokens (B, T); pos (B,) or scalar first position → ((B, V) logits
    of the last token, the cache with the new self K/V appended)."""
    B, T = tokens.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    if pos.dim() == 0:
        pos = pos.expand(B).contiguous()
    x = C.embed_rows(params["embed"], tokens).to(policy.compute_dtype)
    x = x + _dec_pos_embed(params, pos)[:, None]

    def self_attn(lp, h, i):
        q = _proj(h, lp["wq"], policy, H, hd)
        k = _proj(h, lp["wk"], policy, Hkv, hd)
        v = _proj(h, lp["wv"], policy, Hkv, hd)
        self_l = cache.self_kv.layer(i)
        KV.append_per_slot(self_l, k, v, pos, policy.kv)
        return A.decode_attention(q, self_l, policy.kv, pos)

    x = _decoder(params, cfg, policy, x, cache, self_attn)
    return _logits(params, cfg, x), cache


def hidden_states(params, cfg: ModelConfig, tokens: torch.Tensor,
                  frames: Optional[torch.Tensor] = None,
                  policy: Optional[PrecisionPolicy] = None,
                  remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder hidden states (B, T, d), final-normed: the
    training forward.  ``frames`` (B, enc_seq, d) stub features (zeros
    when None) run through the encoder; each decoder layer attends
    causally to the targets and, without a mask, to the encoder output's
    own cross K/V (Sq = T against Sk = enc_seq).  ``remat`` recomputes
    each decoder layer in the backward pass (the encoder is kept, as in
    the reference)."""
    policy = policy or get_policy("w16a16kv16")
    B, T = tokens.shape
    if frames is None:
        frames = torch.zeros((B, cfg.enc_seq, cfg.d_model),
                             dtype=torch.bfloat16, device=tokens.device)
    enc_out = encode(params, cfg, frames, policy)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pos = torch.arange(T, device=tokens.device)
    x = C.embed_rows(params["embed"], tokens).to(torch.bfloat16)
    x = x + _dec_pos_embed(params, pos)[None]

    def body(x, lp):
        h = _layer_norm(x, lp["ln1"], cfg.norm_eps)
        attn = A.flash_attention(_proj(h, lp["wq"], policy, H, hd),
                                 _proj(h, lp["wk"], policy, Hkv, hd),
                                 _proj(h, lp["wv"], policy, Hkv, hd),
                                 causal=True)
        x = x + C.linear(C.merge_heads(attn, B, T, -1), lp["wo"], policy)
        hx = _layer_norm(x, lp["lnx"], cfg.norm_eps)
        xattn = A.flash_attention(_proj(hx, lp["xwq"], policy, H, hd),
                                  _proj(enc_out, lp["xwk"], policy, Hkv, hd),
                                  _proj(enc_out, lp["xwv"], policy, Hkv, hd),
                                  causal=False)
        x = x + C.linear(C.merge_heads(xattn, B, T, -1), lp["xwo"], policy)
        h2 = _layer_norm(x, lp["ln2"], cfg.norm_eps)
        return x + _mlp(h2, lp, policy)

    for lp in params["decoder"]:
        x = checkpoint(body, x, lp, use_reentrant=False) if remat \
            else body(x, lp)
    return _layer_norm(x, params["final_ln"], cfg.norm_eps)
