"""RecurrentGemma / Griffin — the hybrid family: RG-LRU recurrent blocks
and local (sliding-window) MQA attention, pattern (recurrent, recurrent,
attention) repeating, then the trailing recurrent blocks.

Port of ``repro.models.rglru`` (prefill, decode and the training
forward).  RG-LRU per channel:

    r_t = σ(W_a x_t)          i_t = σ(W_i x_t)
    log a_t = -c · softplus(Λ) · r_t            (c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the recurrence as a log-depth associative scan (the port of
``jax.lax.associative_scan``'s tree, :func:`_associative_scan`), its
attention blocks through ``core.attention.flash_attention`` (the
flash-prefill kernel on the card, and its backward kernel in training);
decode is the O(1) per-token update and ``decode_attention`` over the
quantized slab.  Parameters are dicts whose
``rec1`` / ``rec2`` / ``attn`` / ``trail`` entries are lists of per-layer
dicts (the JAX package stacks them for its scans).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core import kvcache as KV
from repro_torch.core.precision import PrecisionPolicy, get_policy

from . import common as C
from .transformer import lm_logits

LRU_C = 8.0


@dataclasses.dataclass
class HybridCache:
    """Decode state: batch on axis 1 of every leaf (the engine splices a
    B=1 prefill cache into a slot along it)."""

    kv: Optional[KV.KVCache]  # (L_attn, B, S, 1, Dstore) quantized; None
    #                            in training (nothing is written)
    h: torch.Tensor          # (L_rec, B, W) f32 LRU state
    conv: torch.Tensor       # (L_rec, B, conv_width - 1, W) bf16 conv tail


def _counts(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(superblocks, recurrent blocks, trailing recurrent blocks)."""
    n_super = cfg.n_layers // cfg.rglru_period
    n_trail = cfg.n_layers - n_super * cfg.rglru_period
    n_rec = n_super * (cfg.rglru_period - 1) + n_trail
    return n_super, n_rec, n_trail


def init_cache(cfg: ModelConfig, policy: PrecisionPolicy, batch: int,
               max_seq: int, device="cuda") -> HybridCache:
    """Zero state: one KV slab per attention block, zero LRU state and
    conv tail per recurrent block."""
    n_super, n_rec, _ = _counts(cfg)
    W = cfg.lru_width or cfg.d_model
    return HybridCache(
        kv=KV.init_cache(batch, max_seq, cfg.n_kv_heads, cfg.hd, policy.kv,
                         n_layers=n_super, device=device),
        h=torch.zeros((n_rec, batch, W), dtype=torch.float32, device=device),
        conv=torch.zeros((n_rec, batch, cfg.conv_width - 1, W),
                         dtype=torch.bfloat16, device=device))


def cache_spec(cfg: ModelConfig, policy: PrecisionPolicy, batch: int,
               max_seq: int) -> HybridCache:
    """:func:`init_cache` with no storage (meta tensors): the dry-run's
    stand-in."""
    return init_cache(cfg, policy, batch, max_seq, device="meta")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _init_rec_block(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    W = cfg.lru_width or d
    dev = gen.device
    return {
        "ln1": torch.zeros(d, dtype=torch.bfloat16, device=dev),
        "wx": C.dense_init(gen, (d, W)),
        "wy": C.dense_init(gen, (d, W)),
        "wo": C.dense_init(gen, (W, d)),
        "conv_w": C.dense_init(gen, (cfg.conv_width, W), scale=0.5),
        "wa": C.dense_init(gen, (W, W), scale=0.01),
        "wi": C.dense_init(gen, (W, W), scale=0.01),
        "lam": torch.full((W,), 2.0, dtype=torch.float32, device=dev),
        "ln2": torch.zeros(d, dtype=torch.bfloat16, device=dev),
        "w1": C.dense_init(gen, (d, f)),
        "w3": C.dense_init(gen, (d, f)),
        "w2": C.dense_init(gen, (f, d)),
    }


def _init_attn_block(cfg: ModelConfig, gen: torch.Generator
                     ) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = gen.device
    return {
        "ln1": torch.zeros(d, dtype=torch.bfloat16, device=dev),
        "wq": C.dense_init(gen, (d, H * hd)),
        "wk": C.dense_init(gen, (d, Hkv * hd)),
        "wv": C.dense_init(gen, (d, Hkv * hd)),
        "wo": C.dense_init(gen, (H * hd, d)),
        "ln2": torch.zeros(d, dtype=torch.bfloat16, device=dev),
        "w1": C.dense_init(gen, (d, f)),
        "w3": C.dense_init(gen, (d, f)),
        "w2": C.dense_init(gen, (f, d)),
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Seeded random parameters of the JAX package's shapes, drawn on
    ``device`` from one ``torch.Generator`` (other values than JAX's for
    the same seed; tests carry JAX's across with ``params_from_jax``)."""
    n_super, _, n_trail = _counts(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {
        "embed": C.dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02),
        "rec1": [_init_rec_block(cfg, gen) for _ in range(n_super)],
        "rec2": [_init_rec_block(cfg, gen) for _ in range(n_super)],
        "attn": [_init_attn_block(cfg, gen) for _ in range(n_super)],
        "trail": [_init_rec_block(cfg, gen) for _ in range(n_trail)],
        "final_norm": torch.zeros(cfg.d_model, dtype=torch.bfloat16,
                                  device=device),
        "lm_head": C.dense_init(gen, (cfg.d_model, cfg.vocab), scale=0.02),
    }


def empty_stacks(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's leaves of each layer stack with no layers:
    ``trail`` when ``n_layers`` is a multiple of ``rglru_period`` (the
    superblock stacks when it is below it), each a block's leaves with a
    leading axis of 0.  The port's empty list holds no shapes; the
    reference's stacked dict keeps these (``training.checkpoint``).  A
    block is drawn on the CPU only for a stack that is empty."""
    n_super, _, n_trail = _counts(cfg)
    blocks = {"rec1": (n_super, _init_rec_block),
              "rec2": (n_super, _init_rec_block),
              "attn": (n_super, _init_attn_block),
              "trail": (n_trail, _init_rec_block)}
    gen = torch.Generator()
    return {name: {k: torch.zeros((0,) + tuple(v.shape), dtype=v.dtype)
                   for k, v in init(cfg, gen).items()}
            for name, (n, init) in blocks.items() if n == 0}


# ---------------------------------------------------------------------------
# RG-LRU + conv
# ---------------------------------------------------------------------------


def _associative_scan(fn, elems: List[torch.Tensor], dim: int
                      ) -> List[torch.Tensor]:
    """Inclusive scan of ``elems`` along ``dim`` with the associative
    ``fn``: the port of ``jax.lax.associative_scan``'s log-depth tree
    (combine adjacent pairs, scan the half recursively, fill in the even
    positions, interleave), so every element is the same product of the
    same pairs in the same order as in JAX."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = fn([sl(e, 0, n - 1, 2) for e in elems],
                 [sl(e, 1, None, 2) for e in elems])
    odd = _associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([sl(e, 0, -1) for e in odd],
                  [sl(e, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    out = []
    for e, o in zip(even, odd):
        shape = list(e.shape)
        shape[dim] = n
        t = e.new_empty(shape)
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(0, None, 2)
        t[tuple(idx)] = e
        idx[dim] = slice(1, None, 2)
        t[tuple(idx)] = o
        out.append(t)
    return out


def _lru_combine(e1, e2):
    """``(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2)``; the second term is
    one fused multiply-add, as XLA compiles it (``addcmul``: bit for bit
    with the jitted JAX scan on the CPU)."""
    (a1, b1), (a2, b2) = e1, e2
    return [a1 * a2, torch.addcmul(b2, a2, b1)]


def _gates(y: torch.Tensor, lp, policy
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's (a, b) in f32 from the post-conv activations y:
    ``a = exp(log a)`` and ``b = √(max(1 − a², 1e-12)) · (i · y)``, in the
    JAX order of operations."""
    r = torch.sigmoid(C.linear(y, lp["wa"], policy).float())
    i = torch.sigmoid(C.linear(y, lp["wi"], policy).float())
    log_a = -LRU_C * F.softplus(lp["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * y.float())
    return a, b


def _causal_conv_seq(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, W), w (cw, W), tail (B, cw-1, W) → (y, new tail).  Term i
    is ``xp[:, i:i+S] · w[cw-1-i]``, summed from i = 0 in x's dtype."""
    cw, S = w.shape[0], x.shape[1]
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    y = xp[:, 0:S] * w[cw - 1]
    for i in range(1, cw):
        y = y + xp[:, i:i + S] * w[cw - 1 - i]
    return y, xp[:, -(cw - 1):]


def _rglru_seq(x: torch.Tensor, lp, policy, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, W) post-conv, h0 (B, W) f32 → (y (B, S, W) in x's dtype,
    final state)."""
    a, b = _gates(x, lp, policy)
    a_cum, b_cum = _associative_scan(_lru_combine, [a, b], dim=1)
    h = torch.addcmul(b_cum, a_cum, h0[:, None])
    return h.to(x.dtype), h[:, -1]


def _rec_block_seq(x, lp, cfg: ModelConfig, policy, h0, conv_tail):
    hin = C.rms_norm(x, lp["ln1"], cfg.norm_eps)
    gate = C.gelu(C.linear(hin, lp["wy"], policy).float())
    xr = C.linear(hin, lp["wx"], policy)
    xr, new_tail = _causal_conv_seq(xr, lp["conv_w"], conv_tail)
    y, h_fin = _rglru_seq(xr, lp, policy, h0)
    y = (y.float() * gate).to(x.dtype)
    x = x + C.linear(y, lp["wo"], policy)
    h2 = C.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + C.swiglu(h2, lp, policy), h_fin, new_tail


def _rec_block_step(x, lp, cfg: ModelConfig, policy, h0, conv_tail):
    """Single-token recurrent block.  x: (B, d).  The conv sums from the
    newest token (weight 0) back, as the JAX step does."""
    hin = C.rms_norm(x, lp["ln1"], cfg.norm_eps)
    gate = C.gelu(C.linear(hin, lp["wy"], policy).float())
    xr = C.linear(hin, lp["wx"], policy)                     # (B, W)
    w = lp["conv_w"]
    cw = w.shape[0]
    xfull = torch.cat([conv_tail.to(xr.dtype), xr[:, None]], dim=1)
    y = xfull[:, -1] * w[0]
    for i in range(1, cw):
        y = y + xfull[:, -(i + 1)] * w[i]
    new_tail = xfull[:, -(cw - 1):]
    a, b = _gates(y, lp, policy)
    h_new = torch.addcmul(b, a, h0)
    y = (h_new * gate).to(x.dtype)
    x = x + C.linear(y, lp["wo"], policy)
    h2 = C.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + C.swiglu(h2, lp, policy), h_new, new_tail


# ---------------------------------------------------------------------------
# Attention block (local / sliding window)
# ---------------------------------------------------------------------------


def _qkv(h, lp, cfg: ModelConfig, policy, rope_pos):
    B, T, _ = h.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    rot = C.rope_rotation(rope_pos, hd, theta=cfg.rope_theta)
    q = C.split_heads(C.linear(h, lp["wq"], policy), B, T, H, hd)
    k = C.split_heads(C.linear(h, lp["wk"], policy), B, T, Hkv, hd)
    v = C.split_heads(C.linear(h, lp["wv"], policy), B, T, Hkv, hd)
    return C.apply_rope(q, rot), C.apply_rope(k, rot), v


def _attn_tail(x, attn, lp, cfg: ModelConfig, policy):
    """Output projection, residual and the SwiGLU MLP."""
    x = x + C.linear(C.merge_heads(attn, *x.shape[:-1], -1), lp["wo"],
                     policy)
    h2 = C.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + C.swiglu(h2, lp, policy)


def _attn_block_seq(x, lp, cfg: ModelConfig, policy,
                    cache_l: Optional[KV.KVCache]):
    """Full-sequence attention block; its K/V are written to ``cache_l``
    unless it is None (training)."""
    B, S, _ = x.shape
    h = C.rms_norm(x, lp["ln1"], cfg.norm_eps)
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    q, k, v = _qkv(h, lp, cfg, policy, pos)
    attn = A.flash_attention(q, k, v, causal=True, window=cfg.window)
    if cache_l is not None:
        KV.append(cache_l, k, v, 0, policy.kv)
    return _attn_tail(x, attn, lp, cfg, policy)


def _attn_block_step(x, lp, cfg: ModelConfig, policy, cache_l: KV.KVCache,
                     pos: torch.Tensor):
    """x (B, d); pos (B,) each slot's position."""
    h = C.rms_norm(x, lp["ln1"], cfg.norm_eps)[:, None]
    q, k, v = _qkv(h, lp, cfg, policy, pos.long()[:, None])
    KV.append_per_slot(cache_l, k, v, pos, policy.kv)
    attn = A.decode_attention(q, cache_l, policy.kv, pos, window=cfg.window)
    return _attn_tail(x, attn[:, 0], lp, cfg, policy)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def _run(params, cfg: ModelConfig, policy, x: torch.Tensor,
         cache: HybridCache, rec_block, attn_block, remat: bool = False
         ) -> Tuple[torch.Tensor, HybridCache]:
    """The layer walk shared by prefill, decode and training: superblock i
    runs recurrent states 2i and 2i+1 and attention slab i, the trailing
    blocks the states after them.  Returns (x, new cache); the slabs are
    written in place.  ``remat`` recomputes each superblock in the
    backward pass (the trailing blocks are kept, as in the reference)."""
    n_super = len(params["attn"])
    h_new, c_new = list(cache.h.unbind(0)), list(cache.conv.unbind(0))

    def superblock(x, i, h1, c1, h2, c2):
        x, h1, c1 = rec_block(x, params["rec1"][i], cfg, policy, h1, c1)
        x, h2, c2 = rec_block(x, params["rec2"][i], cfg, policy, h2, c2)
        x = attn_block(x, params["attn"][i], cfg, policy,
                       None if cache.kv is None else cache.kv.layer(i))
        return x, h1, c1, h2, c2

    for i in range(n_super):
        args = (x, i, h_new[2 * i], c_new[2 * i], h_new[2 * i + 1],
                c_new[2 * i + 1])
        x, h_new[2 * i], c_new[2 * i], h_new[2 * i + 1], c_new[2 * i + 1] = \
            checkpoint(superblock, *args, use_reentrant=False) if remat \
            else superblock(*args)
    for t, lp in enumerate(params["trail"]):
        j = 2 * n_super + t
        x, h_new[j], c_new[j] = rec_block(x, lp, cfg, policy, h_new[j],
                                          c_new[j])
    return x, HybridCache(kv=cache.kv, h=torch.stack(h_new),
                          conv=torch.stack(c_new))


def hidden_states(params, cfg: ModelConfig, tokens: torch.Tensor,
                  policy: Optional[PrecisionPolicy] = None,
                  remat: bool = False) -> torch.Tensor:
    """tokens (B, S) → final normed hidden states (B, S, d): the layer walk
    from zero recurrent states, writing no KV (the reference's
    ``hidden_states``: ``_run`` on a fresh cache without cache writes)."""
    policy = policy or get_policy("w16a16kv16")
    B = tokens.shape[0]
    _, n_rec, _ = _counts(cfg)
    W = cfg.lru_width or cfg.d_model
    dev = tokens.device
    state = HybridCache(
        kv=None, h=torch.zeros((n_rec, B, W), dtype=torch.float32,
                               device=dev),
        conv=torch.zeros((n_rec, B, cfg.conv_width - 1, W),
                         dtype=torch.bfloat16, device=dev))
    x = C.embed_rows(params["embed"], tokens).to(policy.compute_dtype)
    x, _ = _run(params, cfg, policy, x, state, _rec_block_seq,
                _attn_block_seq, remat=remat)
    return C.rms_norm(x, params["final_norm"], cfg.norm_eps)


def prefill(params, cfg: ModelConfig, policy: PrecisionPolicy,
            tokens: torch.Tensor, cache: HybridCache
            ) -> Tuple[torch.Tensor, HybridCache]:
    """tokens (B, T) from position 0 → (last-position logits (B, V), the
    cache with every attention block's K/V written and the final states)."""
    x = C.embed_rows(params["embed"], tokens).to(policy.compute_dtype)
    x, cache = _run(params, cfg, policy, x, cache, _rec_block_seq,
                    _attn_block_seq)
    h = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h[:, -1]), cache


def decode_step(params, cfg: ModelConfig, policy: PrecisionPolicy,
                tokens: torch.Tensor, cache: HybridCache, pos
                ) -> Tuple[torch.Tensor, HybridCache]:
    """tokens (B, 1); pos (B,) or scalar position of each slot's token →
    ((B, V) logits, the updated cache)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=tokens.device)
    if pos.dim() == 0:
        pos = pos.expand(B).contiguous()
    x = C.embed_rows(params["embed"], tokens[:, 0]).to(policy.compute_dtype)

    def attn_block(x, lp, cfg, policy, cache_l):
        return _attn_block_step(x, lp, cfg, policy, cache_l, pos)

    x, cache = _run(params, cfg, policy, x, cache, _rec_block_step,
                    attn_block)
    h = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h), cache
