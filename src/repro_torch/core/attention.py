"""Attention outside the serving kernels: prefill, one-shot-family decode
and cross attention.

Port of ``repro.core.attention``:

* :func:`flash_attention` — memory-bounded prefill attention.  On CUDA
  tensors it runs the hand-written flash-prefill kernel
  (``csrc/flash_prefill.cu``); on CPU tensors its plain version, the port
  of the JAX function's ``q_chunk × kv_chunk`` online-softmax walk.
* :func:`decode_attention` (``impl="fused"``) and :func:`cross_attention`
  — the JAX package computes them with XLA outside any Pallas kernel; here
  they are plain PyTorch (``einsum`` over the dequantized slab) on the
  card and on the CPU alike.
* :func:`prefill_attention` — the full-matrix oracle.

Not ported: ``_flash_triangle`` / ``BLOCK_SKIP`` / ``SP_PREFILL`` (dry-run
and multi-device knobs, ROADMAP queue 1 item 12) and
``impl="dequant_first"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

from . import quantize as Q
from .kvcache import KVCache
from .precision import FormatSpec

NEG_INF = -1e30


def _unpack_if_needed(x: torch.Tensor, spec: FormatSpec) -> torch.Tensor:
    return Q.unpack_int4(x, dim=x.dim() - 1) if spec.packed else x


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: Optional[int] = None,
                      causal: bool = True) -> torch.Tensor:
    """Full-matrix prefill attention (the small oracle).  q (B, S, H, D),
    k/v (B, S, Hkv, D); scores in f32, probabilities cast to q's dtype
    before the PV product, as in the JAX function."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, S, Hkv, rep, D).float()
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float())
    scores = scores * (1.0 / torch.sqrt(torch.tensor(float(D))))
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos) if causal else torch.ones(
        (S, S), dtype=torch.bool, device=q.device)
    if window is not None:
        mask &= kpos > (qpos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.float(), v.float())
    return out.to(q.dtype).reshape(B, S, H, D)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    pos_offset: int = 0) -> torch.Tensor:
    """Online-softmax prefill attention over tiles of keys.
    q (B, S, H, D), k/v (B, S, Hkv, D) → (B, S, H, D) in q's dtype.

    The flash-prefill kernel's wrapper picks the tile from the shapes
    (the JAX default of 512 × 512 chunks does not fit in a block's shared
    memory at D 256); tiles wholly masked are skipped.  The kernel's
    contract is every caller's in the ported families: ``pos_offset ==
    0``, as many queries as keys, and an int or no window.  Chunked or
    offset prefill (``launch/spattn.py``, training) is ROADMAP queue 1
    item 12."""
    if not isinstance(pos_offset, int) or pos_offset != 0 or \
            q.shape[1] != k.shape[1] or not (
                window is None or isinstance(window, int)):
        raise NotImplementedError(
            "flash_attention takes pos_offset 0, Sq == Sk and an int or no "
            "window; the rest is not yet ported: ROADMAP queue 1 item 12")
    return ops.flash_prefill_attention(q, k, v, causal=causal, window=window)


def _scale_rows(scale: torch.Tensor) -> torch.Tensor:
    """(B, S, Hkv) per-token scales → (B, Hkv, 1, 1, S), broadcast over
    the (rep, T) axes of the score tensor."""
    return scale.permute(0, 2, 1)[:, :, None, None, :]


def _attend_slab(q: torch.Tensor, cache: KVCache, spec: FormatSpec,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The fused pipeline over a whole per-layer slab: scores against the
    stored integers' cast, K scales on the scores, softmax in f32, V scales
    folded into the probabilities, then the PV product against the cast V.
    ``mask`` (B, T, S) or None (every key)."""
    B, T, H, D = q.shape
    Hkv = cache.k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, T, Hkv, rep, D).float()
    kq = _unpack_if_needed(cache.k, spec).to(q.dtype).float()
    scores = torch.einsum("bthrd,bshd->bhrts", qg, kq)
    scores = scores * _scale_rows(cache.k_scale)
    scores = scores * (1.0 / torch.sqrt(torch.tensor(float(D))))
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    pv = (probs * _scale_rows(cache.v_scale)).to(q.dtype).float()
    vq = _unpack_if_needed(cache.v, spec).to(q.dtype).float()
    out = torch.einsum("bhrts,bshd->bthrd", pv, vq)
    return out.to(q.dtype).reshape(B, T, H, D)


def decode_attention(q: torch.Tensor, cache: KVCache, spec: FormatSpec,
                     pos, window: Optional[int] = None,
                     impl: str = "fused") -> torch.Tensor:
    """Attend T new queries against ``pos + t`` cached tokens (causal),
    over a per-layer dense slab.  q (B, T, H, D); ``pos`` a scalar or
    (B,) first query position.

    ``impl="fused"`` only: K scales go on the scores and V scales on the
    probabilities — the JAX XLA path's order, not the decode kernels'
    (which scale K/V before the dots, ROADMAP queue 3).  Plain PyTorch on
    every device, as the reference is XLA on every device."""
    if impl != "fused":
        raise NotImplementedError(
            f"decode_attention impl={impl!r} is not yet ported: ROADMAP "
            "queue 1 item 5")
    B, T = q.shape[:2]
    S = cache.max_seq
    dev = q.device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    if pos.dim() == 0:
        pos = pos.expand(B)
    qpos = pos[:, None] + torch.arange(T, device=dev)[None]     # (B, T)
    kpos = torch.arange(S, device=dev)
    mask = kpos[None, None, :] <= qpos[..., None]                # (B, T, S)
    if window is not None:
        mask &= kpos[None, None, :] > (qpos[..., None] - window)
    return _attend_slab(q, cache, spec, mask)


def cross_attention(q: torch.Tensor, cache: KVCache, spec: FormatSpec
                    ) -> torch.Tensor:
    """Whisper's cross attention: T queries against every token of the
    static encoder slab, no mask.  Plain PyTorch, as
    :func:`decode_attention`."""
    return _attend_slab(q, cache, spec, None)
