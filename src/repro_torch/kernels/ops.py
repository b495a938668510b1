"""Public wrappers around the kernels: the model-facing shapes.

Port of ``repro.kernels.ops``: per-token activation quantization for the
A8 GEMM, the head-major layout of the flash-prefill kernel, row grouping
for the multi-query attention kernels, position/window normalisation and
the paged live-block bound.  Each call
goes to the kernel wrapper, which runs the plain version for CPU tensors
and the CUDA kernel for CUDA tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantize as Q
from repro_torch.core.kvcache import KVCache
from repro_torch.core.packing import PackedWeight
from repro_torch.core.paged_kvcache import PagedKVCache, blocks_needed
from repro_torch.core.precision import FormatSpec, PrecisionPolicy

from .flashprefill import flash_prefill
from .kvattn import kvattn
from .mpgemm import mpgemm_a16, mpgemm_int8
from .paged_kvattn import paged_kvattn
from .ref import NO_WINDOW


def mpgemm(x: torch.Tensor, w: PackedWeight,
           policy: PrecisionPolicy) -> torch.Tensor:
    """y = x @ W with in-kernel dequant.  x: (..., K) → (..., N) bf16.

    A8 policies with integer weights (``policy.int8_matmul``) quantize x
    per token here, outside the kernel, and take the s8×s8→s32 kernel;
    every other packed weight takes the A16 kernel with x in bf16 (afp8
    activations are never quantized, as in the JAX package).  Ragged M
    goes to the kernels as is (the JAX wrapper's ``bm = 1`` fallback is a
    Pallas block-shape constraint the CUDA kernels lack)."""
    K, N = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if x2.data_ptr() % 16:         # the kernels copy x in 16-byte pieces
        x2 = x2.clone()
    if policy.int8_matmul:
        xq, xs = Q.quantize_act_per_token(x2.float(), bits=8)
        y = mpgemm_int8(xq, xs, w)
    else:
        y = mpgemm_a16(x2.to(torch.bfloat16).contiguous(), w)
    return y.reshape(*lead, N)


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: Optional[int] = None) -> torch.Tensor:
    """Fused flash prefill.  q: (B, S, H, D); k/v: (B, S, Hkv, D).

    The kernel takes head-major bf16 operands and masks the ragged tail
    itself, so S needs no padding (the JAX wrapper pads S to a block
    multiple for its Pallas grid); its wrapper picks the tile.  Returns
    (B, S, H, D) in q's dtype."""
    hm = [t.transpose(1, 2).to(torch.bfloat16).contiguous()
          for t in (q, k, v)]
    out = flash_prefill(*hm, causal=causal, window=window)
    return out.transpose(1, 2).to(q.dtype)


def _norm_pos(pos, B: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.dim() == 0:
        pos = pos.expand(B)
    return pos.contiguous()


def _norm_window(window) -> int:
    """None / int → the kernels' window operand (NO_WINDOW = off)."""
    return NO_WINDOW if window is None else int(window)


def _group_rows(q: torch.Tensor, Hkv: int, rep: int) -> torch.Tensor:
    """(B, T, H, D) → (B, Hkv, T*rep, D) token-major q tile: row
    ``r = t*rep + g`` holds token t's g-th grouped-query head, so the
    kernel's per-row causal frontier is ``first_pos + r // rep``.

    The JAX wrapper pads ``rep == 1`` to two rows to keep XLA:CPU on its
    GEMM path (bitwise row stability); that is an XLA workaround, not part
    of the kernel's contract, and is not needed here."""
    B, T, H, D = q.shape
    qg = q.reshape(B, T, Hkv, rep, D).permute(0, 2, 1, 3, 4)
    return qg.reshape(B, Hkv, T * rep, D)


def _ungroup_rows(out: torch.Tensor, B: int, T: int, Hkv: int, rep: int,
                  D: int) -> torch.Tensor:
    """Inverse of :func:`_group_rows`."""
    o = out.reshape(B, Hkv, T, rep, D).permute(0, 2, 1, 3, 4)
    return o.reshape(B, T, Hkv * rep, D)


def kvattn_decode(q: torch.Tensor, cache: KVCache, spec: FormatSpec, pos,
                  window=None, block_s: int = 256) -> torch.Tensor:
    """Dense-slab decode / chunked-prefill attention.  q: (B, T, H, D);
    ``cache`` a per-layer view; ``pos`` the per-slot first query position
    (token t attends through ``pos + t``).  The kernel walks the
    ``min(block_s, S)``-token tiles of the slab up to each slot's
    frontier."""
    B, T, H, D = q.shape
    Hkv = cache.k.shape[2]
    rep = H // Hkv
    qg = _group_rows(q.to(torch.bfloat16), Hkv, rep).contiguous()
    out = kvattn(qg, cache.k, cache.k_scale, cache.v, cache.v_scale,
                 _norm_pos(pos, B, q.device), _norm_window(window), rep,
                 block_s, spec)
    return _ungroup_rows(out, B, T, Hkv, rep, D).to(q.dtype)


def kvattn_decode_paged(q: torch.Tensor, cache: PagedKVCache,
                        spec: FormatSpec, pos, window=None,
                        max_live: Optional[int] = None) -> torch.Tensor:
    """Paged decode / chunked-prefill attention, block table resolved
    inside the kernel.

    q: (B, T, H, D); ``cache`` a per-layer view; ``pos`` the per-slot
    first query position (token t attends through ``pos + t``).
    ``max_live`` (tokens) bounds the walk at the batch's first-row
    live-context high-water mark, widened by ``T - 1`` for the chunk's
    tail; None walks the whole table."""
    B, T, H, D = q.shape
    Hkv = cache.k.shape[2]
    rep = H // Hkv
    qg = _group_rows(q.to(torch.bfloat16), Hkv, rep).contiguous()
    n_live = cache.blocks_per_slot
    if max_live is not None:
        n_live = blocks_needed(max_live + T - 1, cache.block_size)
    out = paged_kvattn(qg, cache.k, cache.k_scale, cache.v, cache.v_scale,
                       cache.block_table, _norm_pos(pos, B, q.device),
                       _norm_window(window), rep, n_live, spec)
    return _ungroup_rows(out, B, T, Hkv, rep, D).to(q.dtype)
