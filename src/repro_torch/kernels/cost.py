"""The work of each CUDA kernel: operations and bytes from its call's shapes
and host-side data, whatever implements it.

Each function returns ``(ops, nbytes)``: the operations the call must do on
its inputs (2 a multiply-add, counted where the data keeps them: a causal
row's kept keys, not the tile the kernel walks) and the bytes it must move
(each input read once, each output written once).  These are the formulas
of the bound that ``chip_smoke.py`` divides by the card's peaks
(``roofline.analysis.HW``), and the cost each kernel wrapper declares to an
active ``roofline.op_cost`` counter: a step counts the same whether its
kernels ran or their plain versions did.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

Cost = Tuple[int, int]


def gemm(M: int, K: int, N: int, weight_bytes: int, a8: bool) -> Cost:
    """``y (M, N) bf16 = x (M, K) @ W``: x in bf16 (A16) or int8 with one
    f32 scale a row (A8), W's ``weight_bytes`` (:func:`weight_bytes`:
    packed values + per-group f32 scales)."""
    x_bytes = M * K + M * 4 if a8 else M * K * 2
    return 2 * M * N * K, x_bytes + weight_bytes + M * N * 2


def _kept(lo: int, hi: int, key_lo: int, key_hi: int) -> int:
    """Keys of ``[lo, hi)`` inside ``[key_lo, key_hi)``."""
    return max(0, min(hi, key_hi) - max(lo, key_lo))


def decode_attention(pos: Sequence[int], T: int, rep: int, Hkv: int, D: int,
                     window: int, row_bytes: int,
                     table_bytes: int = 0, key_lo: int = 0,
                     key_hi: int = 1 << 62, lse: bool = False) -> Cost:
    """Decode / chunked-prefill attention of T tokens a slot, slot b's
    first at ``pos[b]``, ``rep`` query heads on each of ``Hkv`` KV heads:
    row ``r`` (token r // rep) keeps the keys of ``[pos + r // rep + 1 -
    window, pos + r // rep]`` inside the range ``[key_lo, key_hi)`` the
    call holds (a rank's share of a sequence-sharded slab; all keys by
    default), 4·D operations each (QKᵀ and PV); ``window`` is the
    kernels' operand (``ref.NO_WINDOW`` when off).  Bytes: each slot's
    keys of the range inside some row's window (stored K and V rows of
    ``row_bytes`` each, two f32 scales), q (bf16), the output (bf16, or f32
    with the lse), the positions, each row's f32 lse if asked, and
    ``table_bytes`` of block-table rows (paged)."""
    R = T * rep
    ops = sum(4 * D * Hkv * _kept(p + r // rep + 1 - window, p + r // rep + 1,
                                  key_lo, key_hi)
              for p in pos for r in range(R))
    keys = sum(_kept(p - window + 1, p + T, key_lo, key_hi) for p in pos)
    B = len(pos)
    nbytes = keys * Hkv * (2 * row_bytes + 8) + B * Hkv * R * D * \
        (2 + (4 if lse else 2)) + B * 4 + table_bytes + \
        (4 * B * Hkv * R if lse else 0)
    return ops, nbytes


def kept_pairs(Sq: int, seq: int, causal: bool,
               window: Optional[int], pos_offset: int = 0) -> int:
    """(query, key) pairs flash attention keeps: key ``kpos < seq``,
    ``kpos <= qpos`` if causal, ``kpos > qpos - window``, query row t at
    ``qpos = pos_offset + t``."""
    q = pos_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q + 1, seq) if causal else np.full(Sq, seq)
    lo = np.zeros(Sq, np.int64) if window is None else \
        np.maximum(0, q - int(window) + 1)
    return int(np.maximum(0, hi - lo).sum())


def key_range(Sq: int, seq: int, causal: bool, window: Optional[int],
              pos_offset: int = 0) -> Tuple[int, int]:
    """``[lo, hi)``: the keys some query row keeps (:func:`kept_pairs`'s
    mask), the only ones the flash kernels read — ``lo = pos_offset -
    window + 1`` (0 without a window), ``hi = pos_offset + Sq`` if causal,
    both clipped to ``[0, seq)``."""
    hi = min(seq, pos_offset + Sq) if causal else seq
    lo = 0 if window is None else max(0, pos_offset - int(window) + 1)
    return min(lo, hi), hi


def flash_forward(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
                  seq: int, causal: bool, window: Optional[int],
                  lse: bool, pos_offset: int = 0) -> Cost:
    """Flash attention's forward: 4·D operations a kept pair; q read, the
    keys of :func:`key_range` of k and v read and the output written
    (bf16), each row's f32 lse written if asked."""
    ops = 4 * D * B * H * kept_pairs(Sq, seq, causal, window, pos_offset)
    lo, hi = key_range(Sq, min(seq, Sk), causal, window, pos_offset)
    nbytes = 2 * 2 * B * H * Sq * D + 2 * 2 * B * Hkv * (hi - lo) * D + \
        (4 * B * H * Sq if lse else 0)
    return ops, nbytes


def flash_backward(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
                   seq: int, causal: bool, window: Optional[int],
                   pos_offset: int = 0) -> Cost:
    """Flash attention's backward: five products of 2·D operations a kept
    pair (S, dP, dV, dK, dQ); q, out, dout read and dq written, the keys
    of :func:`key_range` of k and v read and all of dk, dv written (bf16),
    the lse read (f32)."""
    ops = 10 * D * B * H * kept_pairs(Sq, seq, causal, window, pos_offset)
    lo, hi = key_range(Sq, min(seq, Sk), causal, window, pos_offset)
    nbytes = 2 * D * (4 * B * H * Sq + 2 * B * Hkv * (hi - lo) +
                      2 * B * Hkv * Sk) + 4 * B * H * Sq
    return ops, nbytes



# -- the cost of one wrapper call, from the wrapper's own arguments --------

def weight_bytes(w) -> int:
    """Bytes of a packed (K, N) weight that y = x · dequant(W) needs: its
    K·N values and its (K/group, N) f32 scales, the same in every layout.
    A fragment layout of a K of 32 × odd also holds, and the kernels also
    read, its last chunk's 32 zero K rows (``core.packing.to_kernel_layout``);
    they are not counted."""
    K, N = w.shape
    return K * N * w.bits // 8 + (K // w.group) * N * 4


def of_mpgemm_a16(x, w) -> Cost:
    """``kernels.mpgemm.mpgemm_a16(x, w)``: the weight bytes of
    :func:`weight_bytes`."""
    return gemm(x.shape[0], *w.shape, weight_bytes(w), a8=False)


def of_mpgemm_int8(xq, xscale, w) -> Cost:
    """``kernels.mpgemm.mpgemm_int8(xq, xscale, w)``: as
    :func:`of_mpgemm_a16`."""
    return gemm(xq.shape[0], *w.shape, weight_bytes(w), a8=True)


def of_kvattn(q, k, k_scale, v, v_scale, pos, window, rep, block_s,
              spec, key_offset=0, return_lse=False, host_pos=None) -> Cost:
    """``kernels.kvattn.kvattn``: reads the positions (a host copy, or
    ``host_pos`` where the caller knows them: the dry-run's fake tensors
    hold no values); charges only the keys of the slab's range
    ``[key_offset, key_offset + S)``."""
    B, Hkv, R, D = q.shape
    key_offset = int(key_offset)
    return decode_attention(pos.tolist() if host_pos is None else host_pos,
                            R // rep, rep, Hkv, D, window,
                            k.shape[-1] * k.element_size(),
                            key_lo=key_offset,
                            key_hi=key_offset + k.shape[1], lse=return_lse)


def of_paged_kvattn(q, k, k_scale, v, v_scale, block_table, pos, window,
                    rep, n_live, spec) -> Cost:
    """``kernels.paged_kvattn.paged_kvattn``: as :func:`of_kvattn`, plus
    the ``n_live`` table entries each slot's walk reads."""
    B, Hkv, R, D = q.shape
    n_live = max(1, min(int(n_live), block_table.shape[1]))
    return decode_attention(pos.tolist(), R // rep, rep, Hkv, D, window,
                            k.shape[-1] * k.element_size(),
                            B * n_live * block_table.element_size())


def of_flash_prefill(q, k, v, *, causal=True, window=None, seq=None,
                     tile=None, return_lse=False, pos_offset=0) -> Cost:
    """``kernels.flashprefill.flash_prefill``."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    return flash_forward(B, H, Hkv, Sq, Sk, D, Sk if seq is None else seq,
                         causal, window, return_lse, pos_offset)


def of_flash_prefill_bwd(q, k, v, out, lse, dout, *, causal=True,
                         window=None, pos_offset=0) -> Cost:
    """``kernels.flashprefill.flash_prefill_bwd``."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    return flash_backward(B, H, Hkv, Sq, Sk, D, Sk, causal, window,
                          pos_offset)


#: each kernel wrapper's cost, by the wrapper's name
OF = {"mpgemm_a16": of_mpgemm_a16, "mpgemm_int8": of_mpgemm_int8,
      "kvattn": of_kvattn, "paged_kvattn": of_paged_kvattn,
      "flash_prefill": of_flash_prefill,
      "flash_prefill_bwd": of_flash_prefill_bwd}
