"""Hardware-aware weight packing (offline stage of the paper's GEMM pipeline).

Port of ``repro.core.packing``.  The layout is the JAX package's tile-major
one, byte for byte:

    (K, N) int4  →  data[K/bk, N/bn, bk/2, bn] int8, scales[K/group, N] f32

nibbles packed two per byte along the tile-local K axis (low nibble = even
k).  :func:`pack_weight` produces it on every device, so the CPU keeps the
JAX package's bytes.

The CUDA GEMMs (``csrc/gemm_tile.cuh``) take other layouts of the same
values, the paper's §4.1 fragment order, one per kernel, made by
:func:`to_kernel_layout` (``layout="frag_a16"`` for ``mpgemm_a16``,
``"frag_a8"`` for ``mpgemm_int8``)::

    data[N/16, K/64, 32 lanes, 4·bits] int8

Each (16-column, 64-deep) block holds, for every lane ``4g + t`` of a warp,
the bytes of its ``mma.sync`` weight fragments in register order, so one
16-byte (bits 4) or two (bits 8) loads give a lane every weight it
multiplies in that block.  The warp computes ``yᵀ = Wᵀ xᵀ``: weight
columns are the MMA's rows (g and g + 8 of the 16).  Word s (k16 step s
of the block) of a lane holds, at bits 4, byte b = column g's nibble
(low) and column g + 8's (high); at bits 8, two words, column g's four
bytes then column g + 8's.  Byte b is k = 16s + 4t + b in ``frag_a8``
(four consecutive k a register, as the s8 MMA takes them) and k = 16s +
2t + 8(b >> 1) + (b & 1) in ``frag_a16`` (the bf16 MMA's pairs).  Scales
stay ``(K/group, N)``.  Every layout is an exact permutation:
:func:`unpack_weight` and :func:`dequantize_packed` read them all.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import quantize as Q

DEFAULT_BLOCK_K = 128
DEFAULT_BLOCK_N = 128


@dataclasses.dataclass
class PackedWeight:
    """Offline-packed quantized weight + metadata.

    data   : (Kt, Nt, bk_store, bn) int8 — tile-major; bk_store = bk/2 for
             int4 (two nibbles per byte along K), bk for int8 — or, with
             ``layout="frag_a16"`` / ``"frag_a8"``, (N/16, K/64, 32,
             4·bits) in a CUDA kernel's fragment order (module docstring).
    scales : (K//group, N) f32 per-group scales.
    """

    data: torch.Tensor
    scales: torch.Tensor
    bits: int
    group: int
    block_k: int
    block_n: int
    shape: Tuple[int, int]
    layout: str = "tile"

    def to(self, device) -> "PackedWeight":
        """The same packed weight with its tensors on ``device``."""
        return dataclasses.replace(self, data=self.data.to(device),
                                   scales=self.scales.to(device))


def _tile(q: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """(K, N) → (Kt, Nt, bk, bn) tile-major — paper step (ii)."""
    K, N = q.shape
    return q.reshape(K // bk, bk, N // bn, bn).permute(0, 2, 1, 3)


def _untile(t: torch.Tensor, K: int, N: int) -> torch.Tensor:
    return t.permute(0, 2, 1, 3).reshape(K, N)


def pack_weight(w: torch.Tensor, bits: int = 4, group: int = 128,
                block_k: int = DEFAULT_BLOCK_K,
                block_n: int = DEFAULT_BLOCK_N) -> PackedWeight:
    """Offline hardware-aware packing of a (K, N) weight matrix."""
    K, N = w.shape
    if K % block_k or N % block_n:
        raise ValueError(f"({K}, {N}) does not tile by ({block_k}, {block_n})")
    if block_k % group and group % block_k:
        raise ValueError(f"group={group} and block_k={block_k} do not nest")
    q, scales = Q.quantize_weight_grouped(w, bits=bits, group=group)
    tiles = _tile(q, block_k, block_n)                # (Kt, Nt, bk, bn)
    if bits == 4:
        tiles = Q.pack_int4(tiles, dim=2)             # (Kt, Nt, bk/2, bn)
    return PackedWeight(data=tiles.contiguous(), scales=scales.contiguous(),
                        bits=bits, group=group, block_k=block_k,
                        block_n=block_n, shape=(K, N))


#: K depth and column width of one fragment-order block
FRAG_K, FRAG_N = 64, 16
#: the fragment layouts, by the kernel that reads them
KERNEL_LAYOUTS = {"a16": "frag_a16", "a8": "frag_a8"}


def _steps(q: torch.Tensor, layout: str) -> torch.Tensor:
    """(K, N) → (c, s, t, b, ct, r, g): chunk, k16 step, lane t, byte b of
    the lane's word, column tile, row half, g — the logical element at each
    fragment position.  Within a step, byte b of lane t holds k = 4t + b
    (``frag_a8``: the s8 MMA's four consecutive k a register) or k = 2t +
    8 (b >> 1) + (b & 1) (``frag_a16``: the bf16 MMA's pairs 2t, 2t + 1
    and 2t + 8, 2t + 9)."""
    K, N = q.shape
    C, CT = K // FRAG_K, N // FRAG_N
    if layout == "frag_a8":
        return q.reshape(C, 4, 4, 4, CT, 2, 8)
    return q.reshape(C, 4, 2, 4, 2, CT, 2, 8).permute(
        0, 1, 3, 2, 4, 5, 6, 7).reshape(C, 4, 4, 4, CT, 2, 8)


def _unsteps(v: torch.Tensor, layout: str, K: int, N: int) -> torch.Tensor:
    """Inverse of :func:`_steps`."""
    if layout == "frag_a16":
        C, CT = K // FRAG_K, N // FRAG_N
        v = v.reshape(C, 4, 4, 2, 2, CT, 2, 8).permute(0, 1, 3, 2, 4, 5, 6, 7)
    return v.reshape(K, N)


def to_kernel_layout(p: PackedWeight, kernel: str) -> PackedWeight:
    """The same packed weight in the fragment order of the CUDA kernel
    ``kernel`` ("a16": ``mpgemm_a16``, "a8": ``mpgemm_int8``; module
    docstring), on ``p``'s device: an exact permutation of its values."""
    layout = KERNEL_LAYOUTS[kernel]
    if p.layout == layout:
        return p
    K, N = p.shape
    if K % FRAG_K or N % FRAG_N or p.bits not in (4, 8):
        raise ValueError(f"the CUDA GEMMs read weights in blocks of "
                         f"{FRAG_K} K x {FRAG_N} N: the fragment layout "
                         f"needs K % {FRAG_K} == 0, N % {FRAG_N} == 0 and "
                         f"bits 4 or 8 (got shape {p.shape}, block_k "
                         f"{p.block_k}, bits {p.bits})")
    v = _steps(unpack_weight(p), layout)            # (c, s, t, b, ct, r, g)
    if p.bits == 4:
        # (ct, c, g, t, s, b, r) → byte = column g's nibble | g+8's << 4
        v = v.permute(4, 0, 6, 2, 1, 3, 5).to(torch.int32)
        data = ((v[..., 0] & 0xF) | ((v[..., 1] & 0xF) << 4)) \
            .to(torch.uint8).view(torch.int8)
    else:
        # (ct, c, g, t, s, r, b): column g's word, then column g+8's
        data = v.permute(4, 0, 6, 2, 1, 5, 3)
    data = data.reshape(N // FRAG_N, K // FRAG_K, 32, 4 * p.bits)
    return dataclasses.replace(p, data=data.contiguous(), layout=layout)


def _unpack_frag(p: PackedWeight) -> torch.Tensor:
    """Fragment-order bytes → (K, N) int8-held values."""
    K, N = p.shape
    C, CT = K // FRAG_K, N // FRAG_N
    if p.bits == 4:
        # (ct, c, g, t, s, b): low nibble column g, high column g+8
        d = p.data.reshape(CT, C, 8, 4, 4, 4)
        v = Q.unpack_int4(d, dim=5).reshape(CT, C, 8, 4, 4, 4, 2)
    else:
        v = p.data.reshape(CT, C, 8, 4, 4, 2, 4).transpose(-1, -2)
    # (ct, c, g, t, s, b, r) → (c, s, t, b, ct, r, g)
    return _unsteps(v.permute(1, 4, 3, 5, 0, 6, 2), p.layout, K, N)


def unpack_weight(p: PackedWeight) -> torch.Tensor:
    """Inverse permutation of any layout → (K, N) int8-held values."""
    if p.layout != "tile":
        return _unpack_frag(p)
    t = p.data
    if p.bits == 4:
        t = Q.unpack_int4(t, dim=2)
    return _untile(t, *p.shape)


def dequantize_packed(p: PackedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """(K, N) ``bf16(q * scale)`` values (or ``dtype``) of a packed weight."""
    return Q.dequantize_weight_grouped(unpack_weight(p), p.scales,
                                       group=p.group, dtype=dtype)
