"""Hardware-aware weight packing (offline stage of the paper's GEMM pipeline).

Port of ``repro.core.packing``.  The layout is the JAX package's tile-major
one, byte for byte:

    (K, N) int4  →  data[K/bk, N/bn, bk/2, bn] int8, scales[K/group, N] f32

nibbles packed two per byte along the tile-local K axis (low nibble = even
k).  The Hopper GEMM (``csrc/mpgemm.cu``) reads one contiguous
``bk/2 × bn`` tile per K step.  A Hopper-native fragment layout (the
paper's §4.1 ldmatrix packing) is later work; its logical content must
still equal :func:`unpack_weight`.
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
             int4 (two nibbles per byte along K), bk for int8.
    scales : (K//group, N) f32 per-group scales.
    """

    data: torch.Tensor
    scales: torch.Tensor
    bits: int
    group: int
    block_k: int
    block_n: int
    shape: Tuple[int, int]

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


def unpack_weight(p: PackedWeight) -> torch.Tensor:
    """Inverse permutation → (K, N) int8-held values."""
    t = p.data
    if p.bits == 4:
        t = Q.unpack_int4(t, dim=2)
    return _untile(t, *p.shape)


def dequantize_packed(p: PackedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """(K, N) ``bf16(q * scale)`` values (or ``dtype``) of a packed weight."""
    return Q.dequantize_weight_grouped(unpack_weight(p), p.scales,
                                       group=p.group, dtype=dtype)
