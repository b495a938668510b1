"""Hardware-aware weight packing (offline stage of the paper's GEMM pipeline).

Port of ``repro.core.packing``, with its helpers for calibrated weights
(:func:`pack_prequantized`) and the row-major baseline layout
(:class:`UnpackedWeight`).  The layout is the JAX package's tile-major
one, byte for byte:

    (K, N) int4  →  data[K/bk, N/bn, bk/2, bn] int8, scales[K/group, N] f32

nibbles packed two per byte along the tile-local K axis (low nibble = even
k).  :func:`pack_weight` produces it on every device, so the CPU keeps the
JAX package's bytes.

The CUDA GEMMs (``csrc/gemm_tile.cuh``) take other layouts of the same
values, the paper's §4.1 fragment order, one per kernel, made by
:func:`to_kernel_layout` (``layout="frag_a16"`` for ``mpgemm_a16``,
``"frag_a8"`` for ``mpgemm_int8``)::

    data[N/16, ceil(K/64), 32 lanes, 4·bits] int8

A K of 32 times an odd number (group 32, the Pallas GEMMs' smallest
block_k) lays out ceil(K/64) blocks, the last one's missing 32 K rows
holding zero codes; ``shape`` stays (K, N), the scales (K/32, N), and
unpacking drops the padding.

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

A stack of same-shape weights (a MoE layer's (E, K, N) experts) packs
member by member (:func:`pack_stack`): the bytes ``jax.vmap(pack_weight)``
gives, one PackedWeight with a leading E axis on ``data`` and ``scales``.
:func:`to_kernel_layout` lays a stack out member by member too, so that
member e (``p[e]``) is a contiguous fragment-order weight that the A16
GEMM takes as it is: the MoE layer runs each routed expert's products
through the kernel on the card (``models.moe``).
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
             ``layout="frag_a16"`` / ``"frag_a8"``, (N/16, ceil(K/64),
             32, 4·bits) in a CUDA kernel's fragment order (module
             docstring).
    scales : (K//group, N) f32 per-group scales.

    A stack (:func:`pack_stack`) carries a leading E axis on both, in
    either layout; ``shape`` stays the members' (K, N) and ``p[e]`` is
    member e.
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

    @property
    def storage_bytes(self) -> int:
        """Bytes of the packed values and their scales: ``K·N·bits/8 +
        (K/group)·N·4`` a member, the same in every layout, except that a
        fragment layout of a K of 32 × odd holds its last block's 32 zero
        K rows too."""
        return self.data.numel() * self.data.element_size() + \
            self.scales.numel() * self.scales.element_size()

    @property
    def stacked(self) -> bool:
        """True for a stack of weights (a leading E axis)."""
        return self.scales.dim() == 3

    @property
    def n_members(self) -> int:
        """Members of a stack (1 for a single weight)."""
        return self.scales.shape[0] if self.stacked else 1

    def __getitem__(self, e: int) -> "PackedWeight":
        """Member ``e`` of a stack (views of its tensors)."""
        if not self.stacked:
            raise TypeError("a single packed weight has no members")
        return dataclasses.replace(self, data=self.data[e],
                                   scales=self.scales[e])


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


def pack_prequantized(q: torch.Tensor, scales: torch.Tensor, bits: int,
                      group: int = 128, block_k: int = DEFAULT_BLOCK_K,
                      block_n: int = DEFAULT_BLOCK_N) -> PackedWeight:
    """Pack already-quantized (K, N) int values (AWQ / GPTQ calibration,
    :mod:`repro_torch.core.calibration`) with their (K/group, N) scales
    into the tile-major layout; :func:`to_kernel_layout` then takes it to
    a kernel's fragment order like any packed weight."""
    K, N = q.shape
    if K % block_k or N % block_n:
        raise ValueError(f"({K}, {N}) does not tile by ({block_k}, {block_n})")
    tiles = _tile(q.to(torch.int8), block_k, block_n)
    if bits == 4:
        tiles = Q.pack_int4(tiles, dim=2)
    return PackedWeight(data=tiles.contiguous(), scales=scales.contiguous(),
                        bits=bits, group=group, block_k=block_k,
                        block_n=block_n, shape=(K, N))


def pack_stack(w: torch.Tensor, bits: int = 4, group: int = 128,
               block_k: int = DEFAULT_BLOCK_K,
               block_n: int = DEFAULT_BLOCK_N) -> PackedWeight:
    """Pack an (E, K, N) stack member by member (one (K, N) matrix's f32
    transients at a time) into one stacked PackedWeight.  A stack with no
    values (meta or fake tensors: the dry-run's stand-ins) packs its first
    member and repeats its shapes: every member's are the same."""
    if w.device.type == "meta" or _is_fake(w):
        m = pack_weight(w[0].float(), bits=bits, group=group,
                        block_k=block_k, block_n=block_n)
        E = w.shape[0]
        return dataclasses.replace(
            m, data=m.data[None].expand((E,) + tuple(m.data.shape)).clone(),
            scales=m.scales[None].expand((E,) + tuple(m.scales.shape))
            .clone())
    members = [pack_weight(m.float(), bits=bits, group=group, block_k=block_k,
                           block_n=block_n) for m in w.unbind(0)]
    return dataclasses.replace(
        members[0], data=torch.stack([m.data for m in members]),
        scales=torch.stack([m.scales for m in members]))


def _is_fake(t: torch.Tensor) -> bool:
    """True for a ``FakeTensor`` (shapes and dtypes, no storage)."""
    return type(t).__name__ == "FakeTensor"


#: K depth and column width of one fragment-order block
FRAG_K, FRAG_N = 64, 16
#: the fragment layouts, by the kernel that reads them
KERNEL_LAYOUTS = {"a16": "frag_a16", "a8": "frag_a8"}


def frag_chunks(K: int) -> int:
    """64-deep blocks of a fragment layout: ceil(K / 64)."""
    return -(-K // FRAG_K)


def _steps(q: torch.Tensor, layout: str) -> torch.Tensor:
    """(K, N), K a multiple of 64 → (c, s, t, b, ct, r, g): chunk, k16
    step, lane t, byte b of the lane's word, column tile, row half, g —
    the logical element at each fragment position.  Within a step, byte
    b of lane t holds k = 4t + b
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
    docstring), on ``p``'s device: an exact permutation of its values.  A
    stack is laid out member by member into one (E, N/16, ceil(K/64), 32,
    4·bits) tensor (one member's transients at a time); its scales are
    kept."""
    layout = KERNEL_LAYOUTS[kernel]
    if p.layout == layout:
        return p
    if p.stacked:
        first = to_kernel_layout(p[0], kernel).data
        data = first.new_empty((p.n_members,) + tuple(first.shape))
        data[0] = first
        for e in range(1, p.n_members):
            data[e] = to_kernel_layout(p[e], kernel).data
        return dataclasses.replace(p, data=data, layout=layout)
    K, N = p.shape
    tail = K % FRAG_K == 32 and p.group == 32
    if (K % FRAG_K and not tail) or N % FRAG_N or p.bits not in (4, 8):
        raise ValueError(f"the CUDA GEMMs read weights in blocks of "
                         f"{FRAG_K} K x {FRAG_N} N: the fragment layout "
                         f"needs K % {FRAG_K} == 0 (or 32 at group 32), "
                         f"N % {FRAG_N} == 0 and "
                         f"bits 4 or 8 (got shape {p.shape}, block_k "
                         f"{p.block_k}, bits {p.bits})")
    q = unpack_weight(p)
    Kp = frag_chunks(K) * FRAG_K
    if Kp != K:                      # the last block's 32 rows: zero codes
        q = torch.cat([q, q.new_zeros((Kp - K, N))])
    v = _steps(q, layout)                           # (c, s, t, b, ct, r, g)
    if p.bits == 4:
        # (ct, c, g, t, s, b, r) → byte = column g's nibble | g+8's << 4
        v = v.permute(4, 0, 6, 2, 1, 3, 5).to(torch.int32)
        data = ((v[..., 0] & 0xF) | ((v[..., 1] & 0xF) << 4)) \
            .to(torch.uint8).view(torch.int8)
    else:
        # (ct, c, g, t, s, r, b): column g's word, then column g+8's
        data = v.permute(4, 0, 6, 2, 1, 5, 3)
    data = data.reshape(N // FRAG_N, Kp // FRAG_K, 32, 4 * p.bits)
    return dataclasses.replace(p, data=data.contiguous(), layout=layout)


def _unpack_frag(p: PackedWeight) -> torch.Tensor:
    """Fragment-order bytes → (K, N) int8-held values (a tail block's
    zero rows dropped)."""
    K, N = p.shape
    C, CT = frag_chunks(K), N // FRAG_N
    if p.bits == 4:
        # (ct, c, g, t, s, b): low nibble column g, high column g+8
        d = p.data.reshape(CT, C, 8, 4, 4, 4)
        v = Q.unpack_int4(d, dim=5).reshape(CT, C, 8, 4, 4, 4, 2)
    else:
        v = p.data.reshape(CT, C, 8, 4, 4, 2, 4).transpose(-1, -2)
    # (ct, c, g, t, s, b, r) → (c, s, t, b, ct, r, g)
    return _unsteps(v.permute(1, 4, 3, 5, 0, 6, 2), p.layout, C * FRAG_K,
                    N)[:K]


def unpack_weight(p: PackedWeight) -> torch.Tensor:
    """Inverse permutation of any layout → (K, N) int8-held values
    ((E, K, N) for a stack)."""
    if p.stacked:
        return torch.stack([unpack_weight(p[e]) for e in range(p.n_members)])
    if p.layout != "tile":
        return _unpack_frag(p)
    t = p.data
    if p.bits == 4:
        t = Q.unpack_int4(t, dim=2)
    return _untile(t, *p.shape)


def dequantize_packed(p: PackedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """(K, N) ``bf16(q * scale)`` values (or ``dtype``) of a packed weight;
    (E, K, N) for a stack, dequantized member by member into one tensor."""
    if p.stacked:
        out = torch.empty((p.n_members,) + tuple(p.shape), dtype=dtype,
                          device=p.data.device)
        for e in range(p.n_members):
            out[e] = dequantize_packed(p[e], dtype)
        return out
    return Q.dequantize_weight_grouped(unpack_weight(p), p.scales,
                                       group=p.group, dtype=dtype)


# -- the unpacked baseline layout ---------------------------------------------
# Stored row-major exactly as the quantizer emits it (int4 two per byte
# along K); a kernel reading it would do the re-layout itself.


@dataclasses.dataclass
class UnpackedWeight:
    """Row-major quantized weight: data (K (/2 at int4), N) int8, scales
    (K/group, N) f32."""

    data: torch.Tensor
    scales: torch.Tensor
    bits: int
    group: int
    shape: Tuple[int, int]


def quantize_rowmajor(w: torch.Tensor, bits: int = 4,
                      group: int = 128) -> UnpackedWeight:
    """Quantize (K, N) per (group, column) and keep the row-major order."""
    q, scales = Q.quantize_weight_grouped(w, bits=bits, group=group)
    if bits == 4:
        q = Q.pack_int4(q, dim=0)
    return UnpackedWeight(data=q, scales=scales, bits=bits, group=group,
                          shape=tuple(w.shape))


def unpack_rowmajor(u: UnpackedWeight) -> torch.Tensor:
    """(K, N) int8-held values of a row-major quantized weight."""
    return Q.unpack_int4(u.data, dim=0) if u.bits == 4 else u.data
