"""Quantized KV cache: the dense slab backend.

Port of ``repro.core.kvcache``.  Layout (per layer): ``k``/``v`` are
``(B, S, H, Dstore)`` — kv4 nibble-packs head_dim two values per byte
(``Dstore = D/2``) — with per-(token, head) f32 scales ``(B, S, H)``.
Deliberate differences from the JAX package, the same as the paged pool's
(``core/paged_kvcache.py``):

* **One stacked slab.**  Tensors carry a leading layer axis;
  :meth:`KVCache.layer` returns a per-layer view sharing storage.  The
  scales drop the JAX package's trailing unit axis.
* **In-place appends** (``index_copy_`` on the kept rows): the slab is the
  engine's resident state, and JAX's immutable update has no need here.
* No advisory ``length`` counter: the engine's host-side positions are the
  frontier, and attention masks by position.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import quantize as Q
from .precision import FormatSpec


def store_dim(head_dim: int, spec: FormatSpec) -> int:
    """Stored last-axis width: kv4 packs head_dim two values per byte."""
    return head_dim // 2 if spec.packed else head_dim


@dataclasses.dataclass
class KVCache:
    """Dense per-slot KV slab; shape-derived properties read the trailing
    axes, so they hold for stacked and per-layer instances alike."""

    k: torch.Tensor            # ([L,] B, S, H, Dstore)
    v: torch.Tensor            # ([L,] B, S, H, Dstore)
    k_scale: torch.Tensor      # ([L,] B, S, H) f32
    v_scale: torch.Tensor      # ([L,] B, S, H) f32

    @property
    def max_seq(self) -> int:
        """Tokens of context per slot."""
        return self.k.shape[-3]

    def layer(self, i: int) -> "KVCache":
        """Per-layer view of a stacked cache (shares storage)."""
        return KVCache(k=self.k[i], v=self.v[i], k_scale=self.k_scale[i],
                       v_scale=self.v_scale[i])


def init_cache(batch: int, max_seq: int, kv_heads: int, head_dim: int,
               spec: FormatSpec, *, n_layers: int = 1,
               device="cuda") -> KVCache:
    """Zero slab and unit scales, stacked over ``n_layers``."""
    shape = (n_layers, batch, max_seq, kv_heads, store_dim(head_dim, spec))
    return KVCache(
        k=torch.zeros(shape, dtype=spec.dtype, device=device),
        v=torch.zeros(shape, dtype=spec.dtype, device=device),
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device),
    )


def scatter_rows(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                 spec: FormatSpec, src: torch.Tensor, dst: torch.Tensor
                 ) -> None:
    """Quantize the (B, T) update and copy its rows ``src`` to the flat
    rows ``dst`` of a per-layer store, in place: a slab ``(B, S, ...)`` or
    a paged pool ``(n_blocks, block_size, ...)`` flattens the same way.
    K and V quantize as one stacked tensor (per-(token, head) math, so the
    bytes are those of two separate calls, in half the launches)."""
    B, T, H = k_new.shape[:3]
    q, s = Q.quantize_kv(torch.stack([k_new, v_new]), spec)
    q = q.reshape(2, B * T, H, q.shape[-1]).index_select(1, src)
    s = s.reshape(2, B * T, H).index_select(1, src)
    if q.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
        q = q.view(torch.uint8)            # index_copy_ takes no fp8
    for buf, val in ((cache.k, q[0]), (cache.v, q[1]),
                     (cache.k_scale, s[0]), (cache.v_scale, s[1])):
        buf = buf.view(val.dtype)
        buf.view((-1,) + tuple(buf.shape[2:])).index_copy_(0, dst, val)


def append(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
           pos: int, spec: FormatSpec) -> KVCache:
    """Quantize and write ``T`` new tokens at position ``pos``, the same for
    every slot, into a per-layer cache.  Like JAX's
    ``dynamic_update_slice``, a start that would overrun the slab is
    clamped to ``S - T``.  k_new/v_new: (B, T, H, D)."""
    B, T = k_new.shape[:2]
    S = cache.max_seq
    start = min(max(int(pos), 0), S - T)
    dev = k_new.device
    dst = (torch.arange(B, device=dev)[:, None] * S + start
           + torch.arange(T, device=dev)[None]).reshape(-1)
    scatter_rows(cache, k_new, v_new, spec, torch.arange(B * T, device=dev),
                 dst)
    return cache


def write_rows(cache: KVCache, pos: torch.Tensor, T: int,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where a ragged per-slot append of ``T`` tokens lands: the surviving
    rows of the flattened ``(B*T)`` update and their flat slab rows
    ``b*S + pos[b] + t``.  Rows past ``valid[b]`` or past ``S`` are
    dropped (JAX's ``mode="drop"`` scatter), never clamped onto a live
    cell.  The same for every layer; the filter reads the device mask back
    (one sync)."""
    B, S = pos.shape[0], cache.max_seq
    t = torch.arange(T, device=pos.device)
    tok = pos.long()[:, None] + t[None]
    keep = tok < S
    if valid is not None:
        keep &= t[None] < valid.long()[:, None]
    flat = torch.arange(B, device=pos.device)[:, None] * S + tok
    src = torch.nonzero(keep.reshape(B * T)).reshape(-1)
    return src, flat.reshape(B * T)[src]


def append_per_slot(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    pos: torch.Tensor, spec: FormatSpec,
                    valid: Optional[torch.Tensor] = None,
                    rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> KVCache:
    """Ragged append into a per-layer cache: slot ``b`` quantizes and
    writes its ``T`` new tokens at ``pos[b] + t``, in place; ``valid``
    ((B,) int, optional) keeps only each slot's first ``valid[b]`` tokens.
    ``rows`` is a precomputed :func:`write_rows` result for these
    arguments.  Same quantization and drop rule as the JAX package, bit
    for bit."""
    if rows is None:
        rows = write_rows(cache, pos, k_new.shape[1], valid)
    scatter_rows(cache, k_new, v_new, spec, *rows)
    return cache
