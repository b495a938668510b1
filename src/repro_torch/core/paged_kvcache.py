"""Paged quantized KV cache: block-pool storage + per-slot block tables.

Port of the parts of ``repro.core.paged_kvcache`` the reservation engine
uses.  Layout differences from the JAX package, all deliberate:

* **One stacked pool.**  ``k``/``v`` are ``(L, n_blocks, block_size, H,
  Dstore)`` and the scales ``(L, n_blocks, block_size, H)`` f32 (the JAX
  package's trailing unit axis is dropped).  :meth:`PagedKVCache.layer`
  returns a per-layer view whose tensors share storage with the stack.
* **One block table** ``(n_slots, blocks_per_slot)`` int32 shared by every
  layer — the JAX package replicates the same table per layer so its layer
  scan can slice it; a Python loop over layers needs no copy.  Unmapped
  entries hold the sentinel ``n_blocks``.
* **In-place appends.**  :func:`append_paged` writes the pool in place
  (JAX arrays are immutable; here the pool is the engine's resident state).
* No advisory ``length`` counter: the engine's host-side positions are the
  frontier, and attention masks by position.

``PrefixIndex``, ``copy_block``, ``gather_view`` and the allocator's
CACHED/shared states come with prefix sharing (ROADMAP queue 1 item 3).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .kvcache import scatter_rows, store_dim
from .precision import FormatSpec


@dataclasses.dataclass
class PagedKVCache:
    """Block-pooled quantized KV storage plus per-slot block tables.

    Stacked instances carry a leading layer axis on ``k``/``v``/scales;
    :meth:`layer` views one layer.  Shape-derived properties read the
    trailing axes, so they hold for stacked and per-layer instances alike.
    """

    k: torch.Tensor            # ([L,] n_blocks, block_size, H, Dstore)
    v: torch.Tensor            # ([L,] n_blocks, block_size, H, Dstore)
    k_scale: torch.Tensor      # ([L,] n_blocks, block_size, H) f32
    v_scale: torch.Tensor      # ([L,] n_blocks, block_size, H) f32
    block_table: torch.Tensor  # (n_slots, blocks_per_slot) int32

    @property
    def n_blocks(self) -> int:
        """Pool blocks (the block-table sentinel value is ``n_blocks``)."""
        return self.k.shape[-4]

    @property
    def block_size(self) -> int:
        """Tokens per pool block."""
        return self.k.shape[-3]

    @property
    def n_slots(self) -> int:
        """Decode slots (block-table rows)."""
        return self.block_table.shape[0]

    @property
    def blocks_per_slot(self) -> int:
        """Logical blocks each slot's table row can map."""
        return self.block_table.shape[1]

    @property
    def max_context(self) -> int:
        """Longest per-slot context the block table can map."""
        return self.blocks_per_slot * self.block_size

    def layer(self, i: int) -> "PagedKVCache":
        """Per-layer view of a stacked cache (shares storage)."""
        return PagedKVCache(k=self.k[i], v=self.v[i], k_scale=self.k_scale[i],
                            v_scale=self.v_scale[i],
                            block_table=self.block_table)


class OutOfBlocksError(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free pool."""


class BlockAllocator:
    """Host-side refcounted free-list allocator over ``n_blocks`` blocks.

    The reservation engine's subset of the JAX allocator: blocks are FREE
    or LIVE (refcount >= 1).  Same invariants — a block is never handed out
    twice while LIVE, ``free`` rejects double frees, ``alloc`` raises
    :class:`OutOfBlocksError` rather than over-commit — and the same
    hand-out order (lowest block id first).
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = int(n_blocks)
        self.reset()

    def reset(self) -> None:
        """Return every block to the FREE state."""
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._peak_live: int = 0

    @property
    def free_count(self) -> int:
        """Blocks on the free list."""
        return len(self._free)

    @property
    def live_count(self) -> int:
        """Blocks with refcount >= 1."""
        return len(self._ref)

    @property
    def peak_live(self) -> int:
        """High-water mark of :attr:`live_count` since construction/reset."""
        return self._peak_live

    @property
    def available(self) -> int:
        """Blocks an ``alloc`` could hand out."""
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        """True when ``alloc(n)`` would succeed."""
        return n <= self.available

    def refcount(self, block: int) -> int:
        """Current reference count of ``block`` (0 when free)."""
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> List[int]:
        """Hand out ``n`` private blocks, each at refcount 1."""
        if n > self.available:
            raise OutOfBlocksError(
                f"requested {n} blocks, {len(self._free)} free of "
                f"{self.n_blocks}")
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self._ref[b] = 1
        self._peak_live = max(self._peak_live, len(self._ref))
        return blocks

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; refcount-0 blocks return FREE."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"block {b} is not allocated (double free?)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """Blocks covering ``n_tokens`` tokens (at least one)."""
    return max(1, -(-int(n_tokens) // int(block_size)))


def init_paged(n_slots: int, n_blocks: int, block_size: int, kv_heads: int,
               head_dim: int, spec: FormatSpec,
               blocks_per_slot: Optional[int] = None, *, n_layers: int = 1,
               device="cuda") -> PagedKVCache:
    """Zero pool, unit scales and an all-sentinel block table, stacked over
    ``n_layers``."""
    ds = store_dim(head_dim, spec)
    bps = blocks_per_slot if blocks_per_slot is not None else \
        blocks_needed(n_blocks * block_size, block_size)
    shape = (n_layers, n_blocks, block_size, kv_heads, ds)
    sshape = shape[:-1]
    return PagedKVCache(
        k=torch.zeros(shape, dtype=spec.dtype, device=device),
        v=torch.zeros(shape, dtype=spec.dtype, device=device),
        k_scale=torch.ones(sshape, dtype=torch.float32, device=device),
        v_scale=torch.ones(sshape, dtype=torch.float32, device=device),
        block_table=torch.full((n_slots, bps), n_blocks, dtype=torch.int32,
                               device=device),
    )


def _flat_indices(cache: PagedKVCache, tok: torch.Tensor) -> torch.Tensor:
    """Logical per-slot token positions (B, T) → flat pool rows (B, T).

    Positions mapped by a sentinel (or beyond the table) come back as
    ``n_blocks * block_size`` — one past the flattened pool.
    """
    bs, nb, bps = cache.block_size, cache.n_blocks, cache.blocks_per_slot
    tok = tok.long()
    bidx = tok // bs
    safe = bidx.clamp(0, bps - 1)
    blk = torch.gather(cache.block_table.long(), 1, safe)
    blk = torch.where(bidx < bps, blk, nb)
    return torch.where(blk < nb, blk * bs + tok % bs, nb * bs)


def write_rows(cache: PagedKVCache, pos: torch.Tensor, T: int,
               valid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where a ragged append of ``T`` tokens per slot lands.

    Returns ``(src, dst)``: the surviving rows of the flattened ``(B*T)``
    update and their flat pool rows.  Rows past ``valid[b]`` and rows
    mapped by a sentinel are *filtered out* here — PyTorch has no
    drop-mode scatter, and clamping them would dirty a live cell.  The
    result is the same for every layer (one table), so a decode step
    computes it once; the filter reads the device mask back (one sync).
    """
    B = pos.shape[0]
    t = torch.arange(T, device=pos.device)
    flat = _flat_indices(cache, pos.long()[:, None] + t[None])
    keep = flat < cache.n_blocks * cache.block_size
    if valid is not None:
        keep &= t[None] < valid.long()[:, None]
    keep = keep.reshape(B * T)
    src = torch.nonzero(keep).reshape(-1)
    return src, flat.reshape(B * T)[src]


def append_paged(cache: PagedKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, pos: torch.Tensor, spec: FormatSpec,
                 valid: Optional[torch.Tensor] = None,
                 rows: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> PagedKVCache:
    """Ragged append through the block table into a *per-layer* cache:
    slot ``b`` quantizes and writes its ``T`` new tokens at logical
    positions ``pos[b] + t``, in place.

    k_new/v_new: (B, T, H, D) compute dtype; pos: (B,) int.  ``valid``
    ((B,) int, optional) keeps only each slot's first ``valid[b]`` tokens.
    ``rows`` is a precomputed :func:`write_rows` result for these
    arguments.  Same quantization as the JAX package, bit for bit.
    """
    if rows is None:
        rows = write_rows(cache, pos, k_new.shape[1], valid)
    scatter_rows(cache, k_new, v_new, spec, *rows)
    return cache

