"""Paged quantized KV cache: block-pool storage + per-slot block tables.

Port of ``repro.core.paged_kvcache`` for the kernel engines: the pool, the
refcounted allocator with its FREE / LIVE / CACHED lifecycle, the
content-addressed :class:`PrefixIndex` and the copy-on-write
:func:`copy_block` of prefix sharing.  Layout differences from the JAX
package, all deliberate:

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
* :func:`copy_block` copies in place, over every layer of the stack.

:func:`gather_view` / :func:`live_ctx` build the transient dense view of
the ``attn_impl="xla"`` opt-out (``models.common.attend_decode``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trace

from .kvcache import KVCache, scatter_rows, store_dim
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

    Every pool block is in exactly one of three states:

    * **FREE** — on the free list, content meaningless.
    * **LIVE** — refcount >= 1: mapped into one or more slots' block
      tables.  ``alloc`` creates a LIVE block with one reference;
      ``share`` takes another (prefix sharing maps one physical block into
      several tables); ``free`` drops one.
    * **CACHED** — refcount 0 but retained: the block was marked cacheable
      (its content is published in a :class:`PrefixIndex`), so the last
      ``free`` parked it on an LRU list instead of the free list.
      ``share`` revives it (a prefix hit); ``alloc`` evicts from the LRU
      head when the free list runs dry, calling ``on_evict`` so the index
      drops the dead entry.

    The JAX allocator's invariants and hand-out order, step for step: a
    block is never handed out twice while LIVE or CACHED, ``free`` rejects
    double frees, ``alloc`` raises :class:`OutOfBlocksError` rather than
    over-commit (taking nothing), eviction touches only CACHED blocks, and
    the free list hands out the lowest block id first.
    """

    def __init__(self, n_blocks: int,
                 on_evict: Optional[Callable[[int], None]] = None):
        """An all-free pool; ``on_evict(block)`` is called when a CACHED
        block is evicted to satisfy an ``alloc``."""
        self.n_blocks = int(n_blocks)
        self.on_evict = on_evict
        self.reset()

    def reset(self) -> None:
        """Return every block to the FREE state and clear all refcounts."""
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self._cacheable: set = set()
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        self._peak_live: int = 0

    @property
    def free_count(self) -> int:
        """Strictly free blocks (CACHED ones excluded)."""
        return len(self._free)

    @property
    def cached_count(self) -> int:
        """Refcount-0 blocks retained for prefix reuse (evictable)."""
        return len(self._cached)

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
        """Blocks an ``alloc`` could hand out: FREE plus evictable."""
        return len(self._free) + len(self._cached)

    def can_alloc(self, n: int) -> bool:
        """True when ``alloc(n)`` would succeed (possibly by eviction)."""
        return n <= self.available

    def refcount(self, block: int) -> int:
        """Current reference count of ``block`` (0 when FREE or CACHED)."""
        return self._ref.get(block, 0)

    def alloc(self, n: int) -> List[int]:
        """Hand out ``n`` private blocks, each at refcount 1: the free list
        first, then the least recently used CACHED blocks (``on_evict``
        called for each)."""
        if n > self.available:
            raise OutOfBlocksError(
                f"requested {n} blocks, {len(self._free)} free + "
                f"{len(self._cached)} cached of {self.n_blocks}")
        blocks = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._cached.popitem(last=False)     # LRU eviction
                self._cacheable.discard(b)
                if self.on_evict is not None:
                    self.on_evict(b)
            self._ref[b] = 1
            blocks.append(b)
        self._peak_live = max(self._peak_live, len(self._ref))
        return blocks

    def share(self, block: int) -> None:
        """One more reference on a LIVE block, or revive a CACHED block to
        LIVE (refcount 1).  Raises ``ValueError`` for a FREE block."""
        if block in self._ref:
            self._ref[block] += 1
        elif block in self._cached:
            del self._cached[block]
            self._ref[block] = 1
            self._peak_live = max(self._peak_live, len(self._ref))
        else:
            raise ValueError(
                f"block {block} is neither live nor cached (share of a "
                "free block?)")

    def set_cacheable(self, block: int) -> None:
        """Mark a LIVE block prefix-cacheable: at refcount 0 it parks on
        the CACHED LRU instead of the free list."""
        if block not in self._ref:
            raise ValueError(f"block {block} is not live")
        self._cacheable.add(block)

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per block; at refcount 0 a cacheable block
        parks on the CACHED LRU (most recently used end), any other
        returns FREE.  Rejects blocks that are not LIVE (double free)."""
        for b in blocks:
            if b not in self._ref:
                raise ValueError(f"block {b} is not allocated (double free?)")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._cacheable:
                    self._cached[b] = None
                else:
                    self._free.append(b)


class PrefixIndex:
    """Content-addressed index of immutable, block-aligned prefix KV.

    Maps the chain hash of ``(salt, token ids of blocks 0..j)`` to the pool
    block holding block ``j``'s KV.  Block ``j``'s hash folds in block
    ``j - 1``'s, so an entry identifies the whole prefix; matching walks the
    chain and stops at the first miss.  The hash is the JAX package's, byte
    for byte: SHA-256 chained from ``sha256(salt)``, each block's token ids
    as little-endian int64.

    ``salt`` binds what besides the token ids fixes a block's bytes (the KV
    format, the layer set and head geometry a pool block spans).  The
    index holds host-side ids only; the allocator owns block lifetime, and
    :meth:`drop_block` is its ``on_evict`` callback.
    """

    def __init__(self, block_size: int, salt: str = ""):
        """Index full blocks of ``block_size`` tokens under ``salt``."""
        self.block_size = int(block_size)
        self._salt = hashlib.sha256(salt.encode()).digest()
        self._by_hash: Dict[bytes, int] = {}
        self._by_block: Dict[int, bytes] = {}

    def __len__(self) -> int:
        """Number of indexed blocks."""
        return len(self._by_hash)

    def chain_hashes(self, tokens: Sequence[int]) -> List[bytes]:
        """Chain hash of every full block-aligned prefix of ``tokens``:
        entry ``j`` keys tokens ``[0, (j + 1) * block_size)``."""
        bs = self.block_size
        out, h = [], self._salt
        for j in range(len(tokens) // bs):
            m = hashlib.sha256(h)
            m.update(np.asarray(tokens[j * bs:(j + 1) * bs],
                                "<i8").tobytes())
            h = m.digest()
            out.append(h)
        return out

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Pool blocks of the longest indexed chain covering a
        block-aligned prefix of ``tokens``, in logical order (possibly
        empty).  Refcounts are untouched: callers pin with ``share``."""
        return self.match_chain(self.chain_hashes(tokens))

    def match_chain(self, hashes: Sequence[bytes]) -> List[int]:
        """:meth:`match` over precomputed :meth:`chain_hashes`."""
        blocks = []
        for h in hashes:
            b = self._by_hash.get(h)
            if b is None:
                break
            blocks.append(b)
        return blocks

    def register(self, chain_hash: bytes, block: int) -> bool:
        """Publish ``block`` as the holder of ``chain_hash``'s KV.  False
        (a no-op) when the hash is already served — first writer wins, the
        duplicate stays private — or the block already serves a hash."""
        if chain_hash in self._by_hash or block in self._by_block:
            return False
        self._by_hash[chain_hash] = block
        self._by_block[block] = chain_hash
        return True

    def drop_block(self, block: int) -> None:
        """Forget ``block`` (the allocator's eviction callback);
        idempotent."""
        h = self._by_block.pop(block, None)
        if h is not None:
            del self._by_hash[h]


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
    computes it once; the filter reads the device mask back (one sync,
    counted in ``repro_torch.trace.host_syncs``).
    """
    B = pos.shape[0]
    t = torch.arange(T, device=pos.device)
    flat = _flat_indices(cache, pos.long()[:, None] + t[None])
    keep = flat < cache.n_blocks * cache.block_size
    if valid is not None:
        keep &= t[None] < valid.long()[:, None]
    keep = keep.reshape(B * T)
    src = torch.nonzero(keep).reshape(-1)
    trace.sync()
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



def copy_block(cache: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy pool block ``src``'s K/V bytes and both scales to ``dst``, in
    place, on every layer of a stacked cache (or one per-layer view).

    The device half of copy-on-write: a slot that would append into a
    shared block gets a private ``dst`` holding the shared block's
    already-quantized bytes — no requantization, so the copy is bitwise a
    cold prefill's.  Tables are untouched.  Plain tensor indexing, as the
    JAX package's is XLA outside any kernel."""
    for t, axis in ((cache.k, -4), (cache.v, -4), (cache.k_scale, -3),
                    (cache.v_scale, -3)):
        if t.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
            t = t.view(torch.uint8)
        ax = t.dim() + axis
        t.select(ax, int(dst)).copy_(t.select(ax, int(src)))
    return cache


def live_ctx(cache: PagedKVCache, max_live: Optional[int] = None) -> int:
    """Live-context bound in tokens for :func:`gather_view`: ``max_live``
    (the engine's ``max(position) + 1`` over running slots) rounded up to
    whole blocks and clipped to ``max_context``; without it, the whole
    ``max_context`` (the port keeps no advisory length counter)."""
    if max_live is None:
        return cache.max_context
    bs = cache.block_size
    return min(blocks_needed(max_live, bs) * bs, cache.max_context)


def gather_view(cache: PagedKVCache, n_ctx: Optional[int] = None) -> KVCache:
    """A dense ``(n_slots, n_ctx, H, Dstore)`` view of every slot's first
    ``n_ctx`` logical tokens, gathered from a per-layer pool through the
    block table (a new tensor; the pool stays the resident state).
    Unmapped positions and columns past the table clamp to the pool's
    last element: finite values the caller's causal mask turns into exact
    zeros."""
    bs = cache.block_size
    n_ctx = cache.max_context if n_ctx is None else n_ctx
    if n_ctx % bs:
        raise ValueError(f"n_ctx={n_ctx} is not a multiple of block_size={bs}")
    nbp = min(n_ctx // bs, cache.blocks_per_slot)
    tbl = cache.block_table[:, :nbp].long()
    flat = (tbl[:, :, None] * bs + torch.arange(bs, device=tbl.device)
            ).reshape(cache.n_slots, nbp * bs)
    if nbp * bs < n_ctx:       # table shorter than the view: clamp-pad
        flat = torch.nn.functional.pad(flat, (0, n_ctx - nbp * bs))
    n_tok = cache.n_blocks * bs
    flat = flat.clamp(0, n_tok - 1).reshape(-1)

    def gath(pool: torch.Tensor) -> torch.Tensor:
        rows = pool.reshape((n_tok,) + tuple(pool.shape[2:]))[flat]
        return rows.reshape((cache.n_slots, n_ctx) + tuple(pool.shape[2:]))

    return KVCache(k=gath(cache.k), v=gath(cache.v),
                   k_scale=gath(cache.k_scale), v_scale=gath(cache.v_scale))


def cache_leaves(cache) -> List[torch.Tensor]:
    """Every tensor of a cache dataclass (slab, pool, recurrent state),
    nested caches included, in field order."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    return [t for f in dataclasses.fields(cache)
            for t in cache_leaves(getattr(cache, f.name))]


def kv_bytes(cache) -> int:
    """Resident bytes of a decode state: the sum of ``numel ·
    element_size`` over its leaves — a pool (+ scales + its one block
    table), a slab (+ scales) or a recurrent state alike.
    ``Engine.kv_resident_bytes`` reports this number.

    It counts the tensors the port holds, no more, so it differs from
    ``repro.core.paged_kvcache.kv_bytes`` exactly where the layouts do
    (module docstring): a stacked slab by the reference's ``(L, B)`` int32
    ``length`` leaf, ``4·L·B`` bytes; a stacked pool by the reference's
    per-layer copies of the block table and its ``(L, n_slots)`` int32
    ``length``, ``(L − 1)·table bytes + 4·L·n_slots`` bytes.  Pools,
    slabs and scales themselves count the same bytes in both packages
    (the scales' dropped unit axis holds no bytes)."""
    return int(sum(t.numel() * t.element_size() for t in cache_leaves(cache)))
