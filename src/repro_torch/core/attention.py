"""Attention outside the serving kernels: prefill, one-shot-family decode
and cross attention.

Port of ``repro.core.attention``:

* :func:`flash_attention` — memory-bounded prefill and training
  attention, at any query position offset.  On CUDA tensors it runs the
  hand-written flash-prefill kernel (``csrc/flash_prefill.cu``) and,
  where a gradient is wanted, its backward kernel
  (``csrc/flash_prefill_bwd.cu``); on CPU tensors their plain versions,
  the port of the JAX function's ``q_chunk × kv_chunk`` online-softmax
  walk and the same backward math in PyTorch ops.  The reference
  differentiates its walk with XLA.  On DTensor operands (the sharded
  training step, ``launch/train.py``) the kernels run on each rank's
  local shard (:func:`_flash_local`), or the installed sequence-parallel
  prefill takes the call (:data:`SP_PREFILL`, ``launch/spattn.py``).
* :func:`decode_attention` (``impl="fused"`` and the paper's
  ``"dequant_first"`` baseline) and :func:`cross_attention` — the JAX
  package computes them with XLA outside any Pallas kernel; here they are
  plain PyTorch (``einsum`` over the slab) on the card and on the CPU
  alike.
* :func:`prefill_attention` — the full-matrix oracle.
* :func:`_flash_triangle`: the reference's causal-triangle walk, which
  it takes under the dry-run's ``block_skip``.  Here it is the plain
  walk (``kernels.ref.flash_prefill_walk``) at the reference's square
  512-row blocks: that walk, like the kernels, already skips every key
  tile above the diagonal, so no flag chooses it and the port's count is
  the skipping count always, where the reference's halves with the flag.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops, ref

from . import quantize as Q
from .kvcache import KVCache, dequant_k, dequant_v
from .precision import FormatSpec

NEG_INF = -1e30

#: sequence-parallel prefill attention, installed by launch code for meshes
#: whose head counts do not divide the model axis
#: (``launch.spattn.build_sp_prefill``): ``fn(q, k, v, causal, window) ->
#: out`` or None (the call falls back to the flash path)
SP_PREFILL = None
#: the reference's default ``q_chunk``: only longer prefills go to
#: :data:`SP_PREFILL`
SP_MIN_ROWS = 512
#: placements of flash attention's DTensor operands, installed by launch
#: code (``launch/train.py``, from ``ShardingRules.activation``):
#: ``fn(q, k) -> placements`` for q, k and v; replicated when None
FLASH_PLACEMENTS = None


def set_sp_prefill(fn) -> None:
    """Install (or, with None, remove) :data:`SP_PREFILL`."""
    global SP_PREFILL
    SP_PREFILL = fn


def set_flash_placements(fn) -> None:
    """Install (or, with None, remove) :data:`FLASH_PLACEMENTS`."""
    global FLASH_PLACEMENTS
    FLASH_PLACEMENTS = fn


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


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``, and for DTensor operands sharded only on indices
    that every operand and the output carry (batch and head indices: the
    work is independent per shard), the einsum of each rank's local
    shards through ``local_map``, the output on the same indices — no
    sharding rule then has to flatten a sharded dim into the product's
    batch (which some torch versions refuse).  Other DTensor cases take
    DTensor's own rule."""
    if not any(is_dtensor(t) for t in ops):
        return torch.einsum(eq, *ops)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = next(t for t in ops if is_dtensor(t)).device_mesh
    rep = [Replicate()] * mesh.ndim
    ops = [t if is_dtensor(t) else DTensor.from_local(t, mesh, rep,
                                                      run_check=False)
           for t in ops]
    common = set(out).intersection(*map(set, ins))
    letters = []                     # per mesh dim: the sharded index or None
    for i in range(mesh.ndim):
        on = {idx[p.dim] for t, idx in zip(ops, ins)
              for p in (t.placements[i],) if isinstance(p, Shard)}
        mixed = any(t.placements[i].is_partial() or
                    type(t.placements[i]) not in (Shard, Replicate)
                    for t in ops)
        if mixed or len(on) > 1 or (on and not on <= common):
            return torch.einsum(eq, *ops)
        letters.append(next(iter(on)) if on else None)
    pl = [tuple(Shard(idx.index(x)) if x else Replicate() for x in letters)
          for idx in ins]
    out_pl = tuple(Shard(out.index(x)) if x else Replicate() for x in letters)
    ops = [t.redistribute(mesh, p) for t, p in zip(ops, pl)]
    return local_map(lambda *ls: torch.einsum(eq, *ls),
                     out_placements=(out_pl,), in_placements=tuple(pl),
                     device_mesh=mesh)(*ops)


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum``; a DTensor not sharded along ``dim`` sums each
    rank's local shard through ``local_map`` (its backward, a flipped
    cumsum, has no sharding rule on some torch versions)."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x) or any(isinstance(p, Shard) and
                                p.dim % x.ndim == dim % x.ndim
                                for p in x.placements):
        return torch.cumsum(x, dim=dim)
    from torch.distributed.tensor.experimental import local_map
    return local_map(lambda t: torch.cumsum(t, dim=dim),
                     out_placements=(x.placements,),
                     in_placements=(x.placements,),
                     device_mesh=x.device_mesh)(x)


def _as_int(x, name: str) -> int:
    """An int, or a 0-d integer tensor read once (the reference's traced
    scalars; the port's callers pass ints, so none pays for the read)."""
    if isinstance(x, torch.Tensor):
        if x.dim() or x.is_floating_point() or x.is_complex():
            raise ValueError(f"{name}: expected an int or a 0-d integer "
                             f"tensor, got {x.dtype} {tuple(x.shape)}")
        return int(x)
    if isinstance(x, bool) or not isinstance(x, int):
        raise ValueError(f"{name}: expected an int, got {x!r}")
    return x


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    pos_offset=0) -> torch.Tensor:
    """Online-softmax attention over tiles of keys, differentiable.
    q (B, Sq, H, D), k/v (B, Sk, Hkv, D) → (B, Sq, H, D) in q's dtype.

    Query row t sits at position ``pos_offset + t`` (>= 0): a key is kept
    when ``kpos <= qpos`` (causal) and ``kpos > qpos - window``, as in the
    reference's walk (``repro/core/attention.py:140-151``).  ``window``
    and ``pos_offset`` are ints or 0-d integer tensors.  The flash-prefill
    kernel's wrapper picks the tile from the shapes (the JAX default of
    512 × 512 chunks does not fit in a block's shared memory at D 256);
    tiles wholly masked are skipped.  With :data:`SP_PREFILL` installed,
    a causal call at offset 0 of more than :data:`SP_MIN_ROWS` rows goes
    to it first (the reference's guard).  DTensor operands run the
    kernels on each rank's shard (:func:`_flash_local`)."""
    window = None if window is None else _as_int(window, "window")
    pos_offset = _as_int(pos_offset, "pos_offset")
    if pos_offset < 0:
        raise ValueError(f"pos_offset={pos_offset} < 0")
    if (SP_PREFILL is not None and causal and pos_offset == 0
            and q.shape[1] > SP_MIN_ROWS):
        out = SP_PREFILL(q, k, v, causal=causal, window=window)
        if out is not None:
            return out
    if is_dtensor(q):
        return _flash_local(q, k, v, causal, window, pos_offset)
    return ops.flash_prefill_attention(q, k, v, causal=causal, window=window,
                                       pos_offset=pos_offset)


def _flash_triangle(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None,
                    block: int = 512) -> torch.Tensor:
    """Causal flash attention over only the (query block, key block) pairs
    on or below the diagonal, square ``block``-row blocks (the reference's
    ``_flash_triangle`` at its q_chunk = kv_chunk = 512): the plain walk
    (``kernels.ref.flash_prefill_walk``), which skips the tiles above the
    diagonal, on head-major views.  q (B, S, H, D), k/v (B, S, Hkv, D) →
    (B, S, H, D) in q's dtype."""
    out = ref.flash_prefill_walk(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=ref.NO_WINDOW if window is None else window,
        seq=k.shape[1], block_q=block, block_k=block)
    return out.transpose(1, 2).to(q.dtype)


def is_dtensor(t) -> bool:
    """True for a DTensor (the sharded step's operands; torch.distributed
    is imported only when a tensor subclass is seen)."""
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _flash_local(q, k, v, causal: bool, window: Optional[int],
                 pos_offset: int) -> torch.Tensor:
    """Flash attention on DTensor operands: the one place a sharded step
    leaves DTensor.  q, k and v go on the placements of
    :data:`FLASH_PLACEMENTS` (replicated if none is installed) and each
    rank runs the kernels on its local shard through ``local_map`` (the
    kernels launch through ctypes and never see a DTensor)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    place = tuple(FLASH_PLACEMENTS(q, k)) if FLASH_PLACEMENTS is not None \
        else (Replicate(),) * mesh.ndim
    q, k, v = (t.redistribute(mesh, place) for t in (q, k, v))

    def local(ql, kl, vl):
        return ops.flash_prefill_attention(ql, kl, vl, causal=causal,
                                           window=window,
                                           pos_offset=pos_offset)

    return local_map(local, out_placements=(place,),
                     in_placements=(place, place, place),
                     device_mesh=mesh)(q, k, v)


def _scale_rows(scale: torch.Tensor) -> torch.Tensor:
    """(B, S, Hkv) per-token scales → (B, Hkv, 1, 1, S), broadcast over
    the (rep, T) axes of the score tensor."""
    return scale.permute(0, 2, 1)[:, :, None, None, :]


def _attend_slab(q: torch.Tensor, cache: KVCache, spec: FormatSpec,
                 mask: Optional[torch.Tensor],
                 dequant_first: bool = False) -> torch.Tensor:
    """Attention over a whole per-layer slab.  The fused pipeline: scores
    against the stored integers' cast, K scales on the scores, softmax in
    f32, V scales folded into the probabilities, then the PV product
    against the cast V.  ``dequant_first`` (the paper's baseline): the
    whole slab dequantized to q's dtype first, then plain attention.
    ``mask`` (B, T, S) or None (every key)."""
    B, T, H, D = q.shape
    Hkv = cache.k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, T, Hkv, rep, D).float()
    if dequant_first:
        kq = dequant_k(cache, spec, q.dtype).float()
    else:
        kq = _unpack_if_needed(cache.k, spec).to(q.dtype).float()
    scores = einsum("bthrd,bshd->bhrts", qg, kq)
    if not dequant_first:
        scores = scores * _scale_rows(cache.k_scale)
    scores = scores * (1.0 / torch.sqrt(torch.tensor(float(D))))
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    if dequant_first:
        pv = probs.to(q.dtype).float()
        vq = dequant_v(cache, spec, q.dtype).float()
    else:
        pv = (probs * _scale_rows(cache.v_scale)).to(q.dtype).float()
        vq = _unpack_if_needed(cache.v, spec).to(q.dtype).float()
    out = einsum("bhrts,bshd->bthrd", pv, vq)
    return out.to(q.dtype).reshape(B, T, H, D)


def decode_attention(q: torch.Tensor, cache: KVCache, spec: FormatSpec,
                     pos, window: Optional[int] = None,
                     impl: str = "fused") -> torch.Tensor:
    """Attend T new queries against ``pos + t`` cached tokens (causal),
    over a per-layer dense slab.  q (B, T, H, D); ``pos`` a scalar or
    (B,) first query position.

    ``impl="fused"``: K scales go on the scores and V scales on the
    probabilities — the JAX XLA path's order, not the decode kernels'
    (which scale K/V before the dots, ROADMAP "KV scales").
    ``impl="dequant_first"``: the paper's baseline, the whole slab
    dequantized to bf16 before the dots.  Plain PyTorch on every device,
    as the reference is XLA on every device."""
    if impl not in ("fused", "dequant_first"):
        raise ValueError(f"decode_attention: unknown impl {impl!r} "
                         "(expected 'fused' or 'dequant_first')")
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
    return _attend_slab(q, cache, spec, mask, impl == "dequant_first")


def cross_attention(q: torch.Tensor, cache: KVCache, spec: FormatSpec
                    ) -> torch.Tensor:
    """Whisper's cross attention: T queries against every token of the
    static encoder slab, no mask.  Plain PyTorch, as
    :func:`decode_attention`."""
    return _attend_slab(q, cache, spec, None)
