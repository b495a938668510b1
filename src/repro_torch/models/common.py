"""Shared model building blocks: norms, RoPE, MLPs, and a linear that is
transparent over quantized (PackedWeight) vs dense (bf16) weights.

Port of ``repro.models.common`` for every family (dense, moe, vlm, ssm,
hybrid, audio).  Plain functions over explicit parameter dicts;
initializers return bf16.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import attention as A
from repro_torch.core import paged_kvcache as PKV
from repro_torch.core.gemm import mp_matmul
from repro_torch.core.packing import PackedWeight, pack_stack, pack_weight
from repro_torch.core.precision import FormatSpec, PrecisionPolicy
from repro_torch.kernels import ops

#: activation-sharding hook: launch code installs a function that puts the
#: HEAD axis of (B, S, H, dh) tensors on the model axis (``launch/train.py``
#: installs a DTensor redistribution); the identity when None
_HEAD_CONSTRAINT = None


#: the sharded serve step's hooks, installed by launch code
#: (``launch/shardserve.py``): a packed GEMM whose weight is sharded
#: (``fn(x, w, policy) -> y``), decode attention over a sharded slab
#: (``fn(q, cache_l, spec, pos, window, block_s) -> out``) and a lookup in
#: a vocab-sharded table outside autograd (``fn(table, tokens) -> rows``);
#: a DTensor operand with no hook installed raises or takes the training
#: step's route
_SHARDED_LINEAR = None
_SHARDED_DECODE = None
_SHARDED_EMBED = None


def set_sharded_serve(linear=None, decode=None, embed=None) -> None:
    """Install (or, with None, remove) the sharded serve step's hooks."""
    global _SHARDED_LINEAR, _SHARDED_DECODE, _SHARDED_EMBED
    _SHARDED_LINEAR, _SHARDED_DECODE, _SHARDED_EMBED = linear, decode, embed


def set_head_constraint(fn) -> None:
    """Install (or, with None, remove) the head-axis constraint."""
    global _HEAD_CONSTRAINT
    _HEAD_CONSTRAINT = fn


def constrain_heads(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, dh): apply the installed head-axis constraint."""
    if _HEAD_CONSTRAINT is None:
        return x
    return _HEAD_CONSTRAINT(x)


def _whole_heads(y, heads: int):
    """DTensor ``y`` whose last dim is to be split into ``heads`` heads,
    gathered over each mesh dim that shards that dim and does not divide
    the heads (DTensor may shard a product's columns, or a gradient, of
    its own accord): a split must keep whole heads."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = y.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and
               p.dim == y.ndim - 1 and heads % mesh.size(i) else p
               for i, p in enumerate(y.placements))
    return y if pl == tuple(y.placements) else y.redistribute(mesh, pl)


def split_heads(y: torch.Tensor, *shape: int) -> torch.Tensor:
    """``y.reshape(*shape)``, the last dim split into (heads, head dim), a
    DTensor on whole heads first (:func:`_whole_heads`)."""
    if A.is_dtensor(y):
        y = _whole_heads(y, shape[-2])
    return y.reshape(*shape)


class _WholeHeadsGrad(torch.autograd.Function):
    """Identity whose backward puts the gradient on whole heads before
    the merge's backward splits it (:func:`merge_heads`)."""

    @staticmethod
    def forward(ctx, y, heads):
        ctx.heads = heads
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _whole_heads(g, ctx.heads), None


def merge_heads(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``, the last two dims (heads, head dim) merged.
    On a DTensor the gradient is put on whole heads before the reshape's
    backward splits it again, as :func:`split_heads` does going
    forward."""
    if not A.is_dtensor(x):
        return x.reshape(*shape)
    return _WholeHeadsGrad.apply(x.reshape(*shape), x.shape[-2])


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``table[tokens]`` of an embedding table.  A DTensor table (the
    sharded step) goes through ``F.embedding``, whose sharding rule DTensor
    has on every torch version (the indexing's backward ``index_put`` has
    none on some), from the table gathered whole (a vocab-sharded lookup's
    masked partial rows have no backward redistribution); a plain table
    is indexed, as before."""
    if A.is_dtensor(table):
        if _SHARDED_EMBED is not None and not torch.is_grad_enabled():
            return _SHARDED_EMBED(table, tokens)
        from torch.distributed.tensor import Replicate
        whole = table.redistribute(table.device_mesh,
                                   [Replicate()] * table.device_mesh.ndim)
        return F.embedding(tokens.long(), whole)
    return table[tokens.long()]


# ---------------------------------------------------------------------------
# Linear application — quantization-transparent
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w, policy: Optional[PrecisionPolicy] = None
           ) -> torch.Tensor:
    """x @ w where w is a bf16 tensor (``torch.matmul``) or a PackedWeight
    (the mixed-precision GEMM kernels, routed by ``policy``)."""
    if _SHARDED_LINEAR is not None and A.is_dtensor(x) and \
            not isinstance(w, PackedWeight):
        return _SHARDED_LINEAR(x, w, policy)
    if isinstance(w, PackedWeight):
        if policy is None:
            raise ValueError("a packed weight needs its precision policy")
        if A.is_dtensor(w.data):
            if _SHARDED_LINEAR is None:
                raise ValueError("a sharded packed weight needs the sharded "
                                 "serve step's GEMM (set_sharded_serve)")
            return _SHARDED_LINEAR(x, w, policy)
        return mp_matmul(x, w, policy)
    return torch.matmul(x, w.to(x.dtype))


#: model-axis width the JAX package's tile choice prefers to divide (kept so
#: the port packs the same tiles, byte for byte)
MODEL_AXIS = 16


def pick_blocks(K: int, N: int):
    """Tile dims dividing (K, N), chosen exactly as the JAX package does:
    prefer block sizes whose tile count divides ``MODEL_AXIS``, else the
    largest block dividing the dim."""
    def pick(dim, candidates):
        best = None
        for b in candidates:
            if dim % b == 0:
                if best is None:
                    best = b
                if (dim // b) % MODEL_AXIS == 0:
                    return b
        return best

    return pick(K, (128, 64, 32)), pick(N, (128, 96, 64))


def maybe_quantize(w: torch.Tensor, policy: PrecisionPolicy,
                   min_size: int = 256 * 256):
    """Quantize+pack a 2D weight, or an (E, K, N) stack over its trailing
    (K, N) (a MoE layer's experts, :func:`core.packing.pack_stack`), if
    it is large enough and tileable; small or odd weights stay bf16
    (embeddings, norms stay high precision).  Every weight packed here
    at the default group also runs through the CUDA GEMMs: a K of 32
    times an odd number packs with block_k = group = 32, which the
    kernels read as a 32-deep tail chunk (``core.packing.
    to_kernel_layout``)."""
    if policy.weights.bits == 16 or w.dim() < 2:
        return w
    if w.dim() > 3:
        raise ValueError(f"maybe_quantize packs (K, N) weights and (E, K, "
                         f"N) stacks, got shape {tuple(w.shape)}")
    K, N = w.shape[-2:]
    if K * N < min_size:
        return w
    bk, bn = pick_blocks(K, N)
    if bk is None or bn is None:
        return w
    group = min(policy.weight_group, bk)
    if bk % group:
        group = bk
    bits = 8 if policy.weights.is_float else policy.weights.bits
    if w.dim() == 3:     # member by member: one member's f32 at a time
        return pack_stack(w, bits=bits, group=group, block_k=bk,
                          block_n=bn)
    return pack_weight(w.float(), bits=bits, group=group, block_k=bk,
                       block_n=bn)


# ---------------------------------------------------------------------------
# Decode attention over either KV backend
# ---------------------------------------------------------------------------


def attend_decode(q: torch.Tensor, cache_l, spec: FormatSpec, pos,
                  window=None, block_s: Optional[int] = None,
                  max_live: Optional[int] = None,
                  impl: str = "kernel") -> torch.Tensor:
    """Decode / chunked-prefill attention over a per-layer cache of either
    backend.  q: (B, T, H, D); ``pos`` is the per-slot first query
    position; token t attends causally through ``pos + t``.

    ``impl="kernel"``: a paged cache goes to the multi-query paged kernel,
    which resolves the block table itself for any T, its walk bounded by
    ``max_live``; a dense slab to the slab kernel at ``block_s`` (default
    256, clipped to the slab).  The engine sets ``block_s`` to the paged
    block size, so both backends walk the same tiles and stay bitwise
    equal.

    ``impl="xla"`` (the reference's opt-out, plain PyTorch here): a paged
    cache gathers a dense view of its first ``live_ctx`` tokens through
    the block table — ``max_live`` counts the first query row's context,
    so it is widened by the chunk's ``T - 1`` further positions — and a
    dense slab is read whole, both by the fused attention of
    :func:`repro_torch.core.attention.decode_attention`."""
    if impl not in ("kernel", "xla"):
        raise ValueError(f"attend_decode: unknown impl {impl!r} "
                         "(expected 'kernel' or 'xla')")
    paged = isinstance(cache_l, PKV.PagedKVCache)
    if impl == "kernel" and not paged and A.is_dtensor(cache_l.k):
        if _SHARDED_DECODE is None:
            raise ValueError("a sharded slab needs the sharded serve step's "
                             "decode attention (set_sharded_serve)")
        return _SHARDED_DECODE(q, cache_l, spec, pos, window, block_s or 256)
    if impl == "xla":
        if paged:
            ml = None if max_live is None else max_live + q.shape[1] - 1
            cache_l = PKV.gather_view(cache_l,
                                      n_ctx=PKV.live_ctx(cache_l, ml))
        return A.decode_attention(q, cache_l, spec, pos, window=window)
    if paged:
        return ops.kvattn_decode_paged(q, cache_l, spec, pos, window=window,
                                       max_live=max_live)
    return ops.kvattn_decode(q, cache_l, spec, pos, window=window,
                             block_s=block_s or 256)


# ---------------------------------------------------------------------------
# Norms and positions
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """RMSNorm scaling by ``1 + g`` (g is initialised to zero)."""
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * (1.0 + g.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with gain and bias, in f32: the population variance
    (``jnp.var``, so ``unbiased=False``), then back to x's dtype."""
    h = x.float()
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, unbiased=False)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * g.float() + b.float()).to(x.dtype)


def group_norm(x: torch.Tensor, g: torch.Tensor, n_groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm (the RWKV wkv output) in f32 with the
    population variance (``jnp.var``: ``mean((h - mu)^2)``), then back to
    x's dtype."""
    *lead, D = x.shape
    h = x.float().reshape(*lead, n_groups, D // n_groups)
    mu = h.mean(-1, keepdim=True)
    var = torch.square(h - mu).mean(-1, keepdim=True)
    h = ((h - mu) * torch.rsqrt(var + eps)).reshape(*lead, D)
    return (h * g.float()).to(x.dtype)


def sinusoidal_pos(S: int, D: int, offset: int = 0,
                   device=None) -> torch.Tensor:
    """(S, D) bf16 table ``[sin(pos·inv) | cos(pos·inv)]`` with
    ``inv = exp(-ln(10000) · 2i / D)``, computed in f32."""
    pos = torch.arange(S, dtype=torch.float32, device=device) + offset
    inv = torch.exp(-math.log(10000.0) * torch.arange(
        0, D, 2, dtype=torch.float32, device=device) / D)
    ang = pos[:, None] * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(
        torch.bfloat16)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU as ``jax.nn.gelu`` computes it by default: the tanh
    approximation (the exact erf form differs by up to ~1e-3)."""
    return F.gelu(x, approximate="tanh")


def rope_freqs(head_dim: int, rotary_pct: float, theta: float,
               device=None) -> torch.Tensor:
    """RoPE inverse frequencies of the rotated leading dims (f32)."""
    rot = int(head_dim * rotary_pct) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def rope_rotation(pos: torch.Tensor, head_dim: int, *,
                  rotary_pct: float = 1.0, theta: float = 10_000.0
                  ) -> torch.Tensor:
    """(B, S) absolute positions → complex64 ``cos + i·sin`` table of
    shape (B, S, 1, rot/2), shared by every layer's q and k of a step."""
    if A.is_dtensor(pos):
        # no sharding rule for polar: each rank's rows of its positions
        from torch.distributed.tensor.experimental import local_map
        return local_map(
            lambda p: rope_rotation(p, head_dim, rotary_pct=rotary_pct,
                                    theta=theta),
            out_placements=(pos.placements,),
            in_placements=(pos.placements,),
            device_mesh=pos.device_mesh)(pos)
    inv = rope_freqs(head_dim, rotary_pct, theta, device=pos.device)
    ang = pos.float()[..., None] * inv                        # (B, S, rot/2)
    return torch.polar(torch.ones_like(ang), ang)[:, :, None, :]


def apply_rope(x: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D) with a :func:`rope_rotation` table.  Rotates
    *interleaved* pairs ``(x[2i], x[2i+1])`` — not the two halves — of the
    leading ``rot`` dims (partial rotary leaves the rest): each pair is
    the complex number ``x[2i] + i·x[2i+1]`` times ``cos + i·sin``."""
    B, S, H, D = x.shape
    rot = rotation.shape[-1] * 2
    xr = torch.view_as_complex(
        x[..., :rot].float().reshape(B, S, H, rot // 2, 2))
    out = torch.view_as_real(xr * rotation).reshape(B, S, H, rot)
    out = out.to(x.dtype)
    return out if rot == D else torch.cat([out, x[..., rot:]], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, p, policy=None) -> torch.Tensor:
    """SwiGLU MLP ``w2(silu(x @ w1) * (x @ w3))``, three GEMMs."""
    a = linear(x, p["w1"], policy)
    b = linear(x, p["w3"], policy)
    return linear(F.silu(a.float()).to(x.dtype) * b, p["w2"], policy)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None) -> torch.Tensor:
    """Seeded normal init, ``1/sqrt(fan_in)`` unless ``scale`` is given,
    drawn in f32 on the generator's device and stored bf16."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(torch.bfloat16)
