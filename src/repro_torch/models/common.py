"""Shared model building blocks: norms, RoPE, MLPs, and a linear that is
transparent over quantized (PackedWeight) vs dense (bf16) weights.

Port of ``repro.models.common`` for the ported families (dense, hybrid,
audio).  Plain functions over explicit parameter dicts; initializers
return bf16.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import paged_kvcache as PKV
from repro_torch.core.gemm import mp_matmul
from repro_torch.core.packing import PackedWeight, pack_weight
from repro_torch.core.precision import FormatSpec, PrecisionPolicy
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Linear application — quantization-transparent
# ---------------------------------------------------------------------------


def linear(x: torch.Tensor, w, policy: Optional[PrecisionPolicy] = None
           ) -> torch.Tensor:
    """x @ w where w is a bf16 tensor (``torch.matmul``) or a PackedWeight
    (the mixed-precision GEMM kernels, routed by ``policy``)."""
    if isinstance(w, PackedWeight):
        if policy is None:
            raise ValueError("a packed weight needs its precision policy")
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
    """Quantize+pack a 2D weight if it is large enough and tileable; small
    or odd weights stay bf16 (embeddings, norms stay high precision).  The
    CUDA GEMMs also need K % 64 == 0 (``core.packing.to_kernel_layout``):
    a K of 32 times an odd number packs here (block_k 32), and the engine
    then refuses it on the card at load time."""
    if policy.weights.bits == 16 or w.dim() != 2:
        return w
    K, N = w.shape
    if K * N < min_size:
        return w
    bk, bn = pick_blocks(K, N)
    if bk is None or bn is None:
        return w
    group = min(policy.weight_group, bk)
    if bk % group:
        group = bk
    bits = 8 if policy.weights.is_float else policy.weights.bits
    return pack_weight(w.float(), bits=bits, group=group, block_k=bk,
                       block_n=bn)


# ---------------------------------------------------------------------------
# Decode attention over either KV backend
# ---------------------------------------------------------------------------


def attend_decode(q: torch.Tensor, cache_l, spec: FormatSpec, pos,
                  window=None, block_s: Optional[int] = None,
                  max_live: Optional[int] = None) -> torch.Tensor:
    """Decode / chunked-prefill attention over a per-layer cache of either
    backend.  q: (B, T, H, D); ``pos`` is the per-slot first query
    position; token t attends causally through ``pos + t``.

    A paged cache goes to the multi-query paged kernel, which resolves the
    block table itself for any T, its walk bounded by ``max_live``; a
    dense slab to the slab kernel at ``block_s`` (default 256, clipped to
    the slab).  The engine sets ``block_s`` to the paged block size, so
    both backends walk the same tiles and stay bitwise equal."""
    if isinstance(cache_l, PKV.PagedKVCache):
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
