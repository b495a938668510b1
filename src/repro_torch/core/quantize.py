"""Quantization primitives: per-group / per-token symmetric quantization,
INT4 nibble packing, per-(token, head) KV quantization.

Port of ``repro.core.quantize``; every integer and scale it produces equals
the JAX package's bit for bit *as the JAX engine runs it*, i.e. under
``jax.jit``.  Three details carry that:

* The scale is ``max(amax, 1e-8) * f32(1 / qmax)``.  The JAX source writes
  ``/ qmax``, but under ``jit`` XLA rewrites a division by a constant into
  a multiplication by its f32 reciprocal (eager JAX, which divides, differs
  in the last bit of some scales).  Every JAX path of the engine — the
  jitted ``pack_weight``, the jitted step's KV quantization — multiplies.
* ``round(x / scale)`` is a true division (the divisor is not a constant,
  so XLA keeps it) followed by round-half-even; a reciprocal here would
  flip rounding decisions.
* INT4 values live in int8 containers; packed tensors hold index ``2k`` in
  the low nibble and ``2k + 1`` in the high nibble, both sign-extended on
  unpack.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .precision import FormatSpec


def absmax_scale(x: torch.Tensor, dim: int, qmax: float) -> torch.Tensor:
    """Symmetric absmax scale along ``dim`` (kept); safe for zero slices."""
    amax = x.float().abs().amax(dim=dim, keepdim=True)
    recip = float(np.float32(1.0) / np.float32(qmax))   # XLA's InvertConstant
    return torch.clamp_min(amax, 1e-8) * recip


def quantize_int(x: torch.Tensor, scale: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """Round-half-even symmetric quantization to signed ``bits``-bit ints."""
    qmax = 2 ** (bits - 1) - 1
    q = torch.round(x.float() / scale)
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


# -- weights (per-group along K) --------------------------------------------


def quantize_weight_grouped(w: torch.Tensor, bits: int, group: int = 128
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (K, N) weights per-(group, column).

    Returns (q [K, N] int8 holding b-bit values, scales [K//group, N] f32).
    """
    K, N = w.shape
    if K % group:
        raise ValueError(f"K={K} not divisible by group={group}")
    wg = w.reshape(K // group, group, N)
    scale = absmax_scale(wg, dim=1, qmax=2 ** (bits - 1) - 1)   # (G,1,N)
    q = quantize_int(wg, scale, bits).reshape(K, N)
    return q, scale[:, 0, :]


def dequantize_weight_grouped(q: torch.Tensor, scale: torch.Tensor,
                              group: int = 128,
                              dtype=torch.bfloat16) -> torch.Tensor:
    """(K, N) ints × per-group scales → ``dtype``."""
    K, N = q.shape
    deq = q.reshape(K // group, group, N).float() * scale[:, None, :]
    return deq.reshape(K, N).to(dtype)


# -- INT4 nibble packing -----------------------------------------------------


def pack_int4(q: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Pack int8-held int4 values two per byte along ``dim``: low nibble =
    even index, high nibble = odd index.  Values must be in [-8, 7]."""
    if q.shape[dim] % 2:
        raise ValueError(f"dim {dim} of {tuple(q.shape)} is odd")
    pairs = q.unfold(dim, 2, 2)                 # (..., K/2, ..., 2)
    lo, hi = pairs[..., 0], pairs[..., 1]
    byte = (lo.to(torch.int32) & 0x0F) | ((hi.to(torch.int32) & 0x0F) << 4)
    return byte.to(torch.uint8).view(torch.int8)


def unpack_int4(p: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 containers → int8-held int4."""
    p32 = p.to(torch.int32)                     # sign-extends the byte
    lo = ((p32 & 0x0F) ^ 0x08) - 0x08           # sign-extend the low nibble
    hi = p32 >> 4                               # arithmetic shift
    stacked = torch.stack([lo, hi], dim=dim + 1)
    shape = list(p.shape)
    shape[dim] *= 2
    return stacked.reshape(shape).to(torch.int8)


# -- activations (per-token) -------------------------------------------------


def quantize_act_per_token(x: torch.Tensor, bits: int = 8
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric quantization (last axis = features).
    Returns (q int8, scale (..., 1) f32)."""
    scale = absmax_scale(x, dim=-1, qmax=2 ** (bits - 1) - 1)
    return quantize_int(x, scale, bits), scale


# -- KV cache (per-token, per-head) ------------------------------------------


def quantize_kv(kv: torch.Tensor, spec: FormatSpec):
    """Quantize KV states of shape (..., heads, head_dim).

    Returns (q, scale) with scale of shape (..., heads, 1) f32.
    """
    if spec.is_float:
        if spec.bits == 16:
            return kv.to(spec.dtype), torch.ones(
                kv.shape[:-1] + (1,), dtype=torch.float32, device=kv.device)
        scale = absmax_scale(kv, dim=-1, qmax=spec.qmax)
        return (kv.float() / scale).to(spec.dtype), scale
    scale = absmax_scale(kv, dim=-1, qmax=spec.qmax)
    q = quantize_int(kv, scale, spec.bits)
    if spec.packed:  # int4: pack head_dim two per byte
        q = pack_int4(q, dim=q.ndim - 1)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, spec: FormatSpec,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (up to quantization error)."""
    if spec.is_float and spec.bits == 16:
        return q.to(dtype)
    if spec.packed:
        q = unpack_int4(q, dim=q.ndim - 1)
    return (q.float() * scale).to(dtype)
