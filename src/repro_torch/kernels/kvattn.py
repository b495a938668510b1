"""Multi-query attention over the dense KV slab: wrapper around
``csrc/kvattn.cu``.

Replaces the Pallas kernel ``repro.kernels.kvattn.kvattn_decode_grouped``
(every KV format): flash-decoding over ``(B, S, Hkv, Dstore)`` in
``block_s`` tiles, the same block program as the paged kernel.  CPU
tensors take the plain version (:func:`repro_torch.kernels.ref.kvattn_ref`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.kvcache import store_dim
from repro_torch.core.precision import FormatSpec

from . import _build
from .ref import kvattn_ref

#: head dims the attention kernels are instantiated for
HEAD_DIMS = (32, 64, 128)
#: the kernels' KV format codes (``flash::Fmt`` in csrc/flash_block.cuh)
FORMAT_CODES = {"kv8": 0, "kv4": 1, "kvfp8": 2, "kv16": 3}
#: returned by the attention kernels when a tile does not fit in the
#: 227 KB of shared memory a block may use (``flash::ERR_SMEM``)
ERR_SMEM = -1


def kv_format(spec: FormatSpec, k: torch.Tensor, D: int) -> int:
    """The kernels' code for ``spec``, after checking that ``k`` is stored
    in it (dtype and ``Dstore``)."""
    if spec.name not in FORMAT_CODES:
        raise ValueError(f"unknown KV format {spec.name!r}")
    if k.dtype != spec.dtype or k.shape[-1] != store_dim(D, spec):
        raise ValueError(
            f"{spec.name} stores {spec.dtype} rows of {store_dim(D, spec)} "
            f"at head_dim {D}; got {k.dtype} rows of {k.shape[-1]}")
    return FORMAT_CODES[spec.name]


def raise_on_error(name: str, err: int, D: int, bs: int) -> None:
    """Turn an attention kernel's return code into an exception."""
    if err == ERR_SMEM:
        raise ValueError(
            f"{name}: a {bs}-token tile at head_dim {D} needs more shared "
            "memory than a block may use (227 KB); use a smaller block")
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def kvattn(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
           v: torch.Tensor, v_scale: torch.Tensor, pos: torch.Tensor,
           window: int, rep: int, block_s: int,
           spec: FormatSpec) -> torch.Tensor:
    """q (B, Hkv, R, D) bf16 token-major rows; slab k/v (B, S, Hkv, Dstore)
    stored in ``spec`` with scales (B, S, Hkv) f32; pos (B,) int32; the
    walk takes ``min(block_s, S)``-token tiles, which must divide S.
    Returns (B, Hkv, R, D) bf16.  Counts its CUDA launches in
    ``kvattn.launches``."""
    B, Hkv, R, D = q.shape
    S = k.shape[1]
    bs = min(int(block_s), S)
    if S % bs:
        raise ValueError(f"block_s={bs} does not divide the slab's S={S}")
    if R % rep:
        raise ValueError(f"R={R} is not a multiple of rep={rep}")
    fmt = kv_format(spec, k, D)
    if q.device.type == "cpu":
        return kvattn_ref(q, k, k_scale, v, v_scale, pos, window, rep, bs)
    if q.device.type != "cuda":
        raise RuntimeError(f"kvattn: unsupported device {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim={D}")
    ds = k.shape[-1]
    _build.check_operands(q.device, (
        ("q", q, torch.bfloat16, (B, Hkv, R, D)),
        ("k", k, spec.dtype, (B, S, Hkv, ds)),
        ("v", v, spec.dtype, (B, S, Hkv, ds)),
        ("k_scale", k_scale, torch.float32, (B, S, Hkv)),
        ("v_scale", v_scale, torch.float32, (B, S, Hkv)),
        ("pos", pos, torch.int32, (B,))))
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the kernel stages K/V in 16-byte words: "
                         "misaligned slab storage offset")
    out = torch.empty_like(q)
    fn = _build.bind("kvattn", "kvattn", 7, 9)
    err = fn(q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
             v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(), fmt, B, Hkv,
             R, D, rep, S, bs, int(window),
             torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("kvattn", err, D, bs)
    kvattn.launches += 1
    return out


kvattn.launches = 0
