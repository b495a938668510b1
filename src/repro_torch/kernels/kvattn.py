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

from repro_torch.roofline import op_cost

from . import _build
from . import cost as KC
from .ref import kvattn_ref

#: head dims the attention kernels are instantiated for
HEAD_DIMS = (32, 64, 128, 288)
#: the kernels' KV format codes (``flash::Fmt`` in csrc/flash_block.cuh)
FORMAT_CODES = {"kv8": 0, "kv4": 1, "kvfp8": 2, "kv16": 3}
#: returned by the attention kernels when not even a 16-token sub-tile
#: fits in the 227 KB of shared memory a block may use (``flash::ERR_SMEM``;
#: no head dim of ``HEAD_DIMS`` is like that — a larger tile is walked as
#: sub-tiles, ``flash::sub_rows``)
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
            f"{name}: not even a 16-token sub-tile of a {bs}-token tile at "
            f"head_dim {D} fits in the 227 KB of shared memory a block may "
            "use")
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def kvattn(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
           v: torch.Tensor, v_scale: torch.Tensor, pos: torch.Tensor,
           window: int, rep: int, block_s: int, spec: FormatSpec,
           key_offset: int = 0, return_lse: bool = False):
    """q (B, Hkv, R, D) bf16 token-major rows; slab k/v (B, S, Hkv, Dstore)
    stored in ``spec`` with scales (B, S, Hkv) f32; pos (B,) int32; the
    walk takes ``min(block_s, S)``-token tiles, which must divide S.
    The slab holds the keys at positions ``key_offset`` .. ``key_offset +
    S - 1`` (a rank's range of a sequence-sharded cache; pos stays
    absolute).  Returns (B, Hkv, R, D) bf16 or, with ``return_lse``, the
    output unrounded in f32 (a partial result, rounded once by whoever
    combines the ranges: ``ref.combine_lse``) and each row's log-sum-exp
    (B, Hkv, R) f32 (-inf where the range holds no kept key; the output
    is then 0).  Counts its CUDA launches in
    ``kvattn.launches``; declares its cost to an active
    ``roofline.op_cost`` counter."""
    if op_cost.COUNTER is not None and not op_cost.COUNTER.paused:
        return op_cost.COUNTER.kernel(
            "kvattn", KC.of_kvattn, kvattn, q, k, k_scale, v, v_scale, pos,
            window, rep, block_s, spec, key_offset, return_lse)
    B, Hkv, R, D = q.shape
    S = k.shape[1]
    bs = min(int(block_s), S)
    if S % bs:
        raise ValueError(f"block_s={bs} does not divide the slab's S={S}")
    if R % rep:
        raise ValueError(f"R={R} is not a multiple of rep={rep}")
    fmt = kv_format(spec, k, D)
    key_offset = int(key_offset)
    if key_offset < 0:
        raise ValueError(f"key_offset={key_offset} < 0")
    if q.device.type == "cpu":
        return kvattn_ref(q, k, k_scale, v, v_scale, pos, window, rep, bs,
                          key_offset, return_lse)
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
    out = torch.empty_like(q, dtype=torch.float32 if return_lse else None)
    lse = torch.empty((B, Hkv, R), dtype=torch.float32, device=q.device) \
        if return_lse else None
    fn = _build.bind("kvattn", "kvattn", 8, 10)
    err = fn(q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
             v_scale.data_ptr(), pos.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), fmt, B, Hkv, R, D, rep,
             S, bs, int(window), key_offset,
             torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("kvattn", err, D, bs)
    kvattn.launches += 1
    return out if lse is None else (out, lse)


kvattn.launches = 0
