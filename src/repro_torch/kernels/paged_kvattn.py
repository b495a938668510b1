"""Multi-query paged attention: wrapper around ``csrc/paged_kvattn.cu``.

Replaces the Pallas kernel
``repro.kernels.paged_kvattn.paged_kvattn_decode_grouped`` (kv8
instantiation): flash-decoding straight over the block pool, the block
table read inside the kernel, one kernel for prefill chunks and decode.
CPU tensors take the plain version
(:func:`repro_torch.kernels.ref.paged_kvattn_ref`); CUDA tensors launch
the kernel or raise.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import paged_kvattn_ref

#: head dims and block sizes the kernel is instantiated / sized for
HEAD_DIMS = (32, 64, 128)
MAX_BLOCK_SIZE = 64


def paged_kvattn_kv8(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
                     v: torch.Tensor, v_scale: torch.Tensor,
                     block_table: torch.Tensor, pos: torch.Tensor,
                     window: int, rep: int, n_live: int) -> torch.Tensor:
    """q (B, Hkv, R, D) bf16 token-major rows; kv8 pool k/v (n_blocks,
    block_size, Hkv, D) int8 with scales (n_blocks, block_size, Hkv) f32;
    block_table (B, blocks_per_slot) int32; pos (B,) int32; ``n_live``
    logical blocks are visited.  Returns (B, Hkv, R, D) bf16.  Counts its
    CUDA launches in ``paged_kvattn_kv8.launches``."""
    B, Hkv, R, D = q.shape
    nb, bs = k.shape[0], k.shape[1]
    bps = block_table.shape[1]
    n_live = max(1, min(int(n_live), bps))
    if R % rep:
        raise ValueError(f"R={R} is not a multiple of rep={rep}")
    if q.device.type == "cpu":
        return paged_kvattn_ref(q, k, k_scale, v, v_scale, block_table, pos,
                                window, rep, n_live)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_kvattn_kv8: unsupported device {q.device}")
    if D not in HEAD_DIMS or bs > MAX_BLOCK_SIZE:
        raise ValueError(f"unsupported head_dim={D} / block_size={bs}")
    checks = (("q", q, torch.bfloat16, (B, Hkv, R, D)),
              ("k", k, torch.int8, (nb, bs, Hkv, D)),
              ("v", v, torch.int8, (nb, bs, Hkv, D)),
              ("k_scale", k_scale, torch.float32, (nb, bs, Hkv)),
              ("v_scale", v_scale, torch.float32, (nb, bs, Hkv)),
              ("block_table", block_table, torch.int32, (B, bps)),
              ("pos", pos, torch.int32, (B,)))
    for name, t, dt, shape in checks:
        if t.device != q.device or t.dtype != dt or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the kernel stages K/V in 16-byte words: "
                         "misaligned pool storage offset")
    out = torch.empty_like(q)
    fn = _build.bind("paged_kvattn", "paged_kvattn_kv8", 8, 10)
    err = fn(q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
             v_scale.data_ptr(), block_table.data_ptr(), pos.data_ptr(),
             out.data_ptr(), B, Hkv, R, D, rep, nb, bs, bps, n_live,
             int(window), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_kvattn_kv8 launch failed: CUDA error {err}")
    paged_kvattn_kv8.launches += 1
    return out


paged_kvattn_kv8.launches = 0
