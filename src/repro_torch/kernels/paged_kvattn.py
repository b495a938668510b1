"""Multi-query paged attention: wrapper around ``csrc/paged_kvattn.cu``.

Replaces the Pallas kernel
``repro.kernels.paged_kvattn.paged_kvattn_decode_grouped`` (every KV
format): flash-decoding straight over the block pool, the block table read
inside the kernel, one kernel for prefill chunks and decode.  CPU tensors
take the plain version (:func:`repro_torch.kernels.ref.paged_kvattn_ref`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import FormatSpec

from repro_torch.roofline import op_cost

from . import _build
from . import cost as KC
from .kvattn import HEAD_DIMS, kv_format, raise_on_error
from .ref import paged_kvattn_ref


def paged_kvattn(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
                 v: torch.Tensor, v_scale: torch.Tensor,
                 block_table: torch.Tensor, pos: torch.Tensor, window: int,
                 rep: int, n_live: int, spec: FormatSpec) -> torch.Tensor:
    """q (B, Hkv, R, D) bf16 token-major rows; pool k/v (n_blocks,
    block_size, Hkv, Dstore) stored in ``spec`` with scales (n_blocks,
    block_size, Hkv) f32; block_table (B, blocks_per_slot) int32; pos (B,)
    int32; ``n_live`` logical blocks are visited.  Returns (B, Hkv, R, D)
    bf16.  Counts its CUDA launches in ``paged_kvattn.launches``; declares
    its cost to an active ``roofline.op_cost`` counter."""
    if op_cost.COUNTER is not None and not op_cost.COUNTER.paused:
        return op_cost.COUNTER.kernel(
            "paged_kvattn", KC.of_paged_kvattn, paged_kvattn, q, k, k_scale,
            v, v_scale, block_table, pos, window, rep, n_live, spec)
    B, Hkv, R, D = q.shape
    nb, bs = k.shape[0], k.shape[1]
    bps = block_table.shape[1]
    n_live = max(1, min(int(n_live), bps))
    if R % rep:
        raise ValueError(f"R={R} is not a multiple of rep={rep}")
    fmt = kv_format(spec, k, D)
    if q.device.type == "cpu":
        return paged_kvattn_ref(q, k, k_scale, v, v_scale, block_table, pos,
                                window, rep, n_live)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_kvattn: unsupported device {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim={D}")
    ds = k.shape[-1]
    _build.check_operands(q.device, (
        ("q", q, torch.bfloat16, (B, Hkv, R, D)),
        ("k", k, spec.dtype, (nb, bs, Hkv, ds)),
        ("v", v, spec.dtype, (nb, bs, Hkv, ds)),
        ("k_scale", k_scale, torch.float32, (nb, bs, Hkv)),
        ("v_scale", v_scale, torch.float32, (nb, bs, Hkv)),
        ("block_table", block_table, torch.int32, (B, bps)),
        ("pos", pos, torch.int32, (B,))))
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the kernel stages K/V in 16-byte words: "
                         "misaligned pool storage offset")
    out = torch.empty_like(q)
    fn = _build.bind("paged_kvattn", "paged_kvattn", 8, 11)
    err = fn(q.data_ptr(), k.data_ptr(), k_scale.data_ptr(), v.data_ptr(),
             v_scale.data_ptr(), block_table.data_ptr(), pos.data_ptr(),
             out.data_ptr(), fmt, B, Hkv, R, D, rep, nb, bs, bps, n_live,
             int(window), torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error("paged_kvattn", err, D, bs)
    paged_kvattn.launches += 1
    return out


paged_kvattn.launches = 0
