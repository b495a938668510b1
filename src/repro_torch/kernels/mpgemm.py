"""W4A16 mixed-precision GEMM: wrapper around ``csrc/mpgemm.cu``.

Replaces the Pallas kernel ``repro.kernels.mpgemm.mpgemm_2d`` (bits=4):
``y = x @ W`` with W kept 4-bit all the way into the kernel — nibble
unpack, I2F, per-group scale and bf16 rounding happen on the tile in
shared memory, accumulation is f32.  CPU tensors take the plain version
(:func:`repro_torch.kernels.ref.mpgemm_ref`); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PackedWeight

from . import _build
from .ref import mpgemm_ref

#: K-tile heights the kernel is instantiated for; bn must be a multiple
#: of its 32-column slice (csrc/mpgemm.cu)
BLOCK_KS = (32, 64, 128)


def mpgemm_w4a16(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """y (M, N) bf16 = x (M, K) bf16 @ W, W packed int4 with group == bk.

    Any M (ragged row tiles are masked in the kernel).  Counts its CUDA
    launches in ``mpgemm_w4a16.launches``.
    """
    K, N = w.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match W {w.shape}")
    if x.device.type == "cpu":
        return mpgemm_ref(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"mpgemm_w4a16: unsupported device {x.device}")
    bk, bn = w.block_k, w.block_n
    if w.bits != 4 or w.group != bk:
        raise ValueError(f"kernel takes bits=4 with group == block_k "
                         f"(got bits={w.bits}, group={w.group}, bk={bk})")
    if bk not in BLOCK_KS or bn % 32:
        raise ValueError(f"unsupported tile (bk={bk}, bn={bn})")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("x must be contiguous bf16")
    for name, t, dt in (("data", w.data, torch.int8),
                        ("scales", w.scales, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"W.{name} must be contiguous {dt} on {x.device}")
    if tuple(w.data.shape) != (K // bk, N // bn, bk // 2, bn):
        raise ValueError(f"W.data shape {tuple(w.data.shape)} is not the "
                         f"tile-major int4 layout of {w.shape}")
    if w.data.data_ptr() % 16 or x.data_ptr() % 4:
        raise ValueError("the kernel reads W in 16-byte and x in 4-byte "
                         "words: misaligned storage offset")
    M = x.shape[0]
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return y
    fn = _build.bind("mpgemm", "mpgemm_w4a16", 4, 5)
    err = fn(x.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
             y.data_ptr(), M, K, N, bk, bn,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mpgemm_w4a16 launch failed: CUDA error {err}")
    mpgemm_w4a16.launches += 1
    return y


mpgemm_w4a16.launches = 0
