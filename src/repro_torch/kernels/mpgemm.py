"""Mixed-precision GEMMs over tile-major packed weights: wrappers around
``csrc/mpgemm.cu`` (A16) and ``csrc/mpgemm_int8.cu`` (A8).

* :func:`mpgemm_a16` replaces the Pallas kernel
  ``repro.kernels.mpgemm.mpgemm_2d`` (bits 4 and 8): ``y = x @ W`` with W
  kept in its stored width all the way into the kernel — nibble unpack,
  I2F, per-group scale and bf16 rounding happen on the tile in shared
  memory, accumulation is f32.
* :func:`mpgemm_int8` replaces ``repro.kernels.mpgemm.mpgemm_int8_2d``
  (W4A8 / W8A8): s8×s8→s32 per K tile × group scale, × per-token
  activation scale at the store.

CPU tensors take the plain versions (:mod:`repro_torch.kernels.ref`); CUDA
tensors launch the kernels or raise.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PackedWeight

from . import _build
from .ref import mpgemm_int8_ref, mpgemm_ref

#: K-tile heights the kernels are instantiated for; bn must be a multiple
#: of their 32-column slice
BLOCK_KS = (32, 64, 128)


def _check_weight(x: torch.Tensor, w: PackedWeight) -> None:
    """What both kernels take of a packed weight on ``x``'s device."""
    K, N = w.shape
    bk, bn = w.block_k, w.block_n
    if w.bits not in (4, 8) or w.group != bk:
        raise ValueError(f"kernel takes bits 4 or 8 with group == block_k "
                         f"(got bits={w.bits}, group={w.group}, bk={bk})")
    if bk not in BLOCK_KS or bn % 32:
        raise ValueError(f"unsupported tile (bk={bk}, bn={bn})")
    _build.check_operands(x.device, (
        ("W.data", w.data, torch.int8,
         (K // bk, N // bn, bk * w.bits // 8, bn)),
        ("W.scales", w.scales, torch.float32, (K // bk, N))))
    if w.data.data_ptr() % 16 or x.data_ptr() % 4:
        raise ValueError("the kernels read W in 16-byte and x in 4-byte "
                         "words: misaligned storage offset")


def mpgemm_a16(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """y (M, N) bf16 = x (M, K) bf16 @ W, W packed at bits 4 or 8 with
    group == bk.  Any M (ragged row tiles are masked in the kernel).
    Counts its CUDA launches in ``mpgemm_a16.launches``."""
    K, N = w.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match W {w.shape}")
    if x.device.type == "cpu":
        return mpgemm_ref(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"mpgemm_a16: unsupported device {x.device}")
    M = x.shape[0]
    _build.check_operands(x.device, (("x", x, torch.bfloat16, (M, K)),))
    _check_weight(x, w)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return y
    fn = _build.bind("mpgemm", "mpgemm_a16", 4, 6)
    err = fn(x.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
             y.data_ptr(), w.bits, M, K, N, w.block_k, w.block_n,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mpgemm_a16 launch failed: CUDA error {err}")
    mpgemm_a16.launches += 1
    return y


mpgemm_a16.launches = 0


def mpgemm_int8(xq: torch.Tensor, xscale: torch.Tensor,
                w: PackedWeight) -> torch.Tensor:
    """y (M, N) bf16 = (xq (M, K) int8 @ W_int) × group scales × xscale
    (M, 1) f32, W packed at bits 4 or 8 with group == bk.  Any M.  Counts
    its CUDA launches in ``mpgemm_int8.launches``."""
    K, N = w.shape
    if xq.dim() != 2 or xq.shape[1] != K:
        raise ValueError(f"x {tuple(xq.shape)} does not match W {w.shape}")
    if xq.device.type == "cpu":
        return mpgemm_int8_ref(xq, xscale, w)
    if xq.device.type != "cuda":
        raise RuntimeError(f"mpgemm_int8: unsupported device {xq.device}")
    M = xq.shape[0]
    if K % 4:
        raise ValueError(f"K={K} is not a multiple of 4")
    _build.check_operands(xq.device, (
        ("xq", xq, torch.int8, (M, K)),
        ("xscale", xscale, torch.float32, (M, 1))))
    _check_weight(xq, w)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    if M == 0:
        return y
    fn = _build.bind("mpgemm_int8", "mpgemm_int8", 5, 6)
    err = fn(xq.data_ptr(), xscale.data_ptr(), w.data.data_ptr(),
             w.scales.data_ptr(), y.data_ptr(), w.bits, M, K, N, w.block_k,
             w.block_n, torch.cuda.current_stream(xq.device).cuda_stream)
    if err:
        raise RuntimeError(f"mpgemm_int8 launch failed: CUDA error {err}")
    mpgemm_int8.launches += 1
    return y


mpgemm_int8.launches = 0
