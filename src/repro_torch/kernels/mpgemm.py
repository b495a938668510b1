"""Mixed-precision GEMMs over fragment-order packed weights: wrappers
around ``csrc/mpgemm.cu`` (A16) and ``csrc/mpgemm_int8.cu`` (A8), which
share the mainloop of ``csrc/gemm_tile.cuh``.

* :func:`mpgemm_a16` replaces the Pallas kernel
  ``repro.kernels.mpgemm.mpgemm_2d`` (bits 4 and 8): ``y = x @ W`` with W
  kept in its stored width all the way into the kernel — nibble unpack,
  int→float, per-group scale and bf16 rounding happen in registers,
  accumulation is f32.
* :func:`mpgemm_int8` replaces ``repro.kernels.mpgemm.mpgemm_int8_2d``
  (W4A8 / W8A8): s8×s8→s32 per group × group scale, × per-token
  activation scale at the store.

CPU tensors take the plain versions (:mod:`repro_torch.kernels.ref`), which
read either layout; CUDA tensors launch the kernels or raise.  Each kernel
takes only its own fragment layout (``core.packing.to_kernel_layout``,
which the engine applies to every packed weight on the card, for the
kernel its policy routes to): any other layout raises instead of being
repacked per call.  K is any multiple of 64 and of the group, or, at
group 32, 32 times an odd number (the Pallas GEMMs' block_k 32): the
last 64-deep chunk then holds 32 real rows, and the kernels zero-fill
the rest of its x columns and scale rows.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import (FRAG_K, FRAG_N, KERNEL_LAYOUTS,
                                      PackedWeight, frag_chunks)

from repro_torch.roofline import op_cost

from . import _build
from . import cost as KC
from .ref import mpgemm_int8_ref, mpgemm_ref

#: weight groups the kernels are built for
GROUPS = (32, 64, 128)


def _check_weight(x: torch.Tensor, w: PackedWeight, kernel: str) -> None:
    """What kernel ``kernel`` ("a16" or "a8") takes of a packed weight on
    ``x``'s device."""
    K, N = w.shape
    if w.layout != KERNEL_LAYOUTS[kernel]:
        raise ValueError(
            f"the {kernel} GEMM takes the {KERNEL_LAYOUTS[kernel]!r} "
            f"fragment layout (core.packing.to_kernel_layout(w, "
            f"{kernel!r})), got a {w.layout!r}-layout weight")
    if w.bits not in (4, 8) or w.group not in GROUPS or K % 32 or \
            K % w.group or (K % FRAG_K and w.group != 32) or N % FRAG_N:
        raise ValueError(f"kernel takes bits 4 or 8, group in {GROUPS}, "
                         f"K a multiple of 64 and of group (or of 32 at "
                         f"group 32), N of 16 (got bits={w.bits}, "
                         f"group={w.group}, shape={w.shape})")
    _build.check_operands(x.device, (
        ("W.data", w.data, torch.int8,
         (N // FRAG_N, frag_chunks(K), 32, 4 * w.bits)),
        ("W.scales", w.scales, torch.float32, (K // w.group, N))))
    if any(t.data_ptr() % 16 for t in (x, w.data, w.scales)):
        raise ValueError("the kernels copy x, W and its scales in 16-byte "
                         "pieces: misaligned storage offset")


def mpgemm_a16(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """y (M, N) bf16 = x (M, K) bf16 @ W, W packed at bits 4 or 8.  Any M
    (ragged token tiles are masked in the kernel).
    Counts its CUDA launches in ``mpgemm_a16.launches``; declares its
    cost to an active ``roofline.op_cost`` counter."""
    if op_cost.COUNTER is not None and not op_cost.COUNTER.paused:
        return op_cost.COUNTER.kernel("mpgemm_a16", KC.of_mpgemm_a16,
                                      mpgemm_a16, x, w)
    K, N = w.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match W {w.shape}")
    if x.device.type == "cpu":
        return mpgemm_ref(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"mpgemm_a16: unsupported device {x.device}")
    M = x.shape[0]
    _build.check_operands(x.device, (("x", x, torch.bfloat16, (M, K)),))
    _check_weight(x, w, "a16")
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return y
    fn = _build.bind("mpgemm", "mpgemm_a16", 4, 5)
    err = fn(x.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
             y.data_ptr(), w.bits, M, K, N, w.group,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"mpgemm_a16 launch failed: CUDA error {err}")
    mpgemm_a16.launches += 1
    return y


mpgemm_a16.launches = 0


def mpgemm_int8(xq: torch.Tensor, xscale: torch.Tensor,
                w: PackedWeight) -> torch.Tensor:
    """y (M, N) bf16 = (xq (M, K) int8 @ W_int) × group scales × xscale
    (M, 1) f32, W packed at bits 4 or 8.  Any M.  Counts
    its CUDA launches in ``mpgemm_int8.launches``; declares its cost to an
    active ``roofline.op_cost`` counter."""
    if op_cost.COUNTER is not None and not op_cost.COUNTER.paused:
        return op_cost.COUNTER.kernel("mpgemm_int8", KC.of_mpgemm_int8,
                                      mpgemm_int8, xq, xscale, w)
    K, N = w.shape
    if xq.dim() != 2 or xq.shape[1] != K:
        raise ValueError(f"x {tuple(xq.shape)} does not match W {w.shape}")
    if xq.device.type == "cpu":
        return mpgemm_int8_ref(xq, xscale, w)
    if xq.device.type != "cuda":
        raise RuntimeError(f"mpgemm_int8: unsupported device {xq.device}")
    M = xq.shape[0]
    _build.check_operands(xq.device, (
        ("xq", xq, torch.int8, (M, K)),
        ("xscale", xscale, torch.float32, (M, 1))))
    _check_weight(xq, w, "a8")
    y = torch.empty((M, N), dtype=torch.bfloat16, device=xq.device)
    if M == 0:
        return y
    fn = _build.bind("mpgemm_int8", "mpgemm_int8", 5, 5)
    err = fn(xq.data_ptr(), xscale.data_ptr(), w.data.data_ptr(),
             w.scales.data_ptr(), y.data_ptr(), w.bits, M, K, N, w.group,
             torch.cuda.current_stream(xq.device).cuda_stream)
    if err:
        raise RuntimeError(f"mpgemm_int8 launch failed: CUDA error {err}")
    mpgemm_int8.launches += 1
    return y


mpgemm_int8.launches = 0
