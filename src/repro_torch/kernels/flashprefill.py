"""Flash attention for one-shot prefill: wrapper around
``csrc/flash_prefill.cu``.

Replaces the Pallas kernel ``repro.kernels.flashprefill.flash_prefill``:
causal, sliding-window or non-causal bf16 attention over head-major
q (B, H, S, D) and k/v (B, Hkv, S, D), head h reading KV head ``h // rep``,
keys at or past the true length ``seq`` masked.  The kernel picks its own
tiles (``block_q`` query rows per block, ``block_k`` keys per staged tile;
the JAX default of 512 × 512 does not fit in shared memory at D 256), takes
any S by masking (no padded copy) and skips the tiles wholly above the
diagonal or before the window.  CPU tensors take the plain version
(:func:`repro_torch.kernels.ref.flash_prefill_walk`, the same tile walk);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import NO_WINDOW, flash_prefill_walk

#: head dims the kernel is instantiated for (whisper-tiny REDUCED 32,
#: whisper-tiny 64, recurrentgemma-2b 256)
HEAD_DIMS = (32, 64, 128, 256)
#: the kernel's default tile: 4 warps × 16 query rows, 64-key K/V tiles
BLOCK_Q, BLOCK_K = 64, 64
#: returned by the kernel when a tile does not fit in the 227 KB of shared
#: memory a block may use
ERR_SMEM = -1


def check_tile(D: int, block_q: int, block_k: int) -> None:
    """Raise ``ValueError`` unless the kernel is built for head dim ``D``
    and the tile has its shape: block_q a multiple of 16 up to 128 (one
    warp per 16 rows), block_k a multiple of 64 (the online-softmax
    slice).  Whether the tile fits in shared memory the kernel decides."""
    if D not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim={D} (kernel takes "
                         f"{HEAD_DIMS})")
    if block_q % 16 or not 16 <= block_q <= 128 or block_k % 64 or \
            block_k < 64:
        raise ValueError(f"unsupported tile block_q={block_q}, "
                         f"block_k={block_k}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  seq: Optional[int] = None, block_q: int = BLOCK_Q,
                  block_k: int = BLOCK_K) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hkv, S, D) bf16 → (B, H, S, D) bf16.

    A key is kept when ``kpos < seq`` (default S), ``kpos <= qpos`` if
    ``causal`` and ``kpos > qpos - window`` when ``window`` is an int.
    Counts its CUDA launches in ``flash_prefill.launches``."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)}: expected (B, H, S, D) and "
                         "(B, Hkv, S, D) with Hkv dividing H")
    seq = S if seq is None else int(seq)
    if not 0 < seq <= S:
        raise ValueError(f"seq={seq} outside (0, S={S}]")
    win = NO_WINDOW if window is None else int(window)
    if q.device.type == "cpu":
        return flash_prefill_walk(q, k, v, causal, win, seq, block_q,
                                  block_k)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_prefill: unsupported device {q.device}")
    check_tile(D, block_q, block_k)
    _build.check_operands(q.device, (
        ("q", q, torch.bfloat16, (B, H, S, D)),
        ("k", k, torch.bfloat16, (B, Hkv, S, D)),
        ("v", v, torch.bfloat16, (B, Hkv, S, D))))
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the kernel stages rows in 16-byte words: "
                         "misaligned storage offset")
    out = torch.empty_like(q)
    fn = _build.bind("flash_prefill", "flash_prefill", 4, 10)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
             Hkv, S, D, seq, int(causal), win, block_q, block_k,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err == ERR_SMEM:
        raise ValueError(
            f"flash_prefill: a {block_q} x {block_k} tile at head_dim {D} "
            "needs more shared memory than a block may use (227 KB); use a "
            "smaller tile")
    if err:
        raise RuntimeError(f"flash_prefill launch failed: CUDA error {err}")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
