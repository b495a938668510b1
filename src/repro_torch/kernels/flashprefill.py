"""Flash attention for one-shot prefill: wrapper around
``csrc/flash_prefill.cu``.

Replaces the Pallas kernel ``repro.kernels.flashprefill.flash_prefill``:
causal, sliding-window or non-causal bf16 attention over head-major
q (B, H, S, D) and k/v (B, Hkv, S, D), head h reading KV head ``h // rep``,
keys at or past the true length ``seq`` masked.  The kernel takes any S
by masking (no padded copy) and skips the tiles wholly above the diagonal
or before the window.  Its tile — ``block_q`` token-major rows ``t * rep +
g`` of one KV head per block, ``block_k`` keys per tile of its K/V ring —
is chosen here from the shapes (:func:`pick_tile`), not by the caller
(the JAX default of 512 × 512 does not fit in shared memory at D 256).
CPU tensors take the plain version
(:func:`repro_torch.kernels.ref.flash_prefill_walk`, the same tile walk);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import _build
from .ref import NO_WINDOW, flash_prefill_walk

#: head dims the kernel is instantiated for (whisper-tiny REDUCED 32,
#: whisper-tiny 64, recurrentgemma-2b 256)
HEAD_DIMS = (32, 64, 128, 256)
#: bytes of shared memory a block may use, and what the kernel returns when
#: a tile needs more
MAX_SMEM, ERR_SMEM = 232448, -1
#: the row tiles the kernel takes (one warp per 16 rows), largest first
BLOCK_QS = (128, 64, 32, 16)
#: the grid below which :func:`pick_tile` takes smaller row tiles: at S
#: 127, rep 10 the 10 blocks of 128-row tiles ran 17–18 % slower than 20
#: blocks of 64 rows (``chip_smoke.py``'s tile sweep, H100)
MIN_BLOCKS = 16


def slice_keys(D: int) -> int:
    """Keys of one online-softmax slice of the kernel at head dim D: 128,
    64 at D 256 (where the registers hold the output row) — the K/V tile
    :func:`pick_tile` takes."""
    return 64 if D > 128 else 128


def smem_bytes(D: int, block_q: int, block_k: int) -> int:
    """Shared memory of a ``block_q × block_k`` tile at head dim D: the Q
    rows and a two-tile K/V ring, rows padded by 8 bf16 — ``smem_bytes``
    of csrc/flash_prefill.cu."""
    return (block_q + 4 * block_k) * (D + 8) * 2


def tiles(D: int) -> List[Tuple[int, int]]:
    """Every tile :func:`pick_tile` can choose at head dim D: a row tile
    of :data:`BLOCK_QS` by one slice of keys (all fit in shared memory)."""
    return [(bq, slice_keys(D)) for bq in BLOCK_QS]


def pick_tile(B: int, H: int, Hkv: int, S: int, D: int) -> Tuple[int, int]:
    """The kernel's tile for these shapes: the largest ``block_q`` whose
    grid ``ceil(rep·S / block_q) · Hkv · B`` has at least MIN_BLOCKS
    blocks, or as many as any row tile gives (larger blocks load each K/V
    tile for more rows), by one slice of keys."""
    rows = H // Hkv * S
    grid = {bq: -(-rows // bq) * Hkv * B for bq in BLOCK_QS}
    want = min(MIN_BLOCKS, max(grid.values()))
    return next(bq for bq in BLOCK_QS if grid[bq] >= want), slice_keys(D)


def check_tile(D: int, block_q: int, block_k: int) -> None:
    """Raise ``ValueError`` unless the kernel is built for head dim ``D``
    and the tile has its shape: block_q one of :data:`BLOCK_QS`, block_k a
    multiple of the slice (:func:`slice_keys`).  Whether the tile fits in
    shared memory the kernel decides."""
    if D not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim={D} (kernel takes "
                         f"{HEAD_DIMS})")
    if block_q not in BLOCK_QS or block_k % slice_keys(D) or block_k < 1:
        raise ValueError(f"unsupported tile block_q={block_q}, "
                         f"block_k={block_k}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  seq: Optional[int] = None,
                  tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hkv, S, D) bf16 → (B, H, S, D) bf16.

    A key is kept when ``kpos < seq`` (default S), ``kpos <= qpos`` if
    ``causal`` and ``kpos > qpos - window`` when ``window`` is an int.
    ``tile`` = (block_q, block_k) overrides :func:`pick_tile` (the tests
    run every tile it can choose; no serving caller sets it).  Counts its
    CUDA launches in ``flash_prefill.launches``."""
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
    block_q, block_k = tile or pick_tile(B, H, Hkv, S, D)
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
