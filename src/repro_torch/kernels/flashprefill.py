"""Flash attention for prefill and training: wrappers around
``csrc/flash_prefill.cu`` and its backward, ``csrc/flash_prefill_bwd.cu``.

:func:`flash_prefill` replaces the Pallas kernel
``repro.kernels.flashprefill.flash_prefill``: causal, sliding-window or
non-causal bf16 attention over head-major q (B, H, Sq, D) and k/v (B, Hkv,
Sk, D), head h reading KV head ``h // rep``, keys at or past the true
length ``seq`` masked; Sq == Sk, except non-causal attention without a
window (whisper's cross attention in training: T queries against the
encoder's frames).  It can also write each row's log-sum-exp, which
:func:`flash_prefill_bwd` recomputes the probabilities from.  The
reference has no Pallas backward: it differentiates its XLA walk
(``jax.vjp`` of ``repro/core/attention.py:92``); :class:`FlashPrefill`
binds the two kernels as one ``torch.autograd.Function``.  The forward
takes any S by masking (no padded copy) and skips the tiles wholly above
the diagonal or before the window.  Its tile — ``block_q`` token-major
rows ``t * rep + g`` of one KV head per block, ``block_k`` keys per tile
of its K/V ring — is chosen here from the shapes (:func:`pick_tile`),
not by the caller (the JAX default of 512 × 512 does not fit in shared
memory at D 256).  At gemma3-1b's head dim 288 two warps share each
16-row group (each keeps half of the output's columns), so a block holds
at most 64 rows there (:func:`block_qs`).
CPU tensors take the plain versions
(:func:`repro_torch.kernels.ref.flash_prefill_walk`, the same tile walk,
and :func:`repro_torch.kernels.ref.flash_prefill_bwd_ref`); CUDA tensors
launch the kernels or raise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import _build
from .ref import NO_WINDOW, flash_prefill_bwd_ref, flash_prefill_walk

#: head dims the kernel is instantiated for (whisper-tiny REDUCED 32,
#: whisper-tiny 64, recurrentgemma-2b 256, gemma3-1b 288)
HEAD_DIMS = (32, 64, 128, 256, 288)
#: bytes of shared memory a block may use, and what the kernel returns when
#: a tile needs more
MAX_SMEM, ERR_SMEM = 232448, -1
#: the row tiles the kernel takes (one warp per 16 rows, two at D 288; at
#: most 256 threads a block), largest first
BLOCK_QS = (128, 64, 32, 16)
#: the grid below which :func:`pick_tile` takes smaller row tiles: at S
#: 127, rep 10 the 10 blocks of 128-row tiles ran 17–18 % slower than 20
#: blocks of 64 rows (``chip_smoke.py``'s tile sweep, H100)
MIN_BLOCKS = 16


def slice_keys(D: int) -> int:
    """Keys of one online-softmax slice of the kernel at head dim D: 128,
    64 above D 128 (where the registers hold the output row) — the K/V
    tile :func:`pick_tile` takes."""
    return 64 if D > 128 else 128


def block_qs(D: int) -> Tuple[int, ...]:
    """The row tiles the kernel takes at head dim D, largest first:
    :data:`BLOCK_QS`, up to 64 rows above D 256 (two warps a 16-row
    group, ``max_rows`` of csrc/flash_prefill.cu)."""
    return tuple(bq for bq in BLOCK_QS if D <= 256 or bq <= 64)


def smem_bytes(D: int, block_q: int, block_k: int) -> int:
    """Shared memory of a ``block_q × block_k`` tile at head dim D: the Q
    rows and a two-tile K/V ring, rows padded by 8 bf16 — ``smem_bytes``
    of csrc/flash_prefill.cu."""
    return (block_q + 4 * block_k) * (D + 8) * 2


def tiles(D: int) -> List[Tuple[int, int]]:
    """Every tile :func:`pick_tile` can choose at head dim D: a row tile
    of :func:`block_qs` by one slice of keys (all fit in shared memory)."""
    return [(bq, slice_keys(D)) for bq in block_qs(D)]


def pick_tile(B: int, H: int, Hkv: int, S: int, D: int) -> Tuple[int, int]:
    """The kernel's tile for these shapes: the largest ``block_q`` whose
    grid ``ceil(rep·S / block_q) · Hkv · B`` has at least MIN_BLOCKS
    blocks, or as many as any row tile gives (larger blocks load each K/V
    tile for more rows), by one slice of keys."""
    rows = H // Hkv * S
    grid = {bq: -(-rows // bq) * Hkv * B for bq in block_qs(D)}
    want = min(MIN_BLOCKS, max(grid.values()))
    return next(bq for bq in block_qs(D) if grid[bq] >= want), slice_keys(D)


def _check_head_dim(D: int) -> None:
    """Raise ``ValueError`` unless the kernels are built for head dim D."""
    if D not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim={D} (kernel takes "
                         f"{HEAD_DIMS})")


def check_tile(D: int, block_q: int, block_k: int) -> None:
    """Raise ``ValueError`` unless the kernel is built for head dim ``D``
    and the tile has its shape: block_q one of :func:`block_qs`, block_k a
    multiple of the slice (:func:`slice_keys`).  Whether the tile fits in
    shared memory the kernel decides."""
    _check_head_dim(D)
    if block_q not in block_qs(D) or block_k % slice_keys(D) or block_k < 1:
        raise ValueError(f"unsupported tile block_q={block_q}, "
                         f"block_k={block_k}")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: Optional[int],
                  seq: Optional[int]) -> int:
    """Validate the operands of either pass; return ``seq`` (default
    Sk)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)}: expected (B, H, Sq, D) and "
                         "(B, Hkv, Sk, D) with Hkv dividing H")
    if Sq != Sk and (causal or window is not None):
        raise ValueError(f"Sq={Sq} != Sk={Sk} needs causal=False and no "
                         "window")
    seq = Sk if seq is None else int(seq)
    if not 0 < seq <= Sk:
        raise ValueError(f"seq={seq} outside (0, Sk={Sk}]")
    return seq


def _check_aligned(*ts: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the kernel stages rows in 16-byte words: "
                         "misaligned storage offset")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  seq: Optional[int] = None,
                  tile: Optional[Tuple[int, int]] = None,
                  return_lse: bool = False):
    """q (B, H, Sq, D), k/v (B, Hkv, Sk, D) bf16 → (B, H, Sq, D) bf16
    (and, with ``return_lse``, each row's f32 log-sum-exp (B, H, Sq)).

    A key is kept when ``kpos < seq`` (default Sk), ``kpos <= qpos`` if
    ``causal`` and ``kpos > qpos - window`` when ``window`` is an int;
    Sq != Sk only without either.  ``tile`` = (block_q, block_k)
    overrides :func:`pick_tile` (the tests run every tile it can choose;
    no serving caller sets it).  Without ``return_lse`` the kernel writes
    no lse and its output is the serve path's, bit for bit.  Counts its
    CUDA launches in ``flash_prefill.launches``."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    seq = _check_shapes(q, k, v, causal, window, seq)
    win = NO_WINDOW if window is None else int(window)
    block_q, block_k = tile or pick_tile(B, H, Hkv, Sq, D)
    if q.device.type == "cpu":
        return flash_prefill_walk(q, k, v, causal, win, seq, block_q,
                                  block_k, return_lse=return_lse)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_prefill: unsupported device {q.device}")
    check_tile(D, block_q, block_k)
    _build.check_operands(q.device, (
        ("q", q, torch.bfloat16, (B, H, Sq, D)),
        ("k", k, torch.bfloat16, (B, Hkv, Sk, D)),
        ("v", v, torch.bfloat16, (B, Hkv, Sk, D))))
    _check_aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    fn = _build.bind("flash_prefill", "flash_prefill", 5, 11)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), B, H, Hkv, Sq, Sk, D,
             seq, int(causal), win, block_q, block_k,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err == ERR_SMEM:
        raise ValueError(
            f"flash_prefill: a {block_q} x {block_k} tile at head_dim {D} "
            "needs more shared memory than a block may use (227 KB); use a "
            "smaller tile")
    if err:
        raise RuntimeError(f"flash_prefill launch failed: CUDA error {err}")
    flash_prefill.launches += 1
    return (out, lse) if return_lse else out


flash_prefill.launches = 0


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None):
    """dq, dk, dv (bf16, the shapes of q, k, v) of :func:`flash_prefill`
    from its operands, its output, its lse and the output's gradient
    ``dout`` (B, H, Sq, D) bf16, with the forward's masks.  Three kernels
    on the card, in order: D_i = rowsum(dO ∘ O), dK/dV by key tiles, dQ
    by row tiles (no atomics: the gradients repeat bit for bit).  Counts
    its CUDA calls in ``flash_prefill_bwd.launches``."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    seq = _check_shapes(q, k, v, causal, window, None)
    win = NO_WINDOW if window is None else int(window)
    if q.device.type == "cpu":
        return flash_prefill_bwd_ref(q, k, v, out, lse, dout, causal, win,
                                     seq)
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_prefill_bwd: unsupported device {q.device}")
    _check_head_dim(D)
    _build.check_operands(q.device, (
        ("q", q, torch.bfloat16, (B, H, Sq, D)),
        ("k", k, torch.bfloat16, (B, Hkv, Sk, D)),
        ("v", v, torch.bfloat16, (B, Hkv, Sk, D)),
        ("out", out, torch.bfloat16, (B, H, Sq, D)),
        ("lse", lse, torch.float32, (B, H, Sq)),
        ("dout", dout, torch.bfloat16, (B, H, Sq, D))))
    _check_aligned(q, k, v, out, dout)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _build.bind("flash_prefill_bwd", "flash_prefill_bwd", 10, 9)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), delta.data_ptr(), B, H, Hkv, Sq, Sk, D, seq,
             int(causal), win,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"flash_prefill_bwd launch failed: CUDA error {err}")
    flash_prefill_bwd.launches += 1
    return dq, dk, dv


flash_prefill_bwd.launches = 0


class FlashPrefill(torch.autograd.Function):
    """:func:`flash_prefill` with its gradient: the forward also writes
    the lse, the backward is :func:`flash_prefill_bwd` (the kernels on
    CUDA tensors, the plain versions on CPU tensors; no fallback between
    them).  Operands as :func:`flash_prefill`'s, the tile its wrapper's
    pick."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = flash_prefill(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(
            q, k, v, out, lse, dout.to(q.dtype).contiguous(),
            causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
