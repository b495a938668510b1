"""Flash attention for prefill and training: wrappers around
``csrc/flash_prefill.cu`` and its backward, ``csrc/flash_prefill_bwd.cu``.

:func:`flash_prefill` replaces the Pallas kernel
``repro.kernels.flashprefill.flash_prefill``: causal, sliding-window or
non-causal bf16 attention over head-major q (B, H, Sq, D) and k/v (B, Hkv,
Sk, D), head h reading KV head ``h // rep``, keys at or past the true
length ``seq`` masked, query row t at position ``pos_offset + t`` (a
rank's rows of sequence-parallel prefill, ``launch/spattn.py``; 0 on the
serve and training paths, where Sq == Sk or the attention is non-causal
without a window: whisper's cross attention in training).  It can also
write each row's log-sum-exp, which :func:`flash_prefill_bwd` recomputes
the probabilities from.  The
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

import ctypes
import dataclasses
import functools
import heapq
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.roofline import op_cost

from . import _build
from . import cost as KC
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
                  seq: Optional[int], pos_offset: int) -> int:
    """Validate the operands of either pass; return ``seq`` (default
    Sk)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Sk, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)}: expected (B, H, Sq, D) and "
                         "(B, Hkv, Sk, D) with Hkv dividing H")
    if pos_offset < 0:
        raise ValueError(f"pos_offset={pos_offset} < 0")
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
                  return_lse: bool = False, pos_offset: int = 0):
    """q (B, H, Sq, D), k/v (B, Hkv, Sk, D) bf16 → (B, H, Sq, D) bf16
    (and, with ``return_lse``, each row's f32 log-sum-exp (B, H, Sq)).

    Query row t sits at position ``qpos = pos_offset + t``.  A key is
    kept when ``kpos < seq`` (default Sk), ``kpos <= qpos`` if
    ``causal`` and ``kpos > qpos - window`` when ``window`` is an int.
    ``tile`` = (block_q, block_k)
    overrides :func:`pick_tile` (the tests run every tile it can choose;
    no serving caller sets it).  Without ``return_lse`` the kernel writes
    no lse and its output is the serve path's, bit for bit.  Counts its
    CUDA launches in ``flash_prefill.launches``; declares its cost to an
    active ``roofline.op_cost`` counter."""
    if op_cost.COUNTER is not None and not op_cost.COUNTER.paused:
        return op_cost.COUNTER.kernel(
            "flash_prefill", KC.of_flash_prefill, flash_prefill, q, k, v,
            causal=causal, window=window, seq=seq, tile=tile,
            return_lse=return_lse, pos_offset=pos_offset)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    off = int(pos_offset)
    seq = _check_shapes(q, k, v, seq, off)
    win = NO_WINDOW if window is None else int(window)
    block_q, block_k = tile or pick_tile(B, H, Hkv, Sq, D)
    if q.device.type == "cpu":
        return flash_prefill_walk(q, k, v, causal, win, seq, block_q,
                                  block_k, return_lse=return_lse,
                                  pos_offset=off)
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
    fn = _build.bind("flash_prefill", "flash_prefill", 5, 12)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), B, H, Hkv, Sq, Sk, D,
             seq, int(causal), win, off, block_q, block_k,
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


#: the backward's blocks (``csrc/flash_prefill_bwd.cu``): a dK/dV block
#: owns BWD_KEYS keys of one KV head, a dQ block BWD_ROWS packed rows
BWD_KEYS = BWD_ROWS = 64
#: the grids the plan weighs, in waves of the card's resident blocks
#: (besides cutting no walk); it keeps the one whose simulated schedule
#: ends first
BWD_WAVES = tuple(w / 4 for w in range(2, 17))
#: no split walks fewer steps: each split reloads its block's tile and
#: writes and rereads an f32 partial
BWD_MIN_STEPS = 2
#: a block's fixed cost in steps of its walk, for the simulated schedule:
#: loading its tile and the ring's first stages, writing its output
BWD_BLOCK_STEPS = 2
#: f32 partials a pass (dK/dV, dQ) may allocate; the plan takes longer
#: splits rather than more
BWD_SCRATCH_CAP = 48 << 20


def bwd_kv_step(D: int) -> int:
    """Packed rows per step of a dK/dV walk at head dim D (``kv_step``
    of the kernel)."""
    return 64 if D <= 64 else 32


def bwd_q_step(D: int) -> int:
    """Keys per step of a dQ walk at head dim D (``q_step``)."""
    return 64 if D <= 128 else 32


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward's work for one shape, the same for every batch row and
    KV head.  ``kv_items`` (n, 4) int32: one dK/dV block each — key tile,
    first and end packed row of its walk, slot (-1: the tile's only
    block, which writes bf16 itself; else its f32 partial's index in the
    scratch).  ``kv_tiles`` (key tiles, 2): splits, first slot.
    ``q_items`` / ``q_tiles`` likewise for dQ: row tile, first and end
    key.  The kernels read these arrays (:meth:`table`).  ``dq_first``:
    the dQ pass starts with the call, before D_i and dK/dV (its simulated
    schedule is the longer), else after D_i, beside dK/dV."""
    kv_items: np.ndarray
    kv_tiles: np.ndarray
    q_items: np.ndarray
    q_tiles: np.ndarray
    dq_first: bool = False

    @property
    def kv_slots(self) -> int:
        """dK/dV blocks that write an f32 partial (one slot each)."""
        return int((self.kv_items[:, 3] >= 0).sum())

    @property
    def q_slots(self) -> int:
        """dQ blocks that write an f32 partial (one slot each)."""
        return int((self.q_items[:, 3] >= 0).sum())

    def scratch_bytes(self, B: int, Hkv: int, D: int) -> Tuple[int, int]:
        """f32 bytes of the dK + dV partials and of the dQ partials."""
        one = B * Hkv * BWD_KEYS * D * 4
        return 2 * self.kv_slots * one, self.q_slots * one

    def table(self) -> np.ndarray:
        """The four arrays in one int32 vector, in field order."""
        return np.concatenate([a.ravel() for a in (
            self.kv_items, self.kv_tiles, self.q_items, self.q_tiles)])


def _kept(t: np.ndarray, k0, k1, causal: bool, window: int) -> np.ndarray:
    """Keys of [k0, k1) that query position(s) ``t`` keep (the mask's
    kpos < seq folded into k1)."""
    hi = np.minimum(k1, t + 1) if causal else k1
    return np.maximum(hi - np.maximum(k0, t - window + 1), 0)


def _kv_walks(rep, Sq, Sk, kv_len, causal, window, step, off):
    """Per key tile: the packed rows [r_lo, r_hi) whose token (at position
    ``off + t``) can see one of its keys, and the kept pairs of each
    ``step`` rows of that walk."""
    out = []
    for k0 in range(0, Sk, BWD_KEYS):
        k1 = min(k0 + BWD_KEYS, kv_len)
        t_lo = min(max(0, k0 - off), Sq) if causal else 0
        t_hi = Sq - 1 if window >= NO_WINDOW else \
            min(Sq - 1, k1 - 1 + window - 1 - off)
        r_lo = t_lo * rep
        r_hi = (t_hi + 1) * rep if k0 < kv_len and t_lo <= t_hi else r_lo
        kept = _kept(off + np.arange(r_lo, r_hi) // rep, k0, k1, causal,
                     window)
        pad = -len(kept) % step
        out.append((r_lo, r_hi, np.pad(kept, (0, pad)).reshape(-1, step)
                    .sum(1)))
    return out


def _q_walks(rep, Sq, kv_len, causal, window, step, off):
    """Per tile of BWD_ROWS packed rows: its first key slice and the kept
    pairs of each ``step`` keys from there to the last slice that can
    hold a kept key (row tokens at positions ``off + t``)."""
    out = []
    NR = rep * Sq
    for r0 in range(0, NR, BWD_ROWS):
        t = off + np.arange(r0, min(r0 + BWD_ROWS, NR)) // rep
        hi = min(kv_len, t[-1] + 1) if causal else kv_len
        s0 = max(0, t[0] - window + 1) // step
        s1 = max(s0, -(-hi // step))
        k0 = np.arange(s0, s1)[:, None] * step
        kept = _kept(t[None], k0, np.minimum(k0 + step, kv_len), causal,
                     window).sum(1)
        out.append((s0, kept))
    return out


def _cut(walks, chunk, reps, slot_bytes):
    """Each walk (kept pairs per step) cut into splits of near-equal kept
    pairs, as many as its pairs over ``chunk``, the chunk doubled until
    the partials of ``reps`` repeats of the walks (batch rows x KV heads)
    fit in BWD_SCRATCH_CAP.  Returns each walk's step bounds."""
    while True:
        bounds = []
        for w in walks:
            m = min(len(w), max(1, math.ceil(w.sum() / chunk)))
            cuts = np.searchsorted(np.cumsum(w), w.sum() * np.arange(1, m)
                                   / m, side="left") + 1
            bounds.append([0, *np.unique(np.clip(cuts, 1, len(w) - 1)),
                           len(w)] if m > 1 else [0, len(w)])
        slots = sum(len(b) - 1 for b in bounds if len(b) > 2)
        if slots * reps * slot_bytes <= BWD_SCRATCH_CAP:
            return bounds
        chunk *= 2


def _items(bounds):
    """(walk, first step, end step, slot) per split, longest first (the
    card starts blocks in grid order, so the longest do not come last),
    and (splits, first slot) per walk; a walk of one split writes its
    output itself."""
    items, tiles, slot = [], [], 0
    for w, b in enumerate(bounds):
        n = len(b) - 1
        tiles.append((n, slot if n > 1 else -1))
        for i in range(n):
            items.append((w, b[i], b[i + 1], slot + i if n > 1 else -1))
        slot += n if n > 1 else 0
    items.sort(key=lambda it: it[1] - it[2])       # stable: longest first
    return items, np.asarray(tiles, np.int32).reshape(-1, 2)


def _makespan(steps, reps, slots):
    """When the last block ends if ``reps`` repeats of blocks of ``steps``
    steps (+ BWD_BLOCK_STEPS each) start in grid order, each on the first
    of ``slots`` resident places to free up."""
    ends = [0.0] * slots
    for _ in range(reps):
        for n in steps:
            heapq.heapreplace(ends, ends[0] + n + BWD_BLOCK_STEPS)
    return max(ends)


def _split(walks, reps, slots, min_pairs, slot_bytes):
    """The cut of ``walks`` (kept pairs per step) whose simulated schedule
    on ``slots`` resident blocks ends first, among no cut and chunks that
    give BWD_WAVES waves (no split under ``min_pairs``).  Returns that
    schedule's length in steps and the items and tiles of
    :func:`_items`."""
    total = sum(int(w.sum()) for w in walks) * reps
    best = None
    for waves in (0, *BWD_WAVES):
        chunk = max(total / (waves * slots), min_pairs) if waves else \
            float("inf")
        items, tiles = _items(_cut(walks, chunk, reps, slot_bytes))
        t = _makespan([b - a for _, a, b, _ in items], reps, slots)
        if best is None or t < best[0]:
            best = (t, items, tiles)
    return best


@functools.lru_cache(maxsize=256)
def bwd_plan(B: int, H: int, Hkv: int, Sq: int, Sk: int, D: int,
             causal: bool, window: int, seq: int, sms: int = 132,
             resident: Tuple[int, int] = (2, 2),
             pos_offset: int = 0) -> BwdPlan:
    """The backward's work plan: each dK/dV walk (a key tile's rows) and
    each dQ walk (a row tile's keys) cut into splits of near-equal kept
    pairs, so that the walks of the causal triangle balance, as finely as
    fills the ``resident`` (dK/dV, dQ) blocks of each of ``sms`` SMs best
    (the card's counts on the card; :func:`_split`).  ``window`` is
    :data:`NO_WINDOW` for none; keys at or past ``seq`` are masked; query
    token t sits at position ``pos_offset + t``."""
    rep, kv_len = H // Hkv, min(seq, Sk)
    one = BWD_KEYS * D * 4
    step = bwd_kv_step(D)
    walks = _kv_walks(rep, Sq, Sk, kv_len, causal, window, step, pos_offset)
    # the passes run side by side: a block that fills an SM takes turns
    # with the other pass's, so each is planned for half the SMs; smaller
    # blocks share an SM with the other pass's and fill their own slots
    slots = [sms * r if r > 1 else max(1, sms // 2) for r in resident]
    t_kv, items, kv_tiles = _split([w for _, _, w in walks], B * Hkv,
                                   slots[0], BWD_MIN_STEPS * BWD_KEYS * step,
                                   2 * one)
    t_kv *= 4 * step            # 4 products of BWD_KEYS x step a dK/dV step
    kv_items = np.asarray(
        [(x, walks[x][0] + a * step,
          min(walks[x][0] + b * step, walks[x][1]), s)
         for x, a, b, s in items], np.int32).reshape(-1, 4)
    step = bwd_q_step(D)
    walks = _q_walks(rep, Sq, kv_len, causal, window, step, pos_offset)
    t_q, items, q_tiles = _split([w for _, w in walks], B * Hkv, slots[1],
                                 BWD_MIN_STEPS * BWD_ROWS * step, one)
    t_q *= 3 * step             # 3 products of BWD_ROWS x step a dQ step
    q_items = np.asarray([(y, (walks[y][0] + a) * step,
                           (walks[y][0] + b) * step, s)
                          for y, a, b, s in items], np.int32).reshape(-1, 4)
    for a in (kv_items, kv_tiles, q_items, q_tiles):
        a.flags.writeable = False
    return BwdPlan(kv_items, kv_tiles, q_items, q_tiles, bool(t_q >= t_kv))


@functools.lru_cache(maxsize=None)
def _card(index: int, D: int) -> Tuple[int, Tuple[int, int]]:
    """(SMs, resident dK/dV and dQ blocks an SM holds at head dim D) of
    card ``index``, as the CUDA runtime reports them."""
    fn = _build.load("flash_prefill_bwd").flash_prefill_bwd_occupancy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(index):
        err = fn(ctypes.addressof(out), D)
    if err:
        raise RuntimeError(f"flash_prefill_bwd occupancy: CUDA error {err}")
    return (torch.cuda.get_device_properties(index).multi_processor_count,
            (max(1, out[0]), max(1, out[1])))


@functools.lru_cache(maxsize=256)
def _device_plan(dev: torch.device, *shape,
                 pos_offset: int = 0) -> Tuple[BwdPlan, torch.Tensor]:
    """:func:`bwd_plan` for ``shape`` at ``pos_offset`` on card ``dev``
    and its table there (built once per shape: a training step repeats a
    few shapes)."""
    sms, resident = _card(dev.index, shape[5])
    plan = bwd_plan(*shape, sms=sms, resident=resident,
                    pos_offset=pos_offset)
    return plan, torch.from_numpy(plan.table()).to(dev)


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None, pos_offset: int = 0):
    """dq, dk, dv (bf16, the shapes of q, k, v) of :func:`flash_prefill`
    from its operands, its output, its lse and the output's gradient
    ``dout`` (B, H, Sq, D) bf16, with the forward's masks and
    ``pos_offset``.  On the card:
    D_i = rowsum(dO ∘ O) with each row's log2e-scaled lse, packed
    token-major per KV head, then dK/dV by key tiles, on the caller's
    stream; beside them dQ by row tiles (each block summing its own rows'
    D_i) on a second stream, joined back before the call returns, started
    with the call or after D_i as the plan says; walks cut by
    :func:`bwd_plan`; where a walk
    has several splits, each writes an f32 partial to scratch and a sum
    kernel adds them in split order (no atomics: the gradients repeat
    bit for bit).  Counts its CUDA calls in
    ``flash_prefill_bwd.launches``; declares its cost to an active
    ``roofline.op_cost`` counter."""
    if op_cost.COUNTER is not None and not op_cost.COUNTER.paused:
        return op_cost.COUNTER.kernel(
            "flash_prefill_bwd", KC.of_flash_prefill_bwd, flash_prefill_bwd,
            q, k, v, out, lse, dout, causal=causal, window=window,
            pos_offset=pos_offset)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    off = int(pos_offset)
    seq = _check_shapes(q, k, v, None, off)
    win = NO_WINDOW if window is None else int(window)
    if q.device.type == "cpu":
        return flash_prefill_bwd_ref(q, k, v, out, lse, dout, causal, win,
                                     seq, pos_offset=off)
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
    dev = q.device if q.device.index is not None else \
        torch.device("cuda", torch.cuda.current_device())
    plan, table = _device_plan(dev, B, H, Hkv, Sq, Sk, D, bool(causal), win,
                               seq, pos_offset=off)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rows = torch.empty((B, H, Sq, 2), dtype=torch.float32, device=dev)
    kv_bytes, q_bytes = plan.scratch_bytes(B, Hkv, D)
    part_kv, part_q = (torch.empty(n // 4, dtype=torch.float32, device=dev)
                       if n else None for n in (kv_bytes, q_bytes))
    fn = _build.bind("flash_prefill_bwd", "flash_prefill_bwd", 13, 15)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), rows.data_ptr(), table.data_ptr(),
             None if part_kv is None else part_kv.data_ptr(),
             None if part_q is None else part_q.data_ptr(),
             B, H, Hkv, Sq, Sk, D, seq, int(causal), win, off,
             len(plan.kv_items), plan.kv_slots, len(plan.q_items),
             plan.q_slots, int(plan.dq_first),
             torch.cuda.current_stream(dev).cuda_stream)
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
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                pos_offset: int = 0):
        out, lse = flash_prefill(q, k, v, causal=causal, window=window,
                                 return_lse=True, pos_offset=pos_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.pos_offset = causal, window, pos_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(
            q, k, v, out, lse, dout.to(q.dtype).contiguous(),
            causal=ctx.causal, window=ctx.window, pos_offset=ctx.pos_offset)
        return dq, dk, dv, None, None, None
