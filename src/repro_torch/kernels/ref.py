"""Plain PyTorch versions of the port's kernels.

Port of ``repro.kernels.ref``.  Each function computes what its CUDA kernel
computes, with the kernel's rounding points, using ordinary tensor ops.
The kernel wrappers run these for CPU tensors (the tests); on the card they
serve only ``chip_smoke.py`` and the CUDA tests, which hold each kernel
against them.

The two decode-attention versions share one tile walk (:func:`_flash_walk`), as
the two CUDA kernels share ``csrc/flash_block.cuh``: the dense slab and
the paged pool are visited one ``block_size`` tile at a time with the
same online-softmax update, so the same logical contents give bitwise
equal outputs on either backend (a fully masked tile is an exact no-op).
The walk's reductions are elementwise products summed over a contiguous
last axis, never a BLAS call, whose summation order may depend on the
operands' memory alignment.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import torch

from repro_torch.core.packing import (PackedWeight, dequantize_packed,
                                      unpack_weight)
from repro_torch.core.quantize import unpack_int4

NEG_INF = -1e30
#: "no sliding window" sentinel — ``pos - NO_WINDOW`` stays negative for
#: every reachable position, so the window mask is a no-op.
NO_WINDOW = 1 << 30


def mpgemm_ref(x: torch.Tensor, w: PackedWeight,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ W, W packed at bits 4 or 8: dequantize W (each value
    ``bf16(q * scale)``, the kernel's weight operand), then a float32
    matmul.  x: (M, K) bf16."""
    wd = dequantize_packed(w, dtype=torch.bfloat16).float()
    return (x.float() @ wd).to(out_dtype)


def mpgemm_int8_ref(xq: torch.Tensor, xscale: torch.Tensor, w: PackedWeight,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = (xq @ W_int) with W4/W8 integer weights: the exact integer
    partial product of each K group (held in f32, exact: every partial
    sum is an integer below 2^24), times the group's scale in f32, summed
    over the groups in K order, times the per-token scale, then bf16.
    xq: (M, K) int8; xscale: (M, 1) f32."""
    M, K = xq.shape
    N, gs = w.shape[1], w.group
    G = K // gs
    qw = unpack_weight(w).float().reshape(G, gs, N)
    part = torch.bmm(xq.float().reshape(M, G, gs).transpose(0, 1), qw)
    acc = torch.zeros((M, N), dtype=torch.float32, device=xq.device)
    for g in range(G):
        acc = acc + part[g] * w.scales[g]
    return (acc * xscale).to(out_dtype)


def _dequant(t: torch.Tensor, scale: torch.Tensor, D: int) -> torch.Tensor:
    """(B, Hkv, bs, Dstore) stored K/V of any format + (B, Hkv, bs) scales
    → bf16-valued f32 (B, Hkv, bs, D): kv4 nibbles unpacked (low nibble =
    even d), then ``bf16(float(q) * scale)`` for every format."""
    if t.shape[-1] != D:
        t = unpack_int4(t, dim=t.dim() - 1)
    return (t.float() * scale[..., None]).to(torch.bfloat16).float() \
        .contiguous()


def _flash_walk(q: torch.Tensor, tiles: Iterable[Tuple[int, torch.Tensor,
                                                       torch.Tensor]],
                qpos: torch.Tensor, window: int) -> torch.Tensor:
    """Online-softmax flash decode over ``tiles`` of (base, kd, vd), kd/vd
    (B, Hkv, bs, D) bf16-valued f32 from :func:`_dequant`, ``base`` the
    logical position of the tile's first token.  q: (B, Hkv, R, D) bf16;
    qpos (B, R) each row's causal frontier; a row keeps keys with
    ``qpos - window < kpos <= qpos``.

    The kernel's rounding points: scores in f32 times ``1/sqrt(D)``,
    masked to ``NEG_INF``, p zeroed under the mask, p rounded to bf16
    before the PV product (l sums the unrounded p), output
    ``bf16(acc / max(l, 1e-20))``."""
    B, Hkv, R, D = q.shape
    qf = q.float()[:, :, :, None, :]                          # (B,Hkv,R,1,D)
    inv = torch.rsqrt(torch.full((), float(D), device=q.device))
    m = torch.full((B, Hkv, R, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, R, 1), device=q.device)
    acc = torch.zeros((B, Hkv, R, D), device=q.device)
    qp = qpos.long()[:, None, :, None]                        # (B,1,R,1)
    for base, kd, vd in tiles:
        bs = kd.shape[2]
        s = (qf * kd[:, :, None]).sum(-1) * inv               # (B,Hkv,R,bs)
        kpos = base + torch.arange(bs, device=q.device)
        mask = (kpos <= qp) & (kpos > qp - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(-1, keepdim=True)
        vt = vd.transpose(-1, -2).contiguous()                # (B,Hkv,D,bs)
        pb = p.to(torch.bfloat16).float()[:, :, :, None, :]   # (B,Hkv,R,1,bs)
        acc = acc * alpha + (pb * vt[:, :, None]).sum(-1)
        m = m_new
    return (acc / l.clamp_min(1e-20)).to(torch.bfloat16)


def _row_frontiers(pos: torch.Tensor, R: int, rep: int) -> torch.Tensor:
    """Token-major rows (``r = t*rep + g``): row r's frontier is
    ``pos + r // rep``.  pos (B,) → (B, R)."""
    return pos.long()[:, None] + \
        torch.arange(R, device=pos.device) // rep


def kvattn_ref(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
               v: torch.Tensor, v_scale: torch.Tensor, pos: torch.Tensor,
               window: int, rep: int, block_s: int) -> torch.Tensor:
    """Multi-query attention over the dense slab, walked in ``block_s``
    tiles (every tile of the slab; the kernel skips the tiles past each
    slot's frontier, exact no-ops of the walk).

    q: (B, Hkv, R, D) bf16, rows token-major; k/v (B, S, Hkv, Dstore) of
    any KV format (int8 kv8, nibble-packed int8 kv4, float8_e5m2, bf16);
    scales (B, S, Hkv) f32; pos (B,) first query position."""
    B, Hkv, R, D = q.shape
    S = k.shape[1]

    def tiles():
        for base in range(0, S, block_s):
            sl = slice(base, base + block_s)
            kd = _dequant(k[:, sl].permute(0, 2, 1, 3),
                          k_scale[:, sl].permute(0, 2, 1), D)
            vd = _dequant(v[:, sl].permute(0, 2, 1, 3),
                          v_scale[:, sl].permute(0, 2, 1), D)
            yield base, kd, vd

    return _flash_walk(q, tiles(), _row_frontiers(pos, R, rep), window)


def paged_kvattn_ref(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
                     v: torch.Tensor, v_scale: torch.Tensor,
                     block_table: torch.Tensor, pos: torch.Tensor,
                     window: int, rep: int, n_live: int) -> torch.Tensor:
    """Multi-query paged attention over the first ``n_live`` logical
    blocks.

    q: (B, Hkv, R, D) bf16, rows token-major (``r = t*rep + g``); pool
    k/v: (n_blocks, block_size, Hkv, Dstore) of any KV format; scales
    (n_blocks, block_size, Hkv) f32; block_table (B, blocks_per_slot)
    int32 with sentinel ``n_blocks`` (clamped to the last block, then
    masked); pos (B,) first query position.  Row r attends to logical
    positions ``kpos <= pos + r // rep`` and ``kpos > pos + r // rep -
    window``."""
    B, Hkv, R, D = q.shape
    nb, bs = k.shape[0], k.shape[1]
    tbl = block_table[:, :n_live].long().clamp(max=nb - 1)     # (B, n)

    def tiles():
        for s in range(tbl.shape[1]):
            blk = tbl[:, s]
            kd = _dequant(k[blk].permute(0, 2, 1, 3),
                          k_scale[blk].permute(0, 2, 1), D)
            vd = _dequant(v[blk].permute(0, 2, 1, 3),
                          v_scale[blk].permute(0, 2, 1), D)
            yield s * bs, kd, vd

    return _flash_walk(q, tiles(), _row_frontiers(pos, R, rep), window)


def prefill_kv_tiles(q0: int, qc: int, S: int, seq: int, causal: bool,
                     window: int, block_k: int) -> range:
    """First keys of the ``block_k``-key tiles that can hold a kept key of
    query rows ``[q0, q0 + qc)``: tiles wholly past ``seq``, above the
    diagonal (causal) or before the window are skipped, as the kernel
    skips them (each is an exact no-op of the online softmax)."""
    hi = min(seq, S)
    if causal:
        hi = min(hi, q0 + qc)
    lo = max(0, q0 - window + 1)
    return range(lo // block_k * block_k, hi, block_k)


def flash_prefill_walk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int, seq: int, block_q: int,
                       block_k: int) -> torch.Tensor:
    """Flash prefill over ``block_q × block_k`` tiles: the port of
    ``repro.core.attention.flash_attention``'s ``q_chunk × kv_chunk``
    walk (attention.py:118-173) on the kernel's head-major operands.

    q (B, H, S, D), k/v (B, Hkv, S, D) bf16; head h reads KV head
    ``h // rep``; a key is kept when ``kpos < seq``, ``kpos <= qpos`` if
    ``causal`` and ``kpos > qpos - window`` (NO_WINDOW: no window).
    Rounding points of the kernel: scores f32 times ``rsqrt(D)``, masked to
    ``NEG_INF``, p zeroed under the mask, l summing the unrounded p, p
    rounded to bf16 before the PV product, ``bf16(acc / max(l, 1e-20))``.
    Rows and keys need no padding: the last tiles are cut short."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    dev = q.device
    qg = q.float().reshape(B, Hkv, rep, S, D)
    kf, vf = k.float(), v.float()
    inv = torch.rsqrt(torch.full((), float(D), device=dev))
    out = torch.empty((B, Hkv, rep, S, D), dtype=torch.bfloat16, device=dev)
    for q0 in range(0, S, block_q):
        qb = qg[:, :, :, q0:q0 + block_q]                   # (B,Hkv,rep,qc,D)
        qc = qb.shape[3]
        qpos = (q0 + torch.arange(qc, device=dev))[:, None]
        m = torch.full((B, Hkv, rep, qc, 1), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, rep, qc, 1), device=dev)
        acc = torch.zeros((B, Hkv, rep, qc, D), device=dev)
        for k0 in prefill_kv_tiles(q0, qc, S, seq, causal, window, block_k):
            kb = kf[:, :, None, k0:k0 + block_k]            # (B,Hkv,1,kc,D)
            vb = vf[:, :, None, k0:k0 + block_k]
            kpos = k0 + torch.arange(kb.shape[3], device=dev)
            mask = (kpos[None] < seq) & (kpos[None] > qpos - window)
            if causal:
                mask &= kpos[None] <= qpos
            s = torch.matmul(qb, kb.transpose(-1, -2)) * inv
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(
                p.to(torch.bfloat16).float(), vb)
            m = m_new
        out[:, :, :, q0:q0 + qc] = (acc / l.clamp_min(1e-20)).to(
            torch.bfloat16)
    return out.reshape(B, H, S, D)


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window=None) -> torch.Tensor:
    """Oracle for the flash-prefill kernel: full f32 attention (port of
    ``repro.kernels.ref.flash_prefill_ref``).  q (B, S, H, D); k/v
    (B, S, Hkv, D); returns (B, S, H, D) in q's dtype."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    rep = H // Hkv
    qf = q.float().reshape(B, S, Hkv, rep, D)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qf, k.float())
    scores = scores / torch.sqrt(torch.tensor(float(D)))
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos) if causal else torch.ones(
        (S, S), dtype=torch.bool, device=q.device)
    if window is not None:
        mask &= kpos > (qpos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
