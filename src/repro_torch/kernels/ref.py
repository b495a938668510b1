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
                qpos: torch.Tensor, window: int, return_lse: bool = False):
    """Online-softmax flash decode over ``tiles`` of (base, kd, vd), kd/vd
    (B, Hkv, bs, D) bf16-valued f32 from :func:`_dequant`, ``base`` the
    logical position of the tile's first token.  q: (B, Hkv, R, D) bf16;
    qpos (B, R) each row's causal frontier; a row keeps keys with
    ``qpos - window < kpos <= qpos``.

    The kernel's rounding points: scores in f32 times ``1/sqrt(D)``,
    masked to ``NEG_INF``, p zeroed under the mask, p rounded to bf16
    before the PV product (l sums the unrounded p), output
    ``bf16(acc / max(l, 1e-20))``.  ``return_lse`` returns the output in
    f32 instead, unrounded, and each row's ``m + log(l)`` (B, Hkv, R) f32,
    -inf where it keeps no key."""
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
    out = acc / l.clamp_min(1e-20)
    if not return_lse:
        return out.to(torch.bfloat16)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, float("-inf")))
    return out, lse[..., 0]


def _row_frontiers(pos: torch.Tensor, R: int, rep: int) -> torch.Tensor:
    """Token-major rows (``r = t*rep + g``): row r's frontier is
    ``pos + r // rep``.  pos (B,) → (B, R)."""
    return pos.long()[:, None] + \
        torch.arange(R, device=pos.device) // rep


def kvattn_ref(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
               v: torch.Tensor, v_scale: torch.Tensor, pos: torch.Tensor,
               window: int, rep: int, block_s: int, key_offset: int = 0,
               return_lse: bool = False):
    """Multi-query attention over the dense slab, walked in ``block_s``
    tiles (every tile of the slab; the kernel skips the tiles past each
    slot's frontier, exact no-ops of the walk).

    q: (B, Hkv, R, D) bf16, rows token-major; k/v (B, S, Hkv, Dstore) of
    any KV format (int8 kv8, nibble-packed int8 kv4, float8_e5m2, bf16);
    scales (B, S, Hkv) f32; pos (B,) first query position.  The slab
    holds the keys at positions ``key_offset`` on (one rank's range of a
    sequence-sharded cache); ``return_lse`` returns the output unrounded
    in f32 and each row's log-sum-exp (B, Hkv, R) f32, -inf for a row that
    keeps no key here, so results over disjoint ranges combine and are
    rounded once (:func:`combine_lse`)."""
    B, Hkv, R, D = q.shape
    S = k.shape[1]

    def tiles():
        for base in range(0, S, block_s):
            sl = slice(base, base + block_s)
            kd = _dequant(k[:, sl].permute(0, 2, 1, 3),
                          k_scale[:, sl].permute(0, 2, 1), D)
            vd = _dequant(v[:, sl].permute(0, 2, 1, 3),
                          v_scale[:, sl].permute(0, 2, 1), D)
            yield key_offset + base, kd, vd

    return _flash_walk(q, tiles(), _row_frontiers(pos, R, rep), window,
                       return_lse)


def combine_lse(outs, lses, dtype=torch.bfloat16) -> torch.Tensor:
    """One attention output from partial ones over disjoint key ranges:
    ``outs`` (..., D) f32 each with its rows' log-sum-exp ``lses`` (...),
    as :func:`kvattn_ref` returns them; weights ``exp(lse - max lse)`` in
    f32, the sum rounded once to ``dtype``.  A row no range keeps gives
    0."""
    lse = torch.stack([t.float() for t in lses])
    top = lse.amax(0).clamp_min(-1e30)                 # -inf rows: finite
    w = torch.exp(lse - top)
    num = (w[..., None] * torch.stack([o.float() for o in outs])).sum(0)
    return (num / w.sum(0).clamp_min(1e-20)[..., None]).to(dtype)


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
                     window: int, block_k: int, pos_offset: int = 0
                     ) -> range:
    """First keys of the ``block_k``-key tiles that can hold a kept key of
    query rows ``[q0, q0 + qc)`` (at positions ``pos_offset + q0`` on)
    among ``S`` keys: tiles wholly past ``seq``, above the diagonal
    (causal) or before the window are skipped, as the kernel skips them
    (each is an exact no-op of the online softmax)."""
    p0 = pos_offset + q0
    hi = min(seq, S)
    if causal:
        hi = min(hi, p0 + qc)
    lo = max(0, p0 - window + 1)
    return range(lo // block_k * block_k, hi, block_k)


def _work_types(q: torch.Tensor):
    """(accumulation dtype, rounding of a kernel operand): bf16 operands
    accumulate in f32 and round p (and dS) to bf16 where the kernels do;
    f64 operands keep f64 throughout (finite-difference checks of the
    math)."""
    if q.dtype == torch.float64:
        return torch.float64, lambda t: t
    return torch.float32, lambda t: t.to(torch.bfloat16).float()


def _keep(qpos: torch.Tensor, kpos: torch.Tensor, seq: int, causal: bool,
          window: int) -> torch.Tensor:
    """(qc, Sk) mask of flash prefill: ``kpos < seq``, ``kpos <= qpos`` if
    causal, ``kpos > qpos - window``."""
    mask = (kpos[None] < seq) & (kpos[None] > qpos - window)
    if causal:
        mask &= kpos[None] <= qpos
    return mask


def flash_prefill_walk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, window: int, seq: int, block_q: int,
                       block_k: int, return_lse: bool = False,
                       pos_offset: int = 0):
    """Flash prefill over ``block_q × block_k`` tiles: the port of
    ``repro.core.attention.flash_attention``'s ``q_chunk × kv_chunk``
    walk (attention.py:118-173) on the kernel's head-major operands.

    q (B, H, Sq, D), k/v (B, Hkv, Sk, D) bf16; head h reads KV head ``h //
    rep``; query row t sits at position ``qpos = pos_offset + t``; a key
    is kept when ``kpos < seq``, ``kpos <= qpos`` if ``causal`` and
    ``kpos > qpos - window`` (NO_WINDOW: no window).  Rounding points of
    the kernel: scores f32 times ``rsqrt(D)``, masked to ``NEG_INF``, p zeroed under
    the mask, l summing the unrounded p, p rounded to bf16 before the PV
    product, ``bf16(acc / max(l, 1e-20))``.  Rows and keys need no
    padding: the last tiles are cut short.  ``return_lse`` also returns
    each row's f32 log-sum-exp ``m + log(l)`` (B, H, Sq), NEG_INF for a
    row with no kept key — what the backward pass recomputes P from.
    f64 operands are walked in f64 without rounding."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = H // Hkv
    dev = q.device
    acc_t, rnd = _work_types(q)
    qg = q.to(acc_t).reshape(B, Hkv, rep, Sq, D)
    kf, vf = k.to(acc_t), v.to(acc_t)
    inv = torch.rsqrt(torch.full((), float(D), dtype=acc_t, device=dev))
    out_t = torch.float64 if acc_t == torch.float64 else torch.bfloat16
    out = torch.empty((B, Hkv, rep, Sq, D), dtype=out_t, device=dev)
    lse = torch.empty((B, Hkv, rep, Sq), dtype=acc_t, device=dev)
    for q0 in range(0, Sq, block_q):
        qb = qg[:, :, :, q0:q0 + block_q]                   # (B,Hkv,rep,qc,D)
        qc = qb.shape[3]
        qpos = (pos_offset + q0 + torch.arange(qc, device=dev))[:, None]
        m = torch.full((B, Hkv, rep, qc, 1), NEG_INF, dtype=acc_t,
                       device=dev)
        l = torch.zeros((B, Hkv, rep, qc, 1), dtype=acc_t, device=dev)
        acc = torch.zeros((B, Hkv, rep, qc, D), dtype=acc_t, device=dev)
        for k0 in prefill_kv_tiles(q0, qc, Sk, seq, causal, window,
                                   block_k, pos_offset):
            kb = kf[:, :, None, k0:k0 + block_k]            # (B,Hkv,1,kc,D)
            vb = vf[:, :, None, k0:k0 + block_k]
            kpos = k0 + torch.arange(kb.shape[3], device=dev)
            mask = _keep(qpos, kpos, seq, causal, window)
            s = torch.matmul(qb, kb.transpose(-1, -2)) * inv
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(rnd(p), vb)
            m = m_new
        out[:, :, :, q0:q0 + qc] = (acc / l.clamp_min(1e-20)).to(out_t)
        lse[:, :, :, q0:q0 + qc] = torch.where(
            l > 0, m + torch.log(l), torch.full_like(l, NEG_INF))[..., 0]
    out = out.reshape(B, H, Sq, D)
    if return_lse:
        return out, lse.reshape(B, H, Sq)
    return out


def flash_prefill_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          out: torch.Tensor, lse: torch.Tensor,
                          dout: torch.Tensor, causal: bool, window: int,
                          seq: int, block_q: int = 128, pos_offset: int = 0):
    """dq, dk, dv of :func:`flash_prefill_walk` from its saved operands:
    the plain version of ``csrc/flash_prefill_bwd.cu``, and the CPU path
    of the autograd function (the reference differentiates its XLA walk,
    ``jax.vjp`` of ``core/attention.py:92``).

    q / out / dout (B, H, Sq, D), k/v (B, Hkv, Sk, D) bf16, lse (B, H, Sq)
    f32; query row t at position ``pos_offset + t``.  Per block of
    ``block_q`` query tokens, in f32:
    ``P = exp(S · rsqrt(D) − lse)`` (0 under the mask), ``D_i =
    rowsum(dO ∘ O)``, ``dV = Σ bf16(P)ᵀ dO``, ``dP = dO Vᵀ``, ``dS = P ∘
    (dP − D_i)``, ``dQ = rsqrt(D) · bf16(dS) K`` and ``dK = rsqrt(D) ·
    Σ bf16(dS)ᵀ Q`` — the kernel's rounding points; a KV head's dK and dV
    sum over its ``rep`` query heads.  Returns bf16 dq, dk, dv (f64
    operands: f64, unrounded)."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = H // Hkv
    dev = q.device
    acc_t, rnd = _work_types(q)
    qg = q.to(acc_t).reshape(B, Hkv, rep, Sq, D)
    dog = dout.to(acc_t).reshape(B, Hkv, rep, Sq, D)
    lg = lse.to(acc_t).reshape(B, Hkv, rep, Sq, 1)
    delta = (dog * out.to(acc_t).reshape(B, Hkv, rep, Sq, D)).sum(
        -1, keepdim=True)
    kf, vf = k.to(acc_t)[:, :, None], v.to(acc_t)[:, :, None]
    inv = torch.rsqrt(torch.full((), float(D), dtype=acc_t, device=dev))
    kpos = torch.arange(Sk, device=dev)
    dq = torch.empty_like(qg)
    dk = torch.zeros((B, Hkv, Sk, D), dtype=acc_t, device=dev)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, block_q):
        sl = slice(q0, q0 + block_q)
        qb, dob = qg[:, :, :, sl], dog[:, :, :, sl]
        qpos = (pos_offset + q0 + torch.arange(qb.shape[3],
                                               device=dev))[:, None]
        mask = _keep(qpos, kpos, seq, causal, window)
        s = torch.matmul(qb, kf.transpose(-1, -2)) * inv
        p = torch.where(mask, torch.exp(s - lg[:, :, :, sl]),
                        torch.zeros_like(s))
        dv += torch.matmul(rnd(p).transpose(-1, -2), dob).sum(2)
        dp = torch.matmul(dob, vf.transpose(-1, -2))
        ds = rnd(p * (dp - delta[:, :, :, sl]))
        dq[:, :, :, sl] = torch.matmul(ds, kf) * inv
        dk += torch.matmul(ds.transpose(-1, -2), qb).sum(2) * inv
    out_t = torch.float64 if acc_t == torch.float64 else torch.bfloat16
    return (dq.reshape(B, H, Sq, D).to(out_t), dk.to(out_t),
            dv.to(out_t))


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window=None,
                      pos_offset: int = 0) -> torch.Tensor:
    """Oracle for the flash-prefill kernel: full f32 attention (port of
    ``repro.kernels.ref.flash_prefill_ref``).  q (B, Sq, H, D); k/v
    (B, Sk, Hkv, D); query row t at position ``pos_offset + t``; returns
    (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    rep = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, rep, D)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qf, k.float())
    scores = scores / torch.sqrt(torch.tensor(float(D)))
    qpos = pos_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = (kpos <= qpos) if causal else torch.ones(
        (Sq, Sk), dtype=torch.bool, device=q.device)
    if window is not None:
        mask &= kpos > (qpos - window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


# -- each kernel wrapper's plain version, taking the wrapper's arguments ----
# (what a wrapper runs for CPU tensors; ``roofline.op_cost.rerouted(PLAIN)``
# runs them on the card too, to count a step on the plain route)

def _plain_kvattn(q, k, k_scale, v, v_scale, pos, window, rep, block_s,
                  spec, key_offset=0, return_lse=False):
    return kvattn_ref(q, k, k_scale, v, v_scale, pos, window, rep,
                      min(int(block_s), k.shape[1]), key_offset, return_lse)


def _plain_paged_kvattn(q, k, k_scale, v, v_scale, block_table, pos,
                        window, rep, n_live, spec):
    return paged_kvattn_ref(q, k, k_scale, v, v_scale, block_table, pos,
                            window, rep,
                            max(1, min(int(n_live), block_table.shape[1])))


def _plain_flash_prefill(q, k, v, *, causal=True, window=None, seq=None,
                         tile=None, return_lse=False, pos_offset=0):
    from .flashprefill import pick_tile
    B, H, Sq, D = q.shape
    block_q, block_k = tile or pick_tile(B, H, k.shape[1], Sq, D)
    return flash_prefill_walk(
        q, k, v, causal, NO_WINDOW if window is None else int(window),
        k.shape[2] if seq is None else seq, block_q, block_k,
        return_lse=return_lse, pos_offset=pos_offset)


def _plain_flash_prefill_bwd(q, k, v, out, lse, dout, *, causal=True,
                             window=None, pos_offset=0):
    return flash_prefill_bwd_ref(
        q, k, v, out, lse, dout, causal,
        NO_WINDOW if window is None else int(window), k.shape[2],
        pos_offset=pos_offset)


#: the plain version of each kernel wrapper, by the wrapper's name
PLAIN = {"mpgemm_a16": mpgemm_ref, "mpgemm_int8": mpgemm_int8_ref,
         "kvattn": _plain_kvattn, "paged_kvattn": _plain_paged_kvattn,
         "flash_prefill": _plain_flash_prefill,
         "flash_prefill_bwd": _plain_flash_prefill_bwd}
