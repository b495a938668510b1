"""Plain PyTorch versions of the port's kernels.

Port of ``repro.kernels.ref``.  Each function computes what its CUDA kernel
computes, with the kernel's rounding points, using ordinary tensor ops.
The kernel wrappers run these for CPU tensors (the tests); on the card they
serve only ``chip_smoke.py`` and the CUDA tests, which hold each kernel
against them.
"""
from __future__ import annotations

import torch

from repro_torch.core.packing import PackedWeight, dequantize_packed

NEG_INF = -1e30
#: "no sliding window" sentinel — ``pos - NO_WINDOW`` stays negative for
#: every reachable position, so the window mask is a no-op.
NO_WINDOW = 1 << 30


def mpgemm_ref(x: torch.Tensor, w: PackedWeight,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ W: dequantize W (each value ``bf16(q * scale)``, the
    kernel's weight operand), then a float32 matmul.  x: (M, K) bf16."""
    wd = dequantize_packed(w, dtype=torch.bfloat16).float()
    return (x.float() @ wd).to(out_dtype)


def paged_kvattn_ref(q: torch.Tensor, k: torch.Tensor, k_scale: torch.Tensor,
                     v: torch.Tensor, v_scale: torch.Tensor,
                     block_table: torch.Tensor, pos: torch.Tensor,
                     window: int, rep: int, n_live: int) -> torch.Tensor:
    """Multi-query paged attention over the first ``n_live`` logical blocks.

    q: (B, Hkv, R, D) bf16, rows token-major (``r = t*rep + g``); pool
    k/v: (n_blocks, block_size, Hkv, D) int8; scales (n_blocks,
    block_size, Hkv) f32; block_table (B, blocks_per_slot) int32 with
    sentinel ``n_blocks`` (clamped to the last block, then masked); pos
    (B,) first query position.  Row r attends to logical positions
    ``kpos <= pos + r // rep`` and ``kpos > pos + r // rep - window``.

    The kernel's rounding points: K/V dequantized to bf16, scores in f32
    times ``1/sqrt(D)``, masked to ``NEG_INF``, softmax weights rounded to
    bf16 before the PV product, output divided by ``max(l, 1e-20)``.
    """
    B, Hkv, R, D = q.shape
    nb, bs = k.shape[0], k.shape[1]
    tbl = block_table[:, :n_live].long().clamp(max=nb - 1)     # (B, n)
    S = tbl.shape[1] * bs

    def gather(pool, scale):
        t = pool[tbl].reshape(B, S, Hkv, -1).permute(0, 2, 1, 3)
        s = scale[tbl].reshape(B, S, Hkv).permute(0, 2, 1)
        return (t.float() * s[..., None]).to(torch.bfloat16).float()

    kd, vd = gather(k, k_scale), gather(v, v_scale)            # (B,Hkv,S,D)
    inv = torch.rsqrt(torch.full((), float(D), device=q.device))
    s = (q.float() @ kd.transpose(-1, -2)) * inv               # (B,Hkv,R,S)
    qpos = pos.long()[:, None] + torch.arange(R, device=q.device) // rep
    kpos = torch.arange(S, device=q.device)
    mask = (kpos[None, None] <= qpos[:, :, None]) & \
        (kpos[None, None] > qpos[:, :, None] - window)
    mask = mask[:, None]                                       # (B,1,R,S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(torch.bfloat16).float() @ vd
    return (acc / l.clamp_min(1e-20)).to(torch.bfloat16)
