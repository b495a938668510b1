"""Mixed-precision GEMM — the online stage of the paper's GEMM pipeline.

Port of ``repro.core.gemm.mp_matmul`` for the A16 path.  On the card the
only way to keep the packed weights 4-bit all the way to the arithmetic is
the hand-written kernel (``kernels/mpgemm.py``); ``torch.matmul`` would
first materialise them in bf16 — the "naive" baseline the paper argues
against, which comes later as ``impl="naive"``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .packing import PackedWeight
from .precision import PrecisionPolicy


def mp_matmul(x: torch.Tensor, w: PackedWeight,
              policy: PrecisionPolicy) -> torch.Tensor:
    """y = x @ W for quantized, offline-packed W.  x: (..., K) → (..., N)."""
    if policy.acts.bits != 16 or policy.weights.bits != 4:
        raise NotImplementedError(
            f"mp_matmul for {policy.name} is not ported yet (ROADMAP queue "
            "1 item 6: the remaining policies)")
    return ops.mpgemm(x, w).to(policy.compute_dtype)
