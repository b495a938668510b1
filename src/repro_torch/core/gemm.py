"""Mixed-precision GEMM — the online stage of the paper's GEMM pipeline.

Port of ``repro.core.gemm.mp_matmul``, routed as the JAX package routes
it: integer weights × A8 activations (``policy.int8_matmul``: w4a8, w8a8)
take the s8×s8→s32 kernel on per-token quantized activations; every other
packed weight (w4 / w8, and wfp8, which is packed as per-group int8) takes
the A16 kernel at bits 4 or 8 with the activations in bf16 — afp8
activations are never quantized.  w16 weights are never packed
(``models.common.maybe_quantize``) and do not come here.  On the card the
hand-written kernels are the only way to keep the packed weights in their
stored width all the way to the arithmetic; ``torch.matmul`` would first
materialise them in bf16 — the "naive" baseline the paper argues against,
which comes later as ``impl="naive"``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .packing import PackedWeight
from .precision import PrecisionPolicy


def mp_matmul(x: torch.Tensor, w: PackedWeight,
              policy: PrecisionPolicy) -> torch.Tensor:
    """y = x @ W for quantized, offline-packed W.  x: (..., K) → (..., N)."""
    return ops.mpgemm(x, w, policy).to(policy.compute_dtype)
