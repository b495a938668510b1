"""Mixed-precision GEMM — the online stage of the paper's GEMM pipeline.

Port of ``repro.core.gemm.mp_matmul``, routed as the JAX package routes
it: integer weights × A8 activations (``policy.int8_matmul``: w4a8, w8a8)
take the s8×s8→s32 kernel on per-token quantized activations; every other
packed weight (w4 / w8, and wfp8, which is packed as per-group int8) takes
the A16 kernel at bits 4 or 8 with the activations in bf16 — afp8
activations are never quantized.  w16 weights are never packed
(``models.common.maybe_quantize``) and do not come here.  On the card the
hand-written kernels are the only way to keep the packed weights in their
stored width all the way to the arithmetic.  ``impl="naive"`` is the
baseline the paper argues against (§2, TensorRT-LLM-style runtime
dequantization): the whole weight dequantized into a materialized bf16
tensor, then ``torch.matmul``.  :func:`dense_matmul` is the 16-bit GEMM
of the paper's FP16 × FP16 baseline.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

from .packing import PackedWeight, dequantize_packed
from .precision import PrecisionPolicy


def mp_matmul(x: torch.Tensor, w: PackedWeight, policy: PrecisionPolicy,
              impl: str = "kernel") -> torch.Tensor:
    """y = x @ W for quantized, offline-packed W.  x: (..., K) → (..., N).
    ``impl``: ``"kernel"`` (the mixed-precision GEMM kernels) or
    ``"naive"`` (dequantize W whole, then a 16-bit matmul)."""
    if impl == "naive":
        wd = dequantize_packed(w, policy.compute_dtype)
        return torch.matmul(x.to(policy.compute_dtype), wd)
    if impl != "kernel":
        raise ValueError(f"mp_matmul: unknown impl {impl!r} "
                         "(expected 'kernel' or 'naive')")
    return ops.mpgemm(x, w, policy).to(policy.compute_dtype)


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Reference 16-bit GEMM (the paper's FP16 × FP16 baseline)."""
    return torch.matmul(x.to(dtype), w.to(dtype))
