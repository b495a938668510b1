"""The yardstick's constants and work formulas, frozen copies.

``PEAK_BF16_FLOPS`` and ``HBM_BYTES_PER_S`` are one NVIDIA H100 SXM5 80
GB's published dense peaks (NVIDIA's data sheet, at its 700 W limit), as
``repro_torch.roofline.analysis.HW`` holds them.  ``gemm`` and
``weight_bytes`` are ``repro_torch.kernels.cost.gemm`` /
``weight_bytes``; ``weight_group`` follows ``repro_torch.models.common.
maybe_quantize`` and ``pick_blocks`` (which group a packed weight gets).
``packed_gemms`` lists the weights of one decoder layer a token passes
through the A16 GEMM kernel besides the routed experts, and
``matmul_params`` the parameters a token multiplies (both read
``residual_d_ff``, the dense residual's width, where it is given); the
decoder's architecture module (``bench/archs/decoder.py``) binds them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
#: the program's model-axis width its tile choice prefers to divide
MODEL_AXIS = 16
#: weights below this many elements stay bf16
MIN_PACKED = 256 * 256


def gemm(M: int, K: int, N: int, weight_bytes: int) -> Tuple[int, int]:
    """Operations and bytes of ``y (M, N) bf16 = x (M, K) bf16 @ W``: the
    packed weight read once, activations in and out."""
    return 2 * M * N * K, M * K * 2 + weight_bytes + M * N * 2


def weight_bytes(K: int, N: int, bits: int, group: int) -> int:
    """A packed (K, N) weight's values and its (K/group, N) f32 scales."""
    return K * N * bits // 8 + (K // group) * N * 4


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card takes for the work: the larger of the
    operations at the bf16 peak and the bytes at the HBM peak."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def _pick(dim: int, candidates) -> int:
    best = None
    for b in candidates:
        if dim % b == 0:
            if best is None:
                best = b
            if (dim // b) % MODEL_AXIS == 0:
                return b
    return best


def weight_group(K: int, N: int, group: int = 128) -> int:
    """The quantization group of a packed (K, N) weight at the policy's
    ``group``."""
    bk = _pick(K, (128, 64, 32))
    g = min(group, bk)
    return bk if bk % g else g


def packed_gemms(model: Dict) -> List[Tuple[str, int, int]]:
    """(leaf, K, N) of each weight of one layer that a token passes
    through the GEMM kernel: attention's four, then the SwiGLU (dense) or
    the dense residual and the router (moe).  The routed experts' products
    run in the kernel too, on only the rows routed to each expert: they are
    counted apart (the architecture module's ``expert_gemms``)."""
    d, f = model["d_model"], model["d_ff"]
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H
    out = [("wq", d, H * hd), ("wk", d, Hkv * hd), ("wv", d, Hkv * hd),
           ("wo", H * hd, d)]
    if model.get("n_experts"):
        if model.get("moe_dense_residual") or model.get("shared_expert"):
            fr = model.get("residual_d_ff", f)
            out += [("ws1", d, fr), ("ws3", d, fr), ("ws2", fr, d)]
        out.append(("router", d, model["n_experts"]))
    else:
        out += [("w1", d, f), ("w3", d, f), ("w2", f, d)]
    return [(n, K, N) for n, K, N in out if K * N >= MIN_PACKED]


def matmul_params(model: Dict) -> int:
    """Parameters of the held layers one token multiplies: attention's
    projections and the SwiGLU, or, moe, attention, the dense residual,
    the router and its ``topk`` routed experts."""
    d, f, L = model["d_model"], model["d_ff"], model["n_layers"]
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H
    per = 2 * d * H * hd + 2 * d * Hkv * hd
    if model.get("n_experts"):
        per += model["topk"] * 3 * d * f + d * model["n_experts"]
        if model.get("moe_dense_residual") or model.get("shared_expert"):
            per += 3 * d * model.get("residual_d_ff", f)
    else:
        per += 3 * d * f
    return L * per
