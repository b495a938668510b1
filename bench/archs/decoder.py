"""The decoder: the architecture of every configuration that names no
``arch`` (mistral-large-123b, dense; arctic-480b, moe).

Every held layer is the same layer, in the leaf layout of
``repro_torch.models.transformer.init_params``: RMSNorm before attention
and before the FFN, grouped-query attention with RoPE on every head
dimension (a sliding window on the layers that ``window`` and
``local_global_period`` make local), and a SwiGLU of width ``d_ff``, or a
routed moe FFN (softmax router, top-k, gates normalised over the k) beside
an optional dense residual of width ``residual_d_ff``.

What the harness reads of an architecture (``bench.harness.ARCH_API``),
bound here to the benchmark's own pieces: the raw weights
(``bench.weights.draw``), the plain reference
(``bench.reference.model.Reference``), the router's ranking, the work a
token passes through the packed GEMMs and the routed experts
(``bench.hw``), attention's geometry per layer, and the CPU cut.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from bench import hw, weights
from bench.reference.model import Reference

__all__ = ["draw", "Reference", "rank", "layer_gemms", "expert_gemms",
           "moe_layers", "matmul_params", "attn_layers", "tiny"]

#: the model's widths in the CPU tests' cut
WIDTHS = dict(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=1024,
              n_layers=2)

draw = weights.draw
matmul_params = hw.matmul_params


def rank(probs: torch.Tensor) -> torch.Tensor:
    """The values top-k orders: the router's log-probabilities, in f64."""
    return torch.log(probs.double())


def layer_gemms(model: Dict) -> List[List[Tuple[str, int, int]]]:
    """Per held layer, (leaf, K, N) of each packed weight a token passes
    through the GEMM kernel: every layer is the same."""
    return [hw.packed_gemms(model)] * model["n_layers"]


def expert_gemms(model: Dict) -> List[Tuple[str, int, int]]:
    """(leaf, K, N) of one routed expert's three products (its SwiGLU),
    none for a dense model."""
    if not model.get("n_experts"):
        return []
    d, f = model["d_model"], model["d_ff"]
    return [("we1", d, f), ("we3", d, f), ("we2", f, d)]


def moe_layers(model: Dict) -> List[Tuple[int, int]]:
    """(experts, top-k) of each held layer that routes: every layer of a
    moe model, none of a dense one."""
    if not model.get("n_experts"):
        return []
    return [(model["n_experts"], model["topk"])] * model["n_layers"]


def attn_layers(model: Dict) -> List[Tuple[int, int, int, Optional[int]]]:
    """(H, Hkv, D, window or None for global) of each held layer, the
    window as the program sets it (``models/transformer.layer_window``:
    the last layer of each ``local_global_period`` is global)."""
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    D = model.get("head_dim") or model["d_model"] // H
    win, period = model.get("window"), model.get("local_global_period")
    return [(H, Hkv, D, None if win is None or
             (period and i % period == period - 1) else win)
            for i in range(model["n_layers"])]


def tiny(cfg: Dict) -> None:
    """Cut a configuration's model to the CPU tests' widths, in place: two
    layers, or one moe layer of 8 experts with its residual at d_model."""
    m = cfg["model"]
    m.update(WIDTHS)
    if m.get("n_experts"):
        m.update(n_experts=8, n_layers=1)
        cfg["drawn"] = {"residual_d_ff": WIDTHS["d_model"]}
