"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro.models.moe``.  The reference runs the router through the
quantization-transparent linear and the experts as XLA einsums on
dequantized bf16 expert weights, outside any Pallas kernel; here a
packed router goes through :func:`repro_torch.models.common.linear` (the
mixed-precision GEMM kernels on the card), a bf16 one is a plain
f32-accumulated product.  An expert stack in the A16 kernel's fragment
order (``layout="frag_a16"``: the engine gives it to every packed stack
on the card) runs each routed expert's three products through
``kernels.mpgemm.mpgemm_a16`` on member ``w[e]``, with bf16 activations
under every policy; the CPU's tile stacks, bf16 training stacks and the
dry-run's run them as plain PyTorch matmuls on the dequantized member,
and a packed stack on the card in another layout raises.  Both sum bf16
products in f32 and round each product once to bf16, in other orders.
``trace.expert_ffn`` counts which path each expert's FFN took.

Two dispatch implementations, as in the reference, with its capacities,
priority orders and rounding points:

* ``einsum`` (the default) — Switch-style: each batch row is a group; an
  expert's buffer holds :func:`_capacity` tokens of its row, filled
  k-major (every row position's first choice before any second choice),
  then in row order; assignments past the buffer are dropped.  The
  combine is the reference's ``einsum`` against a bf16 combine tensor:
  f32 sums of ``bf16(gate) · out`` over the kept choices, rounded once.
* ``sort`` — MegaBlocks-style: one buffer per expert sized from the whole
  call's ``B·S·K`` assignments, filled in flattened (row, position,
  choice) order; the combine adds ``bf16(out · bf16(gate))`` into a bf16
  output, rounding after each add.

A third, ``static``, is the sort dispatch with every expert run on its
whole capacity buffer (the reference's production form: static shapes,
no host read), for the dry-run, whose fake tensors hold no values to
read: the same kept assignments and combine, the padding slots computed
and added with a gate of 0.

The reference's one-hot dispatch is an exact gather (one nonzero term
per buffer slot), so both are computed here by indexing.  Every expert's
FFN runs only on the tokens it kept: an expert that keeps none is skipped
and its weights are not read (its contribution in the reference is an
exact zero), and the padding slots of a buffer are not computed (their
rows are zero and nothing reads them).

Capacity is per call (``_capacity(cfg, S)`` from the call's S), so a
prompt chunk can drop tokens that a one-token step would keep: the
engine's chunk ≡ T 1, prefix on ≡ off and growth ≡ reservation streams
are bit for bit only where nothing is dropped.  Dense ≡ paged holds
regardless (both backends make the same calls).

Top-k ties go to the lower expert index, as ``jax.lax.top_k`` breaks them
(:func:`top_k`: a stable descending sort); bf16 router logits tie often.

The router scores by softmax (the JAX package's) or, with
``router_scoring="sigmoid"`` (K-EXAONE), by sigmoid, choosing the top-k by
the scores plus a per-layer selection bias and weighing them by the
unbiased scores; the gates are normalized over the k and scaled by
``routed_scaling`` (:func:`route`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core.packing import PackedWeight, dequantize_packed
from repro_torch.kernels import ops as KO

from . import common as C

_DISPATCH_IMPL = "einsum"


def set_dispatch_impl(name: str) -> None:
    """Pick the dispatch: ``"einsum"`` (default), ``"sort"`` or
    ``"static"`` (module docstring)."""
    global _DISPATCH_IMPL
    if name not in ("einsum", "sort", "static"):
        raise ValueError(f"unknown dispatch {name!r} (expected 'einsum', "
                         "'sort' or 'static')")
    _DISPATCH_IMPL = name


def dispatch_impl() -> str:
    """The dispatch in effect."""
    return _DISPATCH_IMPL


def _expert_weights(w, dtype=torch.bfloat16) -> torch.Tensor:
    """(E, K, N) view of expert weights in ``dtype`` (packed stacks are
    dequantized, member by member)."""
    if isinstance(w, PackedWeight):
        return dequantize_packed(w, dtype)
    return w.to(dtype)


def _expert(w, e: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Expert ``e``'s (K, N) weight in ``dtype``: the same values as
    ``_expert_weights(w)[e]``."""
    if isinstance(w, PackedWeight):
        return dequantize_packed(w[e], dtype)
    return w[e].to(dtype)


def _capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Per-expert buffer of one group: ``S·k·capacity_factor / E`` + 1,
    rounded up to a multiple of 4, at least 4."""
    c = int(tokens_per_group * cfg.topk * cfg.capacity_factor
            / cfg.n_experts) + 1
    return max(4, -(-c // 4) * 4)


def _sort_capacity(cfg: ModelConfig, assignments: int) -> int:
    """The sort dispatch's per-expert buffer, from the call's B·S·K
    assignments (decode steps have S 1, and a per-row buffer would give
    every expert a batch of padding)."""
    c = int(assignments * cfg.capacity_factor / cfg.n_experts) + 1
    return max(4, -(-c // 4) * 4)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 product of bf16 operands, f32 accumulation, rounded once
    (what the reference's bf16 einsum computes)."""
    return torch.matmul(a.float(), b.float()).to(torch.bfloat16)


def router_logits(x: torch.Tensor, router_w, policy) -> torch.Tensor:
    """(B, S, E) bf16 router logits: a packed router through the
    mixed-precision GEMM, a bf16 one as an f32-accumulated product rounded
    once (the reference's bf16 dot; cuBLAS's bf16 GEMM may reduce split-K
    partials in bf16, and a tie-breaking ulp of a router logit moves a
    token to another expert)."""
    if isinstance(router_w, PackedWeight):
        return C.linear(x, router_w, policy)
    return _mm(x.to(torch.bfloat16), router_w.to(torch.bfloat16))


def router_probs(x: torch.Tensor, router_w, policy) -> torch.Tensor:
    """(B, S, E) f32 softmax of the router's bf16 logits
    (:func:`router_logits`)."""
    return torch.softmax(router_logits(x, router_w, policy).float(), dim=-1)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` values and their indices along the last axis, equal
    values in index order (``jax.lax.top_k``'s order; ``torch.topk``
    promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def biased_top_k(scores: torch.Tensor, bias: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` experts of the largest ``scores + bias`` and their
    *unbiased* scores: the bias selects and never weighs (DeepSeek-V3's
    ``noaux_tc`` gate with one group)."""
    _, idx = top_k(scores + bias.float(), k)
    return scores.gather(-1, idx), idx


def route(x: torch.Tensor, lp: Dict[str, Any], cfg: ModelConfig, policy
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router scores (B, S, E) f32 — the softmax of its logits, or with
    ``router_scoring="sigmoid"`` their sigmoid, whose top-k is chosen by
    the scores plus the layer's ``router_bias`` (:func:`biased_top_k`) —
    then the top-k gates (B, S, k) f32, normalized over the k and scaled
    by ``routed_scaling``, and their expert ids (B, S, k)."""
    if cfg.router_scoring == "sigmoid":
        probs = torch.sigmoid(
            router_logits(x, lp["router"], policy).float())
        vals, idx = biased_top_k(probs, lp["router_bias"], cfg.topk)
    else:
        probs = router_probs(x, lp["router"], policy)
        vals, idx = top_k(probs, cfg.topk)
    vals = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    if cfg.routed_scaling != 1.0:
        vals = vals * cfg.routed_scaling
    return probs, vals, idx


def _expert_mm(x: torch.Tensor, w, e: int, packed: bool) -> torch.Tensor:
    """bf16 ``x @ w[e]``, f32 sums rounded once: through the A16 GEMM on
    the member as it lies in its stack (``packed``), else :func:`_mm` of
    the dequantized member."""
    return KO.mpgemm_a16(x, w[e]) if packed else _mm(x, _expert(w, e))


def _swiglu(xs: torch.Tensor, ws, e: int, packed: bool) -> torch.Tensor:
    """Member ``e``'s SwiGLU of the stacks ``ws`` (we1, we3, we2) on xs
    (n, d) bf16 → (n, d) bf16, with the reference's rounding points; each
    product by :func:`_expert_mm`."""
    h1 = _expert_mm(xs, ws[0], e, packed)
    h3 = _expert_mm(xs, ws[1], e, packed)
    h = F.silu(h1.float()).to(torch.bfloat16) * h3
    return _expert_mm(h, ws[2], e, packed)


def _expert_ffn(xs: torch.Tensor, lp: Dict[str, Any], e: int
                ) -> torch.Tensor:
    """Expert ``e``'s SwiGLU on its kept rows xs (n, d) bf16 → (n, d)
    bf16: through the A16 GEMM when all three stacks are in its order,
    else plain (module docstring); a packed stack on the card in any
    other order raises (the engine lays every one out)."""
    ws = lp["we1"], lp["we3"], lp["we2"]
    packed = all(isinstance(w, PackedWeight) and w.layout == "frag_a16"
                 for w in ws)
    if not packed and xs.device.type == "cuda" and \
            any(isinstance(w, PackedWeight) for w in ws):
        raise ValueError(
            "packed expert stacks on the card are read in the A16 GEMM's "
            "fragment order (core.packing.to_kernel_layout(w, 'a16'), as "
            "serving.engine.quantize_params lays them out); got layouts "
            f"{[getattr(w, 'layout', 'bf16') for w in ws]}")
    trace.expert_ffn(packed, xs.shape[0])
    return _swiglu(xs, ws, e, packed)


def dispatch_einsum(gate_idx: torch.Tensor, E: int, cap: int
                    ) -> torch.Tensor:
    """The einsum dispatch's kept assignments: (B, S, k) bool — an
    assignment is kept when its position in its expert's per-row buffer
    (filled k-major, then in row order) is below ``cap``."""
    B, S, K = gate_idx.shape
    counts = torch.zeros((B, E), dtype=torch.long, device=gate_idx.device)
    keep = []
    for k in range(K):
        onehot = F.one_hot(gate_idx[..., k].long(), E)          # (B, S, E)
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None]
        kept = (pos * onehot).sum(-1) < cap                     # (B, S)
        keep.append(kept)
        counts = counts + (onehot * kept[..., None]).sum(1)
    return torch.stack(keep, -1)


def sort_slots(gate_idx: torch.Tensor, E: int, cap: int) -> torch.Tensor:
    """The sort dispatch's buffers as an (E, cap) table of flattened
    assignment indices (:func:`dispatch_sort`'s kept ones, each at its
    position in its expert's buffer); an empty slot holds B·S·k, one past
    the last assignment.  Static shapes: no host read."""
    eid = gate_idx.reshape(-1).long()
    n = eid.numel()
    order = torch.sort(eid, stable=True).indices
    eid_s = eid[order]
    start = torch.searchsorted(eid_s, torch.arange(E, device=eid.device))
    pos_s = torch.arange(n, device=eid.device) - start[eid_s]
    slot = torch.where(pos_s < cap, eid_s * cap + pos_s,
                       torch.full_like(pos_s, E * cap))
    table = torch.full((E * cap + 1,), n, dtype=torch.long,
                       device=eid.device)
    table.index_put_((slot,), order)       # the extra slot takes the dropped
    return table[:E * cap].reshape(E, cap)


def dispatch_sort(gate_idx: torch.Tensor, E: int, cap: int
                  ) -> torch.Tensor:
    """The sort dispatch's kept assignments: (B·S·k,) bool over the
    flattened (row, position, choice) order — each expert keeps its first
    ``cap`` in that order (a stable sort by expert id)."""
    eid = gate_idx.reshape(-1).long()
    order = torch.sort(eid, stable=True).indices
    eid_s = eid[order]
    start = torch.searchsorted(eid_s, torch.arange(E, device=eid.device))
    pos_s = torch.arange(eid.numel(), device=eid.device) - start[eid_s]
    keep = torch.empty_like(eid, dtype=torch.bool)
    keep[order] = pos_s < cap
    return keep


#: expert parallelism for DTensor operands (the sharded training step),
#: installed by launch code (``launch/train.py``): ``fn(x, lp, cfg,
#: policy) -> out``
_SHARDED_FFN = None


def set_sharded_ffn(fn) -> None:
    """Install (or, with None, remove) the DTensor path of :func:`moe_ffn`."""
    global _SHARDED_FFN
    _SHARDED_FFN = fn


def rows_route_alone() -> bool:
    """Whether a shard of batch rows routes as it would in the whole
    batch: the einsum dispatch's capacity is per row, the sort (and
    static) dispatch's the whole call's."""
    return _DISPATCH_IMPL == "einsum"


def moe_ffn(x: torch.Tensor, lp: Dict[str, Any], cfg: ModelConfig,
            policy=None) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d), groups = batch rows (module docstring).
    DTensor operands go to the installed :func:`set_sharded_ffn`."""
    if A.is_dtensor(x):
        if _SHARDED_FFN is None:
            raise ValueError("moe_ffn of DTensors needs the sharded step's "
                             "expert parallelism (set_sharded_ffn)")
        return _SHARDED_FFN(x, lp, cfg, policy)
    trace.moe_layer()
    with trace.span("moe.ffn"):
        return moe_partial(x, lp, cfg, policy).to(x.dtype)


def moe_partial(x: torch.Tensor, lp: Dict[str, Any], cfg: ModelConfig,
                policy=None, experts: Optional[range] = None
                ) -> torch.Tensor:
    """The combine's sums (B, S, d) before :func:`moe_ffn` rounds them to
    x's dtype — f32 (einsum) or bf16 (sort) — over the experts in
    ``experts`` (default all), whose weights ``lp``'s stacks hold in that
    order.  Routing and capacity are computed over all of x's tokens and
    all experts either way, so the sums of disjoint ranges of experts add
    up to the whole (the sharded step's expert parallelism)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.topk
    experts = range(E) if experts is None else experts
    with trace.span("moe.route"):
        _, gates, gate_idx = route(x, lp, cfg, policy)
    xt = x.to(torch.bfloat16).reshape(B * S, d)
    tok = torch.arange(B * S, device=x.device).repeat_interleave(K)
    eid = gate_idx.reshape(-1).long()
    g = gates.reshape(-1).to(torch.bfloat16)       # the combine's bf16 gate
    if _DISPATCH_IMPL == "static":
        cap = _sort_capacity(cfg, B * S * K)
        table = sort_slots(gate_idx, E, cap)
        zero = torch.zeros(1, dtype=tok.dtype, device=x.device)
        tok_p = torch.cat([tok, zero])
        g_p = torch.cat([g, torch.zeros(1, dtype=g.dtype, device=x.device)])
        y = torch.zeros((B * S, d), dtype=torch.bfloat16, device=x.device)
        for e in experts:
            slots = table[e]
            rows = tok_p[slots]
            out = _expert_ffn(xt[rows], lp, e - experts.start)
            y.index_add_(0, rows, out * g_p[slots, None])
        return y.reshape(B, S, d)
    with trace.span("moe.dispatch"):
        if _DISPATCH_IMPL == "sort":
            keep = dispatch_sort(gate_idx, E, _sort_capacity(cfg, B * S * K))
            y = torch.zeros((B * S, d), dtype=torch.bfloat16,
                            device=x.device)
        else:
            keep = dispatch_einsum(gate_idx, E,
                                   _capacity(cfg, S)).reshape(-1)
            y = torch.zeros((B * S, d), dtype=torch.float32,
                            device=x.device)
        # three host reads: the kept assignments (nonzero), which experts
        # hold one (unique, then tolist)
        kept = torch.nonzero(keep).reshape(-1)
        touched = torch.unique(eid[kept]).tolist()
        trace.sync(3)
    with trace.span("moe.experts"):
        for e in touched:
            if e not in experts:
                continue
            # and one more an expert: its kept rows (a boolean-mask index)
            sel = kept[eid[kept] == e]
            trace.sync()
            out = _expert_ffn(xt[tok[sel]], lp, e - experts.start)
            if _DISPATCH_IMPL == "sort":
                y.index_add_(0, tok[sel], out * g[sel, None])
            else:
                y.index_add_(0, tok[sel], out.float() * g[sel, None].float())
    return y.reshape(B, S, d)


def load_balance_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: ``E · Σ_e f_e · P_e`` (f from each
    token's first choice)."""
    onehot = F.one_hot(gate_idx[..., 0].long(), n_experts).float()
    f = onehot.mean(dim=(0, 1))
    p = probs.float().mean(dim=(0, 1))
    return n_experts * torch.sum(f * p)
