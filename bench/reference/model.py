"""Plain PyTorch reference of the served decoder (dense and moe), in
float32 with TF32 off.

It is handed the raw bf16 weights the program was handed, and works out
again what the program derives from them: every packed weight quantized
to ``weight_bits`` in groups along K and dequantized (the grouping rule
of ``bench.hw.weight_group``), each token's K and V quantized per head to
``kv_bits`` before attention reads them (the cache holds them so, the
token's own row included), and for moe the router's softmax, top-k,
normalised gates, capacity keep and combine.  ``act_bits`` (8) quantizes
each packed GEMM's input per token, the A8 activations of a lower
precision: the control.

The layer equations follow the program's model (``repro_torch.models.
transformer``): RMSNorm scaled by ``1 + g``, interleaved RoPE on every
head dimension, grouped-query causal attention scaled by ``1/sqrt(hd)``,
a SwiGLU or the MoE FFN beside a dense residual, a final RMSNorm and an
untied head.  Whole sequences run layer by layer, so the weights of one
layer are dequantized at a time.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: query rows of one attention block
ATTN_ROWS = 512
#: weights below this many elements stay bf16 (not quantized)
MIN_PACKED = 256 * 256
_MODEL_AXIS = 16


def parse_policy(name: str) -> Tuple[int, Optional[int], int]:
    """(weight bits, activation bits or None for 16, KV bits) of a
    ``WxAyKVz`` integer policy name such as ``w4a16kv8``."""
    m = re.fullmatch(r"w(4|8)a(8|16)kv(4|8|16)", name)
    if not m:
        raise ValueError(f"the reference runs integer WxAyKVz policies, got "
                         f"{name!r}")
    w, a, kv = (int(x) for x in m.groups())
    return w, (a if a < 16 else None), kv


def absmax_scale(x: torch.Tensor, dim: int, qmax: int) -> torch.Tensor:
    """Symmetric scale ``max(amax, 1e-8) * f32(1 / qmax)`` along ``dim``."""
    recip = float(np.float32(1.0) / np.float32(qmax))
    return torch.clamp_min(x.abs().amax(dim=dim, keepdim=True), 1e-8) * recip


def fake_quant(x: torch.Tensor, dim: int, bits: int) -> torch.Tensor:
    """x rounded half-even to ``bits``-bit symmetric integers along
    ``dim`` and scaled back, in float32."""
    qmax = 2 ** (bits - 1) - 1
    s = absmax_scale(x, dim, qmax)
    return torch.clamp(torch.round(x / s), -qmax, qmax) * s


def weight_group(K: int, group: int = 128) -> int:
    """The program's group for a (K, N) weight: its block_k (the first of
    128, 64, 32 dividing K, preferring one whose count of blocks divides
    16), capped at the policy's group."""
    best = None
    for b in (128, 64, 32):
        if K % b == 0:
            best = b if best is None else best
            if (K // b) % _MODEL_AXIS == 0:
                best = b
                break
    g = min(group, best)
    return best if best % g else g


def dequant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """(K, N) raw weight → its quantized values in float32."""
    K, N = w.shape
    if K * N < MIN_PACKED:
        return w.float()
    g = weight_group(K)
    return fake_quant(w.float().reshape(K // g, g, N), 1, bits).reshape(K, N)


@contextlib.contextmanager
def float32_exact():
    """float32 matmuls without TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        (1.0 + g.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Interleaved RoPE of x (n, heads, hd) at positions 0 .. n-1."""
    n, h, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], -1) \
        .reshape(n, h, hd)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """q (n, H, hd), k and v (n, Hkv, hd) → (n, H·hd), row blocks of
    ``ATTN_ROWS``."""
    n, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, 1).transpose(0, 1)          # (H, n, hd)
    v = v.repeat_interleave(rep, 1).transpose(0, 1)
    out = torch.empty((n, H, hd), dtype=torch.float32, device=q.device)
    for r0 in range(0, n, ATTN_ROWS):
        r1 = min(n, r0 + ATTN_ROWS)
        s = torch.einsum("rhd,hkd->hrk", q[r0:r1], k[:, :r1]) / math.sqrt(hd)
        mask = torch.arange(r1, device=q.device)[None] > \
            torch.arange(r0, r1, device=q.device)[:, None]
        s = s.masked_fill(mask[None], float("-inf"))
        out[r0:r1] = torch.einsum("hrk,hkd->rhd", torch.softmax(s, -1),
                                  v[:, :r1])
    return out.reshape(n, H * hd)


#: route(layer, probs of every sequence, positions or None) → a sequence's
#: (expert ids (n, k), kept (n, k), and with positions the routings left
#: open there: (ids, kept), each (len(positions), A, k))
Route = Callable[[int, List[torch.Tensor], Optional[Sequence[Sequence[int]]]],
                 List[Tuple[torch.Tensor, torch.Tensor, Optional[Tuple]]]]


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest, equal values in index order."""
    return torch.sort(probs, dim=-1, descending=True, stable=True) \
        .indices[..., :k]


class Reference:
    """The model of a configuration file's ``model`` entry over raw bf16
    ``params`` (the layout of ``bench.weights.draw``) under ``policy``.
    ``kv_bits`` / ``act_bits`` override the policy's (the control)."""

    def __init__(self, model: Dict, params: Dict, policy: str,
                 kv_bits: Optional[int] = None, act_bits: Optional[int] = 0):
        self.m, self.p = model, params
        self.w_bits, a_bits, kv = parse_policy(policy)
        self.kv_bits = kv if kv_bits is None else kv_bits
        self.act_bits = a_bits if act_bits == 0 else act_bits

    def _lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.act_bits and w.numel() >= MIN_PACKED:
            x = fake_quant(x, -1, self.act_bits)
        return x @ dequant_weight(w, self.w_bits)

    def _swiglu(self, x, w1, w3, w2):
        return self._lin(F.silu(self._lin(x, w1)) * self._lin(x, w3), w2)

    def _moe(self, hs: List[torch.Tensor], lp: Dict, layer: int,
             route: Optional[Route], at: Optional[Sequence[Sequence[int]]]
             ) -> Tuple[List[torch.Tensor], Optional[List[torch.Tensor]]]:
        """The moe FFN of every sequence's rows; with ``at``, also each
        position's outputs under the routing's alternatives there
        ((len(at[i]), A, d), the first alternative the routing's own).
        One pass over the experts serves both."""
        k = self.m["topk"]
        probs = [torch.softmax(self._lin(h, lp["router"]), -1) for h in hs]
        if route is None:
            picks = [(top_k(p, k), torch.ones(p.shape[0], k, dtype=torch.bool,
                                              device=p.device), None)
                     for p in probs]
        else:
            picks = route(layer, probs, at)
        xs, ps = list(hs), list(probs)
        idx = [i for i, _, _ in picks]
        keep = [kp for _, kp, _ in picks]
        shapes = []
        for h, p, pos, (_, _, alt) in zip(hs, probs, at or (), picks):
            if alt is None:
                continue
            a_idx, a_keep = alt                       # (n_at, A, k)
            n, A = a_idx.shape[:2]
            rows = torch.as_tensor(list(pos), dtype=torch.long,
                                   device=h.device)
            xs.append(h[rows].repeat_interleave(A, 0))
            ps.append(p[rows].repeat_interleave(A, 0))
            idx.append(a_idx.reshape(n * A, k))
            keep.append(a_keep.reshape(n * A, k))
            shapes.append((n, A))
        y = self._combine(torch.cat(xs), torch.cat(ps), torch.cat(idx),
                          torch.cat(keep), lp)
        out = list(torch.split(y, [x.shape[0] for x in xs]))
        if not shapes:
            return out, None
        return out[:len(hs)], [a.reshape(n, A, -1) for a, (n, A) in
                               zip(out[len(hs):], shapes)]

    def _combine(self, x: torch.Tensor, probs: torch.Tensor,
                 idx: torch.Tensor, keep: torch.Tensor, lp: Dict
                 ) -> torch.Tensor:
        """Rows x (n, d) through their chosen experts ``idx`` (n, k), the
        kept ones weighted by gates normalised over all k choices."""
        p = probs.gather(-1, idx)
        gates = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-9)
        y = torch.zeros_like(x)
        for e in torch.unique(idx[keep]).tolist():
            rows, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
            out = self._swiglu(x[rows], lp["we1"][e], lp["we3"][e],
                               lp["we2"][e])
            y.index_add_(0, rows, out * gates[rows, slot, None])
        return y

    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]],
               at: Sequence[Sequence[int]], route: Optional[Route] = None
               ) -> List[torch.Tensor]:
        """Float32 logits (len(at[i]), A, vocab) of sequence ``i`` at its
        positions ``at[i]``, each from the whole causal prefix.  ``route``
        replaces the moe layers' own top-k and keep-everything; A is the
        number of routings it leaves open at the last layer (1 without
        it; the first is its own)."""
        m, p = self.m, self.p
        dev = p["embed"].device
        d, H, Hkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
        hd = m.get("head_dim") or d // H
        eps, theta = m.get("norm_eps", 1e-5), m.get("rope_theta", 10000.0)
        last = len(p["layers"]) - 1
        with float32_exact():
            xs = [p["embed"][torch.as_tensor(list(s), device=dev)].float()
                  for s in seqs]
            alts = None
            for layer, lp in enumerate(p["layers"]):
                sizes = [x.shape[0] for x in xs]
                h = rms_norm(torch.cat(xs), lp["ln1"], eps)
                q, kk, vv = (self._lin(h, lp[n]) for n in ("wq", "wk", "wv"))
                att = []
                for qs, ks, vs in zip(*(torch.split(t, sizes)
                                        for t in (q, kk, vv))):
                    n = qs.shape[0]
                    qs = rope(qs.reshape(n, H, hd), theta)
                    ks = fake_quant(rope(ks.reshape(n, Hkv, hd), theta), -1,
                                    self.kv_bits)
                    vs = fake_quant(vs.reshape(n, Hkv, hd), -1, self.kv_bits)
                    att.append(causal_attention(qs, ks, vs))
                x = torch.cat(xs) + self._lin(torch.cat(att), lp["wo"])
                h2 = rms_norm(x, lp["ln2"], eps)
                if m.get("n_experts"):
                    ys, alts = self._moe(list(torch.split(h2, sizes)), lp,
                                         layer, route,
                                         at if layer == last else None)
                    res = self._swiglu(h2, lp["ws1"], lp["ws3"], lp["ws2"]) \
                        if "ws1" in lp else torch.zeros_like(h2)
                    y = torch.cat(ys) + res
                    if alts is not None:
                        # the rest of the row around each alternative
                        alts = [b[list(pos)][:, None] + a for b, pos, a in
                                zip(torch.split(x + res, sizes), at, alts)]
                else:
                    y = self._swiglu(h2, lp["w1"], lp["w3"], lp["w2"])
                xs = list(torch.split(x + y, sizes))
            out = []
            for i, (x, pos) in enumerate(zip(xs, at)):
                hx = x[list(pos)][:, None] if alts is None else alts[i]
                h = rms_norm(hx, p["final_norm"], eps)
                out.append(h @ p["lm_head"].float())
            return out
