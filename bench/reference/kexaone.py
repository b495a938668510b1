"""Plain PyTorch reference of K-EXAONE-236B-A23B's held layers, in float32
with TF32 off.

It is handed the raw bf16 weights the program was handed (the layout of
``bench/archs/kexaone.py``'s ``draw``) and works out again what the program
derives from them, as ``bench.reference.model`` does for the decoder,
whose helpers it uses: every packed weight quantized to ``weight_bits`` in
groups along K and dequantized, each token's K and V quantized per head
to ``kv_bits`` before attention reads them, and ``act_bits`` (8) for the
control's A8 activations.

The layer equations (EXAONE 4.0's layer, ``modeling_exaone4.py``, with
DeepSeek-V3's ``noaux_tc`` router, which the published ``config.json``'s
``scoring_func``, ``n_group``, ``topk_group``, ``norm_topk_prob`` and
``routed_scaling_factor`` name)::

    x = x + post_attn_norm(Attn(x))        no norm before a sub-layer
    x = x + post_ffn_norm(FFN(x))

* attention: q, k, v = x·Wq, x·Wk, x·Wv; q and k RMS-normalised over the
  head dimension (one gain of width hd each, ``q_norm`` / ``k_norm``);
  interleaved RoPE (θ from the configuration) on the windowed layers
  only, none on a global layer (and no other positional encoding there);
  grouped-query causal attention scaled by ``1/sqrt(hd)``, a windowed
  layer's query at p seeing keys p − window + 1 … p (HF's mask);
* FFN: the leading ``first_dense_layers`` a SwiGLU of ``dense_d_ff``; the
  others ``Σ gate·expert(x) + shared(x)``: scores ``s = sigmoid(x·Wr)``,
  the top-k experts of ``s + b`` (``router_bias``: it selects and never
  weighs), gates the chosen experts' unbiased ``s`` over their sum times
  ``routed_scaling``, every choice kept (the published model is
  dropless), and one shared expert, a SwiGLU of ``d_ff``;
* a final RMSNorm and an untied head.  Every RMSNorm scales by ``1 + g``.

Where it departs from the published description: the multi-token
prediction layer is not held (no served token reads it); the router is
packed W4 as every GEMM weight of the program is; RoPE rotates
interleaved pairs, as the program does, where HF rotates halves (a fixed
permutation of the head dimension, the same model on permuted weights).
Whole sequences run layer by layer; a moe layer's experts run one at a
time, each dequantized once for every sequence's rows.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from .model import (ATTN_ROWS, Reference as DecoderReference, fake_quant,
                    float32_exact, rms_norm, rope, top_k)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> torch.Tensor:
    """q (n, H, hd), k and v (n, Hkv, hd) → (n, H·hd): causal, and with a
    ``window`` a query at p sees keys p − window + 1 … p; row blocks of
    ``ATTN_ROWS``, each over the keys it can see."""
    n, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, 1).transpose(0, 1)          # (H, n, hd)
    v = v.repeat_interleave(rep, 1).transpose(0, 1)
    out = torch.empty((n, H, hd), dtype=torch.float32, device=q.device)
    for r0 in range(0, n, ATTN_ROWS):
        r1 = min(n, r0 + ATTN_ROWS)
        k0 = 0 if window is None else max(0, r0 - window + 1)
        s = torch.einsum("rhd,hkd->hrk", q[r0:r1], k[:, k0:r1]) / \
            math.sqrt(hd)
        kpos = torch.arange(k0, r1, device=q.device)[None]
        qpos = torch.arange(r0, r1, device=q.device)[:, None]
        mask = kpos > qpos
        if window is not None:
            mask |= kpos <= qpos - window
        s = s.masked_fill(mask[None], float("-inf"))
        out[r0:r1] = torch.einsum("hrk,hkd->rhd", torch.softmax(s, -1),
                                  v[:, k0:r1])
    return out.reshape(n, H * hd)


class Reference(DecoderReference):
    """K-EXAONE's model of a configuration file's ``model`` entry over raw
    bf16 ``params`` under ``policy`` (module docstring); ``kv_bits`` /
    ``act_bits`` override the policy's (the control).  ``logits`` as the
    decoder reference's: ``route(layer, scores, at)`` is handed each
    routing layer's biased scores ``s + b`` and gives each sequence's
    expert ids, and at the positions ``at`` of the last layer the expert
    sets it leaves open; every choice is kept whatever keep it gives."""

    def _window(self, layer: int) -> Optional[int]:
        m = self.m
        period = m.get("local_global_period")
        if m.get("window") is None or \
                (period and layer % period == period - 1):
            return None
        return m["window"]

    def _moe(self, hs: List[torch.Tensor], lp: Dict, layer: int, route,
             at: Optional[Sequence[Sequence[int]]]):
        """The routed experts' sum of every sequence's rows; with ``at``
        also each position's sums under the sets left open there
        ((len(at[i]), A, d), the first the routing's own).  One pass over
        the experts serves both."""
        k = self.m["topk"]
        scores = [torch.sigmoid(self._lin(h, lp["router"])) for h in hs]
        biased = [s + lp["router_bias"].float() for s in scores]
        if route is None:
            picks = [(top_k(b, k), None, None) for b in biased]
        else:
            picks = route(layer, biased, at)
        xs, ss, shapes = list(hs), list(scores), []
        idx = [i for i, _, _ in picks]
        for h, s, pos, (_, _, alt) in zip(hs, scores, at or (), picks):
            if alt is None:
                continue
            a_idx = alt[0]                                   # (n_at, A, k)
            n, A = a_idx.shape[:2]
            rows = torch.as_tensor(list(pos), dtype=torch.long,
                                   device=h.device)
            xs.append(h[rows].repeat_interleave(A, 0))
            ss.append(s[rows].repeat_interleave(A, 0))
            idx.append(a_idx.reshape(n * A, k))
            shapes.append((n, A))
        y = self._combine(torch.cat(xs), torch.cat(ss), torch.cat(idx), lp)
        out = list(torch.split(y, [x.shape[0] for x in xs]))
        if not shapes:
            return out, None
        return out[:len(hs)], [a.reshape(n, A, -1) for a, (n, A) in
                               zip(out[len(hs):], shapes)]

    def _combine(self, x: torch.Tensor, scores: torch.Tensor,
                 idx: torch.Tensor, lp: Dict) -> torch.Tensor:
        """Rows x (n, d) through their chosen experts ``idx`` (n, k), each
        weighted by its unbiased score over the k's sum, times
        ``routed_scaling``."""
        p = scores.gather(-1, idx)
        gates = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-9) * \
            self.m.get("routed_scaling", 1.0)
        y = torch.zeros_like(x)
        for e in torch.unique(idx).tolist():
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            out = self._swiglu(x[rows], lp["we1"][e], lp["we3"][e],
                               lp["we2"][e])
            y.index_add_(0, rows, out * gates[rows, slot, None])
        return y

    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]],
               at: Sequence[Sequence[int]], route=None
               ) -> List[torch.Tensor]:
        """Float32 logits (len(at[i]), A, vocab) of sequence ``i`` at its
        positions ``at[i]``, each from the whole causal prefix; A is the
        number of expert sets ``route`` leaves open at the last layer (1
        without it; the first is its own)."""
        m, p = self.m, self.p
        dev = p["embed"].device
        d, H, Hkv = m["d_model"], m["n_heads"], m["n_kv_heads"]
        hd = m.get("head_dim") or d // H
        eps, theta = m.get("norm_eps", 1e-5), m.get("rope_theta", 10000.0)
        first = m.get("first_dense_layers", 0)
        last = len(p["layers"]) - 1
        with float32_exact():
            xs = [p["embed"][torch.as_tensor(list(s), device=dev)].float()
                  for s in seqs]
            alts = None
            for layer, lp in enumerate(p["layers"]):
                sizes = [x.shape[0] for x in xs]
                x = torch.cat(xs)
                q, kk, vv = (self._lin(x, lp[n]) for n in ("wq", "wk", "wv"))
                win = self._window(layer)
                att = []
                for qs, ks, vs in zip(*(torch.split(t, sizes)
                                        for t in (q, kk, vv))):
                    n = qs.shape[0]
                    qs = rms_norm(qs.reshape(n, H, hd), lp["q_norm"], eps)
                    ks = rms_norm(ks.reshape(n, Hkv, hd), lp["k_norm"], eps)
                    if win is not None:
                        qs, ks = rope(qs, theta), rope(ks, theta)
                    ks = fake_quant(ks, -1, self.kv_bits)
                    vs = fake_quant(vs.reshape(n, Hkv, hd), -1, self.kv_bits)
                    att.append(attention(qs, ks, vs, win))
                x = x + rms_norm(self._lin(torch.cat(att), lp["wo"]),
                                 lp["post_attn_norm"], eps)
                if layer < first:
                    y = self._swiglu(x, lp["w1"], lp["w3"], lp["w2"])
                else:
                    ys, alts = self._moe(list(torch.split(x, sizes)), lp,
                                         layer, route,
                                         at if layer == last else None)
                    shared = self._swiglu(x, lp["ws1"], lp["ws3"], lp["ws2"])
                    y = torch.cat(ys) + shared
                    if alts is not None:
                        # the rest of the row around each open set
                        alts = [b[list(pos)][:, None] + rms_norm(
                            a + s[list(pos)][:, None], lp["post_ffn_norm"],
                            eps) for b, s, pos, a in
                            zip(torch.split(x, sizes),
                                torch.split(shared, sizes), at, alts)]
                xs = list(torch.split(x + rms_norm(y, lp["post_ffn_norm"],
                                                   eps), sizes))
            out = []
            for i, (x, pos) in enumerate(zip(xs, at)):
                hx = x[list(pos)][:, None] if alts is None else alts[i]
                h = rms_norm(hx, p["final_norm"], eps)
                out.append(h @ p["lm_head"].float())
            return out
