"""K-EXAONE-236B-A23B (``exaone_moe``): the architecture of
``bench/configs/k-exaone-236b-a23b.w4a16kv8.json``.

Held layers in the published order: the leading ``first_dense_layers``
dense SwiGLUs of ``dense_d_ff``, then routed layers of ``n_experts``
experts of ``d_ff``, top-``topk`` by sigmoid scores with a selection bias,
beside a shared expert of ``d_ff``; windowed and global attention in
``local_global_period``; QK norms and norms after each sub-layer
(``bench.reference.kexaone`` has the equations).  What the harness reads
of an architecture (``bench.harness.ARCH_API``):

* ``draw``: the raw bf16 weights, in the leaf layout of the program's
  ``repro_torch.models.transformer.init_params`` for these fields: per
  layer ``post_attn_norm`` / ``post_ffn_norm`` (d) and ``q_norm`` /
  ``k_norm`` (hd) in place of ``ln1`` / ``ln2``; layer 0's ``w1`` / ``w3`` /
  ``w2`` at ``dense_d_ff``; a routed layer's ``router`` (d, E),
  ``router_bias`` (E,), stacks ``we1`` / ``we3`` / ``we2`` and the shared
  expert's ``ws1`` / ``ws3`` / ``ws2``.  Scales as ``bench.weights``'
  (embedding, head and router 0.02, other weights ``1/sqrt(fan_in)``),
  but norm gains at ``norm_gain_std`` around 1 (a gain read from the wrong
  leaf would show) and the bias at ``router_bias_std``, both the
  configuration's ``drawn`` values.  It first checks that the program's
  ``ModelConfig`` has the fields the configuration sets, so a program
  without them fails before drawing anything;
* ``Reference``: ``bench.reference.kexaone``'s, handed the check's routing
  through :class:`Dropless`;
* ``rank``: the biased scores ``s + b`` the router's top-k orders, in f64
  (``tie_eps`` is in score units);
* the work counts: ``layer_gemms`` per held layer (layer 0's SwiGLU,
  then each routed layer's attention, shared expert and router),
  ``expert_gemms`` one expert's SwiGLU, ``moe_layers`` the routed layers,
  ``matmul_params`` top-k experts and the shared expert a routed layer,
  ``attn_layers`` the window on the local layers;
* ``tiny``: 1 dense + 4 routed layers (one ``LLLG`` period) of 16 experts,
  top-4, window 8, at small widths.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from bench import check, hw
from bench.reference import kexaone
from bench.weights import _normal, _stack

__all__ = ["draw", "Reference", "rank", "layer_gemms", "expert_gemms",
           "moe_layers", "matmul_params", "attn_layers", "tiny"]

#: the program's ModelConfig fields this architecture sets
PROGRAM_FIELDS = ("qk_norm", "post_norms", "rope_local_only",
                  "first_dense_layers", "dense_d_ff", "router_scoring",
                  "routed_scaling")

#: the CPU tests' cut: one dense layer and one ``LLLG`` period of routed
#: layers, 16 experts, top-4, dropless at capacity factor E/k
TINY = dict(d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=256,
            dense_d_ff=512, vocab=1024, n_layers=5, n_experts=16, topk=4,
            capacity_factor=4.0, window=8)
#: the cut's drawn scales: a bias of twice its scores' spread (~0.15),
#: which reorders nearly every top-4 set; at a bias of 0.03 the program's
#: bf16 scores flipped 6-17 % of a layer's sets against the reference's
#: float32 ones, in layers the check cannot open (only the last), and its
#: readings of a sound run overlapped those of a run with RoPE on the
#: global layer or the bias in the gates; at 0.3, 0-3 % (CPU, 4 seeds)
TINY_DRAWN = dict(router_bias_std=0.3, norm_gain_std=0.1)
#: the cut's check: its ties (score units), and its limits from 12 seeds
#: of 6 s windows on the CPU (~120 served tokens each): a sound run read
#: max 0.019-0.362 (a flip) and mean 0.0003-0.0062, the KV4 control max
#: 0.316-0.546 and mean 0.0505-0.0838; so the mean tells them apart (×2
#: above the one, ×4 below the other) and the max catches gross faults
TINY_CHECK = dict(tie_eps=0.002, max_logit_gap=0.8, mean_logit_gap=0.0125)


def _program_has_fields() -> None:
    """Raise unless the program's ``ModelConfig`` has ``PROGRAM_FIELDS``."""
    from repro_torch.configs.base import ModelConfig
    have = {f.name for f in dataclasses.fields(ModelConfig)}
    missing = [f for f in PROGRAM_FIELDS if f not in have]
    if missing:
        raise ValueError(f"the program's ModelConfig has no {missing}: it "
                         "cannot serve K-EXAONE's layers")


def draw(model: Dict, seed: int, device) -> Dict:
    """Raw bf16 parameters of ``model`` (the configuration's ``model`` with
    its ``drawn`` scales) for ``seed`` (module docstring)."""
    _program_has_fields()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    d, f, V = model["d_model"], model["d_ff"], model["vocab"]
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H
    fd = model.get("dense_d_ff") or f
    E = model["n_experts"]
    g_std = model.get("norm_gain_std", 0.0)

    def gain(n):
        return _normal(gen, (n,), g_std)
    params: Dict = {"embed": _normal(gen, (V, d), 0.02),
                    "final_norm": gain(d)}
    layers = []
    for i in range(model["n_layers"]):
        lp = {"post_attn_norm": gain(d), "post_ffn_norm": gain(d),
              "q_norm": gain(hd), "k_norm": gain(hd),
              "wq": _normal(gen, (d, H * hd)),
              "wk": _normal(gen, (d, Hkv * hd)),
              "wv": _normal(gen, (d, Hkv * hd)),
              "wo": _normal(gen, (H * hd, d))}
        if i < model.get("first_dense_layers", 0):
            lp.update(w1=_normal(gen, (d, fd)), w3=_normal(gen, (d, fd)),
                      w2=_normal(gen, (fd, d)))
        else:
            lp.update(router=_normal(gen, (d, E), 0.02),
                      router_bias=_normal(gen, (E,),
                                          model["router_bias_std"]),
                      we1=_stack(gen, E, (d, f)), we3=_stack(gen, E, (d, f)),
                      we2=_stack(gen, E, (f, d)),
                      ws1=_normal(gen, (d, f)), ws3=_normal(gen, (d, f)),
                      ws2=_normal(gen, (f, d)))
        layers.append(lp)
    params["layers"] = layers
    params["lm_head"] = _normal(gen, (d, V), 0.02)
    return params


def rank(probs: torch.Tensor) -> torch.Tensor:
    """The values top-k orders: the biased sigmoid scores, in f64."""
    return probs.double()


class Dropless:
    """The check's ``Routing`` (``bench.check``) for a dropless model: its
    expert ids, every choice kept, and at the positions it leaves open
    only the distinct expert sets (its near-ties), not the keep
    alternatives its mixed-width rule opens beside padding rows, which
    cannot drop here.  Checks that no width the engine feeds can drop a
    choice (``capacity(w) >= w``), and rewrites the routing's ``ties`` and
    ``open`` to the distinct sets."""

    def __init__(self, route: check.Routing):
        self.route = route
        for rows in route.rows:
            for _, _, widths in rows:
                for w in widths:
                    cap = check.capacity(w, route.K, route.E, route.factor)
                    if cap < w:
                        raise ValueError(
                            f"capacity {cap} of a {w}-wide row can drop a "
                            f"choice: K-EXAONE is dropless (capacity "
                            f"factor {route.factor} < E/k)")

    def __call__(self, layer: int, probs: List[torch.Tensor], at):
        out = []
        picks = self.route(layer, probs, at)
        if at is not None:
            self.route.open = []
        for i, (idx, keep, alt) in enumerate(picks):
            keep = torch.ones_like(keep)
            if alt is not None:
                alt = self._distinct(i, alt[0])
            out.append((idx, keep, alt))
        return out

    def _distinct(self, i: int, ids: torch.Tensor):
        """(ids, kept) (len(at), A', k) of sequence ``i``'s distinct open
        sets, the routing's own first; its ties and open counts to match."""
        per, ties = [], []
        for r, (row, tie) in enumerate(zip(ids.tolist(),
                                           self.route.ties[i])):
            seen: Dict[Tuple[int, ...], int] = {}
            for a, s in enumerate(row):
                seen.setdefault(tuple(s), a)
            per.append([row[a] for a in seen.values()])
            ties.append([tie[a] for a in seen.values()])
            self.route.open.append(len(seen))
        A = max(len(p) for p in per)
        per = [p + [p[0]] * (A - len(p)) for p in per]
        self.route.ties[i] = [t + [t[0]] * (A - len(t)) for t in ties]
        ids = torch.tensor(per, dtype=ids.dtype, device=ids.device)
        return ids, torch.ones_like(ids, dtype=torch.bool)


class Reference(kexaone.Reference):
    """``bench.reference.kexaone.Reference``, the check's routing handed
    over through :class:`Dropless`."""

    def logits(self, seqs, at, route=None):
        return super().logits(seqs, at,
                              None if route is None else Dropless(route))


def _dense(model: Dict) -> int:
    return model.get("first_dense_layers", 0)


def layer_gemms(model: Dict) -> List[List[Tuple[str, int, int]]]:
    """Per held layer, (leaf, K, N) of each packed weight a token passes
    through the GEMM kernel: attention's four and the dense layer's SwiGLU
    at ``dense_d_ff``, or attention's, the shared expert's and the
    router."""
    dense = hw.packed_gemms(dict(model, n_experts=0,
                                 d_ff=model.get("dense_d_ff") or
                                 model["d_ff"]))
    routed = hw.packed_gemms(model)
    return [dense if i < _dense(model) else routed
            for i in range(model["n_layers"])]


def expert_gemms(model: Dict) -> List[Tuple[str, int, int]]:
    """(leaf, K, N) of one routed expert's three products (its SwiGLU)."""
    d, f = model["d_model"], model["d_ff"]
    return [("we1", d, f), ("we3", d, f), ("we2", f, d)]


def moe_layers(model: Dict) -> List[Tuple[int, int]]:
    """(experts, top-k) of each held layer that routes: all but the
    leading dense ones."""
    return [(model["n_experts"], model["topk"])] * \
        (model["n_layers"] - _dense(model))


def matmul_params(model: Dict) -> int:
    """Parameters of the held layers one token multiplies: attention's
    projections in every layer, the dense layers' SwiGLU, and in each
    routed layer the router, its top-k experts and the shared expert."""
    d, f, E, k = (model[n] for n in ("d_model", "d_ff", "n_experts", "topk"))
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H
    attn = 2 * d * H * hd + 2 * d * Hkv * hd
    dense = 3 * d * (model.get("dense_d_ff") or f)
    routed = d * E + k * 3 * d * f + 3 * d * f
    L, n = model["n_layers"], _dense(model)
    return L * attn + n * dense + (L - n) * routed


def attn_layers(model: Dict) -> List[Tuple[int, int, int, Optional[int]]]:
    """(H, Hkv, D, window or None for global) of each held layer (the last
    layer of each ``local_global_period`` is global)."""
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    D = model.get("head_dim") or model["d_model"] // H
    win, period = model.get("window"), model["local_global_period"]
    return [(H, Hkv, D, None if i % period == period - 1 else win)
            for i in range(model["n_layers"])]


def tiny(cfg: Dict) -> None:
    """Cut the configuration to the CPU tests' size, in place (``TINY``,
    ``TINY_DRAWN``, ``TINY_CHECK``): the routing stays dropless and the
    bias still reorders choices."""
    cfg["model"].update(TINY)
    cfg["drawn"] = dict(cfg.get("drawn", {}), **TINY_DRAWN)
    cfg["check"].update(TINY_CHECK)
