"""Seeded raw bf16 weights, drawn on the device in the leaf layout of
``repro_torch.models.transformer.init_params``.

The values are the benchmark's own: one ``torch.Generator`` on the
device, every leaf drawn in f32 and stored bf16 (norm gains zero, the
embedding, head and router at scale 0.02, every other weight at
``1/sqrt(fan_in)``), large expert stacks in slices of experts.  The
same seed gives the same tensors, so the program and the reference are
handed the same weights without keeping a copy between them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

#: experts drawn per call (one slice's f32 at a time)
EXPERT_SLICE = 16


def _normal(gen: torch.Generator, shape, scale: Optional[float] = None
            ) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[0]
    scale = 1.0 / math.sqrt(fan_in) if scale is None else scale
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return w.mul_(scale).to(torch.bfloat16)


def _stack(gen: torch.Generator, E: int, shape) -> torch.Tensor:
    out = torch.empty((E,) + tuple(shape), dtype=torch.bfloat16,
                      device=gen.device)
    for e in range(0, E, EXPERT_SLICE):
        n = min(EXPERT_SLICE, E - e)
        out[e:e + n] = _normal(gen, (n,) + tuple(shape),
                               1.0 / math.sqrt(shape[0]))
    return out


def draw(model: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """Raw bf16 parameters of ``model`` (a configuration file's ``model``
    entry: the fields of ``repro_torch``'s ``ModelConfig``, with its
    ``drawn`` widths: ``residual_d_ff``, the dense residual's or shared
    expert's width where it is not ``d_ff``) for ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    d, f, V = model["d_model"], model["d_ff"], model["vocab"]
    H, Hkv = model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H

    def zeros():
        return torch.zeros(d, dtype=torch.bfloat16, device=device)
    params: Dict[str, Any] = {"embed": _normal(gen, (V, d), 0.02),
                              "final_norm": zeros()}
    layers = []
    for _ in range(model["n_layers"]):
        lp = {"ln1": zeros(), "ln2": zeros(),
              "wq": _normal(gen, (d, H * hd)),
              "wk": _normal(gen, (d, Hkv * hd)),
              "wv": _normal(gen, (d, Hkv * hd)),
              "wo": _normal(gen, (H * hd, d))}
        E = model.get("n_experts", 0)
        if E:
            lp["router"] = _normal(gen, (d, E), 0.02)
            lp["we1"] = _stack(gen, E, (d, f))
            lp["we3"] = _stack(gen, E, (d, f))
            lp["we2"] = _stack(gen, E, (f, d))
            if model.get("moe_dense_residual") or model.get("shared_expert"):
                fr = model.get("residual_d_ff", f)
                lp["ws1"] = _normal(gen, (d, fr))
                lp["ws3"] = _normal(gen, (d, fr))
                lp["ws2"] = _normal(gen, (fr, d))
        else:
            lp["w1"] = _normal(gen, (d, f))
            lp["w3"] = _normal(gen, (d, f))
            lp["w2"] = _normal(gen, (f, d))
        layers.append(lp)
    params["layers"] = layers
    if not model.get("tie_embeddings"):
        params["lm_head"] = _normal(gen, (d, V), 0.02)
    return params
