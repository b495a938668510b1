"""Carry the JAX package's parameters into the port.

``params_from_jax(np_params, cfg)`` takes the JAX parameter pytree of a
ported family's model as nested dicts of numpy arrays (``jax.device_get``
of the family's ``init_params``; raw, not packed) and returns the port's
parameter dict: every layer stack split into a list of per-layer dicts
(dense ``layers``; hybrid ``rec1`` / ``rec2`` / ``attn`` / ``trail``;
audio ``encoder`` / ``decoder``), every other leaf carried as it is.  The
port then packs the weights with its own packer, which yields the JAX
packer's bytes.  This is how tests feed both packages the same
model without downloading weights.

JAX's bf16 and fp8 arrays reach numpy with an ``ml_dtypes`` dtype; they
are recognised by name and reinterpreted through their bit pattern, so
this module needs neither JAX nor ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w1", "w2", "w3")


#: ``ml_dtypes`` names numpy has no type for → (torch dtype, bit-pattern
#: carrier of the same width)
_BY_PATTERN = {"bfloat16": (torch.bfloat16, np.uint16),
               "float8_e5m2": (torch.float8_e5m2, np.uint8),
               "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8)}


def to_tensor(arr, device="cuda") -> torch.Tensor:
    """numpy array (bf16 / fp8 via their bit patterns) → torch tensor on
    device."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name in _BY_PATTERN:
        dt, carrier = _BY_PATTERN[arr.dtype.name]
        return torch.from_numpy(arr.view(carrier).copy()).view(dt).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _tree(node, device):
    """Nested dicts of numpy arrays → the same dicts of tensors."""
    if isinstance(node, Mapping):
        return {k: _tree(v, device) for k, v in node.items()}
    return to_tensor(node, device)


def _split(stack: Mapping[str, Any], n: int, device) -> List[Dict[str, Any]]:
    """A layer stack (every leaf with a leading axis of n) → n per-layer
    dicts of tensors."""
    def layer(node, i):
        if isinstance(node, Mapping):
            return {k: layer(v, i) for k, v in node.items()}
        return to_tensor(np.asarray(node)[i], device)
    return [layer(stack, i) for i in range(n)]


def params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """JAX parameters of a dense, hybrid or audio model (numpy leaves,
    layers stacked along a leading axis) → the port's parameter dict on
    ``device``."""
    if cfg.family == "dense" and not cfg.n_experts:
        stacks = {"layers": cfg.n_layers}
        missing = [k for k in _LAYER_KEYS if k not in np_params["layers"]]
        if missing:
            raise KeyError(f"JAX layer stack lacks {missing}")
    elif cfg.family == "hybrid":
        n_super = cfg.n_layers // cfg.rglru_period
        stacks = {"rec1": n_super, "rec2": n_super, "attn": n_super,
                  "trail": cfg.n_layers - n_super * cfg.rglru_period}
    elif cfg.family == "audio":
        stacks = {"encoder": cfg.enc_layers, "decoder": cfg.n_layers}
    else:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return {k: _split(v, stacks[k], device) if k in stacks
            else _tree(v, device) for k, v in np_params.items()}
