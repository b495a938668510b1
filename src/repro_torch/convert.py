"""Carry the JAX package's parameters into the port.

``params_from_jax(np_params, cfg)`` takes the JAX parameter pytree of a
dense-family model as nested dicts of numpy arrays (``jax.device_get`` of
``repro.models.transformer.init_params``; raw, not packed) and returns the
port's parameter dict: the layer stack split into a list of per-layer
dicts.  The port then packs the weights with its own packer, which yields
the JAX packer's bytes.  This is how tests feed both packages the same
model without downloading weights.

JAX's bf16 and fp8 arrays reach numpy with an ``ml_dtypes`` dtype; they
are recognised by name and reinterpreted through their bit pattern, so
this module needs neither JAX nor ``ml_dtypes``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

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


def params_from_jax(np_params: Mapping[str, Any], cfg: ModelConfig,
                    device="cuda") -> Dict[str, Any]:
    """JAX dense-family parameters (numpy leaves, layers stacked along a
    leading axis) → the port's parameter dict on ``device``."""
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    stack = np_params["layers"]
    missing = [k for k in _LAYER_KEYS if k not in stack]
    if missing:
        raise KeyError(f"JAX layer stack lacks {missing}")
    out: Dict[str, Any] = {
        "embed": to_tensor(np_params["embed"], device),
        "final_norm": to_tensor(np_params["final_norm"], device),
        "layers": [{k: to_tensor(np.asarray(stack[k])[i], device)
                    for k in _LAYER_KEYS} for i in range(cfg.n_layers)],
    }
    if "lm_head" in np_params:
        out["lm_head"] = to_tensor(np_params["lm_head"], device)
    return out
