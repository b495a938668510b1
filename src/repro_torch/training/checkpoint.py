"""Checkpointing: save / restore nested dicts and lists of tensors
(parameters + optimizer state) to one ``.npz`` per step, with the
structure stored as a key-path index.

Port of ``repro.training.checkpoint``, without JAX or ``ml_dtypes``:
bf16 is stored as a uint16 view and fp8 as a uint8 view, tagged as the
reference tags them (``__bf16__``, ``__f8e4m3__``, ``__f8e5m2__``), and
restored through the same bit patterns.  Leaves are numbered in the
reference's order (dict keys sorted, list items in order) and their paths
written as ``jax.tree_util.keystr`` writes them (``['layers'][0]['wq']``),
so a flat dict of arrays saved by either package restores in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, List, Tuple

import numpy as np
import torch

_BF16_TAG = "__bf16__"
_FP8_TAGS = {torch.float8_e4m3fn: "__f8e4m3__",
             torch.float8_e5m2: "__f8e5m2__"}
#: tag → (numpy carrier of the bit pattern, torch dtype)
_BY_TAG = {_BF16_TAG: (np.int16, torch.bfloat16),
           "__f8e4m3__": (np.uint8, torch.float8_e4m3fn),
           "__f8e5m2__": (np.uint8, torch.float8_e5m2)}


def _leaves(tree, path="") -> List[Tuple[str, torch.Tensor]]:
    """(key path, tensor) of every leaf, in the reference's order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def _rebuild(like, it):
    """``like``'s structure with its leaves taken from ``it`` in order."""
    if isinstance(like, dict):
        vals = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def save(path: str, tree: Any, step: int = 0) -> str:
    """Write ``tree`` (tensors on any device) and ``step`` to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, index = {}, []
    for i, (kp, leaf) in enumerate(_leaves(tree)):
        t = leaf.detach().cpu().contiguous()
        tag = ""
        if t.dtype == torch.bfloat16:
            arr, tag = t.view(torch.int16).numpy().view(np.uint16), \
                _BF16_TAG
        elif t.dtype in _FP8_TAGS:
            arr, tag = t.view(torch.uint8).numpy(), _FP8_TAGS[t.dtype]
        else:
            arr = t.numpy()
        arrays[f"leaf_{i}"] = arr
        index.append({"key": f"leaf_{i}", "path": kp, "tag": tag})
    np.savez(path, __index__=json.dumps({"step": step, "leaves": index}),
             **arrays)
    return path


def restore(path: str, like: Any) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (leaf order must match),
    each leaf on the device of ``like``'s; returns (tree, step).  Raises
    ``ValueError`` when the leaf counts or a leaf's shape differ."""
    flat_like = _leaves(like)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__index__"]))
        leaves_meta = meta["leaves"]
        if len(flat_like) != len(leaves_meta):
            raise ValueError(f"checkpoint has {len(leaves_meta)} leaves, "
                             f"model {len(flat_like)}")
        out = []
        for lm, (_, ref) in zip(leaves_meta, flat_like):
            arr = z[lm["key"]]
            if lm["tag"] in _BY_TAG:
                carrier, dt = _BY_TAG[lm["tag"]]
                t = torch.from_numpy(np.ascontiguousarray(arr).view(
                    carrier).copy()).view(dt)
            else:
                t = torch.from_numpy(arr.copy())
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"{lm['path']}: checkpoint shape "
                                 f"{tuple(t.shape)}, model "
                                 f"{tuple(ref.shape)}")
            out.append(t.to(ref.device))
    return _rebuild(like, iter(out)), meta["step"]
