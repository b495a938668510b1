"""Checkpointing: save / restore a training state (parameters + optimizer
state) to one ``.npz`` per step, in the reference's tree, with the
structure stored as a key-path index.

Port of ``repro.training.checkpoint``, without JAX or ``ml_dtypes``:
bf16 is stored as a uint16 view and fp8 as a uint8 view, tagged as the
reference tags them (``__bf16__``, ``__f8e4m3__``, ``__f8e5m2__``), and
restored through the same bit patterns.

**The reference's tree.**  The port keeps each layer stack as a list of
per-layer dicts (``convert.params_from_jax``) and its optimizer state as
one entry per group path (``"layers/wq"``, ``optimizer.leaf_groups``);
the reference keeps one (L, ...) leaf per path of a stack and nested
dicts.  :func:`save` writes the reference's tree: each list becomes one
leaf per path, its layers stacked along a new leading axis (a moe
layer's (E, K, N) experts become (L, E, K, N)), and each key holding
``/`` is nested (``['opt']['mu']['layers']['wq']``).  Leaves are numbered
in the order ``jax.tree_util`` flattens nested dicts (keys sorted) and
their paths written as ``jax.tree_util.keystr`` writes them, so a
``train()`` checkpoint of either package restores in the other.
:func:`restore` splits the stacks back into the port's lists.  A tree
with no list and no ``/`` in its keys is written and read as it is.

A layer stack with no layers (the hybrid family's ``trail`` when
``n_layers`` is a multiple of ``rglru_period``) is an empty list in the
port, which holds no shapes; the reference holds zero-length leaves
there, and their optimizer state.  The caller passes those leaves as
``empty``, in the reference's layout (``training.loop.empty_state``).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_BF16_TAG = "__bf16__"
_FP8_TAGS = {torch.float8_e4m3fn: "__f8e4m3__",
             torch.float8_e5m2: "__f8e5m2__"}
#: tag → (numpy carrier of the bit pattern, torch dtype)
_BY_TAG = {_BF16_TAG: (np.int16, torch.bfloat16),
           "__f8e4m3__": (np.uint8, torch.float8_e4m3fn),
           "__f8e5m2__": (np.uint8, torch.float8_e5m2)}

Path = Tuple[str, ...]
#: a reference leaf: its members as (layer index, tensor) — one member
#: with index None for a leaf that is not a stack
Members = List[Tuple[Optional[int], torch.Tensor]]


def _slots(tree, path: Path = (), layer: Optional[int] = None,
           out=None) -> List[Tuple[Path, Optional[int], torch.Tensor]]:
    """(reference path, layer index or None, tensor) of every leaf of a
    tree in the port's layout: a key ``"a/b"`` is the path ("a", "b"), a
    list item is a layer of the stack at its path."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k, v in tree.items():
            _slots(v, path + tuple(str(k).split("/")), layer, out)
    elif isinstance(tree, (list, tuple)):
        if layer is not None:
            raise ValueError(f"{_keystr(path)}: a layer stack inside a layer")
        for i, v in enumerate(tree):
            _slots(v, path, i, out)
    else:
        out.append((path, layer, tree))
    return out


def _reference(tree, empty=None) -> Dict[Path, Members]:
    """The reference's leaves of ``tree`` (and of the reference-layout
    ``empty``), in its order."""
    leaves: Dict[Path, Members] = {}
    for src in (tree, empty or {}):
        for path, layer, t in _slots(src):
            if src is not tree and path in leaves:
                raise ValueError(f"{_keystr(path)}: in the tree and in empty")
            leaves.setdefault(path, []).append((layer, t))
    for path, members in leaves.items():
        idx = [i for i, _ in members]
        if idx != [None] and idx != list(range(len(idx))):
            raise ValueError(f"{_keystr(path)}: neither one leaf nor one "
                             "leaf in every layer of a stack")
    return dict(sorted(leaves.items()))


def _keystr(path: Path) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _shape(members: Members) -> Tuple[int, ...]:
    shape = tuple(members[0][1].shape)
    return shape if members[0][0] is None else (len(members),) + shape


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor's bytes as numpy (bf16 / fp8 as their bit patterns) and
    the reference's tag."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16_TAG
    if t.dtype in _FP8_TAGS:
        return t.view(torch.uint8).numpy(), _FP8_TAGS[t.dtype]
    return t.numpy(), ""


def _from_numpy(arr: np.ndarray, tag: str) -> torch.Tensor:
    if tag in _BY_TAG:
        carrier, dt = _BY_TAG[tag]
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            carrier).copy()).view(dt)
    return torch.from_numpy(np.array(arr))


def save(path: str, tree: Any, step: int = 0, empty: Any = None) -> str:
    """Write ``tree`` (tensors on any device; the port's layout) and
    ``step`` to ``path`` in the reference's tree; ``empty``: the
    reference's leaves of layer stacks with no layers (module
    docstring)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, index = {}, []
    for i, (kp, members) in enumerate(_reference(tree, empty).items()):
        parts = [_to_numpy(t) for _, t in members]
        tag = parts[0][1]
        arr = parts[0][0] if members[0][0] is None else \
            np.stack([a for a, _ in parts])
        arrays[f"leaf_{i}"] = arr
        index.append({"key": f"leaf_{i}", "path": _keystr(kp), "tag": tag})
    np.savez(path, __index__=json.dumps({"step": step, "leaves": index}),
             **arrays)
    return path


def restore(path: str, like: Any, empty: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (the port's layout), each
    leaf on the device of ``like``'s and each layer of a stack its own
    tensor; returns (tree, step).  The file must hold the reference's
    tree of ``like`` (and of ``empty``, whose leaves are checked and
    dropped): raises ``ValueError`` when the leaf counts, a leaf's path
    or a leaf's shape differ."""
    ref = _reference(like, empty)
    got: Dict[Path, List[torch.Tensor]] = {}
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__index__"]))
        leaves_meta = meta["leaves"]
        if len(ref) != len(leaves_meta):
            raise ValueError(f"checkpoint has {len(leaves_meta)} leaves, "
                             f"model {len(ref)}")
        for lm, (kp, members) in zip(leaves_meta, ref.items()):
            if lm["path"] != _keystr(kp):
                raise ValueError(f"checkpoint leaf {lm['path']} where the "
                                 f"model has {_keystr(kp)}")
            arr = z[lm["key"]]
            if tuple(arr.shape) != _shape(members):
                raise ValueError(f"{lm['path']}: checkpoint shape "
                                 f"{tuple(arr.shape)}, model "
                                 f"{_shape(members)}")
            rows = [arr] if members[0][0] is None else list(arr)
            got[kp] = [_from_numpy(a, lm["tag"]).to(t.device)
                       for a, (_, t) in zip(rows, members)]
    return _rebuild(like, got), meta["step"]


def _rebuild(like, got: Dict[Path, List[torch.Tensor]], path: Path = (),
             layer: Optional[int] = None):
    """``like``'s structure with each leaf taken from ``got``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, got, path + tuple(str(k).split("/")), layer)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, got, path, i)
                          for i, v in enumerate(like))
    return got[path][0 if layer is None else layer]
