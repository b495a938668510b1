"""Sharding rules: parameters, optimizer state, caches and batch inputs →
specs, and specs → DTensor placements.

Port of ``repro.launch.sharding``: Megatron-style tensor parallelism on
the "model" axis plus FSDP-style weight sharding on the data axes for
``big_model`` configs — column-parallel weights (output features) on
"model", row-parallel ones (input features) on "model", expert stacks'
expert axis on "model", embeddings on vocab, KV caches on heads or else
on the sequence (the reference's module docstring has the reasoning).

**Specs.**  A spec is written in the reference's terms: a tuple with one
entry per tensor dim, each ``None``, an axis name, or a tuple of axis
names (the dim split over those axes, row-major).  :func:`placements`
turns one into DTensor placements for a ``DeviceMesh`` (``Shard(d)`` on
each named mesh dim, in order) and :func:`distribute` a tree of tensors
into DTensors.

**The port's leaves.**  The reference holds each layer stack as one
(L, ...) leaf (a moe layer's experts as (L, E, K, N)); the port holds a
list of per-layer leaves.  The rules decide on the reference's leaf: a
per-layer leaf of a stack of L layers gets the spec of the (L, ...) leaf
with its leading entry dropped (always None: no rule shards the layer
axis), so the two packages shard every weight alike.  The optimizer state
is stacked already (``training/optimizer.py``) and is specced as the
reference's tree.

**Packed weights.**  On the tile layout, ``data`` (Kt, Nt, bk_store, bn)
and ``scales`` (K/group, N) get the reference's specs.  The CUDA GEMMs'
fragment layout (``core/packing.py``) holds ``data`` as (N/16, K/64, 32,
4·bits), an expert stack's with E first: its spec puts the reference's
decision for E on dim 0 of a stack, for N on the next dim and for K on
the one after, made on the counts a shard can take whole — 16-wide
column blocks and K units holding whole 64-deep fragments and whole
scale groups (:meth:`ShardingRules.frag_spec`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from .mesh import axis_names, axis_size, data_axes

#: one entry of a spec: replicated, one axis, or axes in row-major order
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# weight name → parallel style (the reference's tables)
_COLUMN = ("wq", "wk", "wv", "w1", "w3", "ws1", "ws3", "we1", "we3",
           "ck", "wr", "wg", "wx", "wy", "wa", "wi", "xwq", "xwk", "xwv",
           "cr", "lm_head")
_ROW = ("wo", "w2", "ws2", "we2", "cv", "xwo")
_REPLICATED = ("router", "w_A", "w_B", "img_proj")   # small / odd shapes


def _style(name: str) -> str:
    if name in _ROW:
        return "row"
    if name in _COLUMN:
        return "column"
    if name in _REPLICATED:
        return "replicated"
    return "other"


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0 and n >= by


def _pad(spec: Sequence[Entry], ndim: int) -> Spec:
    """A spec of exactly ``ndim`` entries (missing trailing ones None)."""
    return tuple(spec) + (None,) * (ndim - len(spec))


class ShardingRules:
    """The reference's rules for one mesh and config.  ``mesh`` is a
    ``DeviceMesh`` or any object with ``axis_names`` and a ``shape``
    mapping (:mod:`.mesh`)."""

    def __init__(self, mesh, cfg, fsdp: bool = True):
        self.mesh = mesh
        self.cfg = cfg
        self.model = "model"
        self.model_size = axis_size(mesh, "model")
        self.data = data_axes(mesh)          # ("data",) or ("pod", "data")
        self.data_size = axis_size(mesh, self.data)
        # FSDP spreads big-model weights over the data axes (for decode
        # serving the reference passes fsdp=False)
        self.fsdp: Optional[Tuple[str, ...]] = \
            self.data if (cfg.big_model and fsdp) else None

    # -- parameters -------------------------------------------------------

    def _expert_axis(self, name: str, ndim: int) -> Optional[int]:
        """Expert stacks (we1/we2/we3): (L, E, ...) — E at axis 1."""
        if name in ("we1", "we2", "we3") and ndim >= 3:
            return 1
        return None

    # attention projections: TP must land WHOLE heads per device
    _Q_HEADS = ("wq", "xwq")
    _KV_HEADS = ("wk", "wv", "xwk", "xwv")
    _O_HEADS = ("wo", "xwo")

    def _heads_ok(self, name: str) -> bool:
        if self.cfg.family == "ssm":
            # rwkv's wk/wv/wo are (d, d) projections feeding per-head
            # (rwkv_head_dim-wide) recurrences: d / rwkv_head_dim heads
            heads = self.cfg.d_model // self.cfg.rwkv_head_dim
            return _div(heads, self.model_size)
        if name in self._Q_HEADS or name in self._O_HEADS:
            return _div(self.cfg.n_heads, self.model_size)
        if name in self._KV_HEADS:
            return _div(self.cfg.n_kv_heads, self.model_size)
        return True

    def _matrix_spec(self, name: str, shape, K_ax: int, N_ax: int,
                     expert_ax: Optional[int] = None) -> Spec:
        """Spec for a (.., K, N) weight given its parallel style: the
        style's natural dim (column → N, row → K) on "model" when it
        divides and the heads allow (else replicated over "model", never
        the other dim), expert stacks' E on "model", and with FSDP the off
        dim over the data axes — or the innermost data axis alone when the
        combined size does not divide."""
        style = _style(name)
        spec: list = [None] * len(shape)
        model_used = False
        if expert_ax is not None and _div(shape[expert_ax], self.model_size):
            spec[expert_ax] = self.model
            model_used = True
        natural = N_ax if style == "column" else K_ax
        if (not model_used and style in ("column", "row")
                and self._heads_ok(name)
                and _div(shape[natural], self.model_size)):
            spec[natural] = self.model
            model_used = True
        if self.fsdp:
            candidates = [self.fsdp]
            if len(self.fsdp) > 1:
                candidates.append((self.fsdp[-1],))
            done = False
            for ax in ((K_ax, N_ax) if style == "column" else (N_ax, K_ax)):
                for cand in candidates:
                    if spec[ax] is None and _div(shape[ax],
                                                 axis_size(self.mesh, cand)):
                        spec[ax] = cand
                        done = True
                        break
                if done:
                    break
        return tuple(spec)

    def reference_spec(self, wname: str, field: str, shape) -> Spec:
        """The reference's ``param_spec`` for its leaf of ``shape`` (stacked
        leaves with their L axis) named ``wname``; ``field`` is "data" or
        "scales" for a packed weight's tile-layout leaves, else ""."""
        ndim = len(shape)
        if wname == "embed":
            return _pad((self.model if _div(shape[0], self.model_size)
                         else None,), ndim)
        if wname == "dec_pos" or ndim <= 1:
            return _pad((), ndim)
        style = _style(wname)
        if style == "replicated":
            return _pad((), ndim)
        if field == "data" and ndim >= 4:
            # tile-major (..., Kt, Nt, bk_store, bn): the tile grid shards
            # exactly as the logical (K, N) would
            return self._matrix_spec(wname, shape, ndim - 4, ndim - 3,
                                     expert_ax=self._expert_axis(wname, ndim))
        if field == "scales" and ndim >= 2:
            # (..., G, N): G co-shards with Kt, N with Nt; no FSDP
            G_ax, N_ax = ndim - 2, ndim - 1
            spec: list = [None] * ndim
            eax = self._expert_axis(wname, ndim)
            if eax is not None and _div(shape[eax], self.model_size):
                spec[eax] = self.model
                return tuple(spec)
            natural = N_ax if style == "column" else G_ax
            if self._heads_ok(wname) and _div(shape[natural],
                                              self.model_size):
                spec[natural] = self.model
            return tuple(spec)
        if ndim >= 2:
            return self._matrix_spec(wname, shape, ndim - 2, ndim - 1,
                                     expert_ax=self._expert_axis(wname, ndim))
        return _pad((), ndim)

    def param_spec(self, wname: str, leaf, field: str = "",
                   n_stack: Optional[int] = None) -> Spec:
        """Spec of a port leaf named ``wname``: a member of a stack of
        ``n_stack`` layers gets the (n_stack, ...) reference leaf's spec
        without its layer entry."""
        shape = tuple(leaf.shape)
        if n_stack is None:
            return self.reference_spec(wname, field, shape)
        spec = self.reference_spec(wname, field, (n_stack,) + shape)
        if spec[0] is not None:
            raise ValueError(f"{wname}: the rule shards the layer axis "
                             f"({spec}); a per-layer leaf cannot hold that")
        return spec[1:]

    def frag_spec(self, wname: str, p, n_stack: Optional[int] = None
                  ) -> Spec:
        """Spec of a fragment-layout packed weight's ``data`` (N/16, K/64,
        32, 4·bits), or an expert stack's (E, N/16, K/64, 32, 4·bits): the
        reference's (E, K, N) decision made on the counts a shard can
        take whole — K in units of whole 64-deep fragments and whole
        scale groups (K / lcm(64, group)), N in 16-wide blocks — with E's
        entry first, then N's and K's.  A K of 32 × odd (a 32-deep tail
        chunk) is one unit: no shard holds its K whole."""
        K, N = p.shape
        units = (K // math.lcm(64, p.group) if K % 64 == 0 else 1, N // 16)
        lead = () if n_stack is None else (n_stack,)
        experts = (p.n_members,) if p.stacked else ()
        shape = lead + experts + units
        spec = self._matrix_spec(wname, shape, len(shape) - 2,
                                 len(shape) - 1,
                                 expert_ax=len(lead) if experts else None)
        if lead and spec[0] is not None:
            raise ValueError(f"{wname}: the rule shards the layer axis")
        *e_entry, k_entry, n_entry = spec[len(lead):]
        return tuple(e_entry) + (n_entry, k_entry, None, None)

    def params(self, tree) -> Any:
        """Specs of a port parameter tree (dicts, layer lists, tensors and
        PackedWeights; a PackedWeight gets a ``{"data", "scales"}`` dict of
        specs)."""
        from repro_torch.core.packing import PackedWeight

        def walk(node, name, n_stack):
            if isinstance(node, dict):
                return {k: walk(v, k, n_stack) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v, name, len(node)) for v in node)
            if isinstance(node, PackedWeight):
                if node.layout == "tile":
                    data = self.param_spec(name, node.data, "data", n_stack)
                else:
                    data = self.frag_spec(name, node, n_stack)
                return {"data": data, "scales": self.param_spec(
                    name, node.scales, "scales", n_stack)}
            return self.param_spec(name, node, "", n_stack)

        return walk(tree, "", None)

    def _stacked_specs(self, params_tree):
        """(reference shape, reference spec) of every parameter leaf, in
        the reference's flatten order (dict keys sorted, stacks as one
        (L, ...) leaf)."""
        from repro_torch.training.optimizer import leaf_groups
        nested: Dict[str, Any] = {}
        for path, (stacked, members) in leaf_groups(params_tree).items():
            shape = ((len(members),) if stacked else ()) + \
                tuple(members[0].shape)
            keys = path.split("/")
            node = nested
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = (shape, self.reference_spec(keys[-1], "",
                                                         shape))
        out = []

        def flat(node):
            for k in sorted(node):
                v = node[k]
                if isinstance(v, dict):
                    flat(v)
                else:
                    out.append(v)

        flat(nested)
        return out

    def opt_state(self, params_tree, opt_state_tree) -> Any:
        """Specs of the optimizer state (stacked on the reference's
        leaves): a moment inherits the spec of the first parameter of its
        shape in the reference's flatten order; scalars and factored
        Adafactor leaves of no parameter's shape replicate."""
        by_shape: Dict[tuple, Spec] = {}
        for shape, spec in self._stacked_specs(params_tree):
            by_shape.setdefault(shape, spec)

        def per(node):
            if isinstance(node, dict):
                return {k: per(v) for k, v in node.items()}
            shape = tuple(node.shape)
            return by_shape.get(shape, _pad((), len(shape)))

        return per(opt_state_tree)

    # -- caches -----------------------------------------------------------

    def _kv_spec(self, leaf) -> Spec:
        """(L, B, S, H, D)-family cache leaf: batch on the data axes, heads
        on "model" when divisible, else the sequence (sequence-parallel
        KV)."""
        return self._kv_shape_spec(tuple(leaf.shape))

    def _kv_shape_spec(self, shape) -> Spec:
        spec: list = [None] * len(shape)
        if len(shape) >= 2 and _div(shape[1], self.data_size):
            spec[1] = self.data
        if len(shape) >= 4:
            if _div(shape[3], self.model_size):
                spec[3] = self.model
            elif _div(shape[2], self.model_size):
                spec[2] = self.model
        return tuple(spec)

    def cache_spec(self, field: str, shape) -> Spec:
        """Spec of a reference cache leaf of ``shape`` (a stacked (L, B,
        ...) leaf) of ``field``: k / v and their scales by
        :meth:`_kv_spec`; any other state batch on the data axes, rwkv's
        wkv heads (dim 2) or else the last dim on "model" when
        divisible."""
        shape = tuple(shape)
        if field in ("k", "v", "k_scale", "v_scale"):
            return self._kv_shape_spec(shape)
        spec: list = [None] * len(shape)
        if len(shape) >= 2 and _div(shape[1], self.data_size):
            spec[1] = self.data
        if field == "wkv" and len(shape) >= 3 and \
                _div(shape[2], self.model_size):
            spec[2] = self.model
        elif len(shape) >= 3 and _div(shape[-1], self.model_size):
            spec[-1] = self.model
        return tuple(spec)

    #: cache fields the port keeps once for every layer, where the
    #: reference stacks a copy per layer: specced as one layer of the stack
    SHARED_CACHE_FIELDS = ("block_table",)

    def cache(self, cache_tree) -> Any:
        """Specs of a cache (the port's cache dataclasses hold the
        reference's stacked (L, ...) leaves, but one block table for all
        layers): a dict per dataclass, by field; a leaf's field is the
        innermost dataclass field above it, as the reference reads its
        dataclasses' paths."""
        def walk(node, field):
            if dataclasses.is_dataclass(node):
                return {f.name: walk(getattr(node, f.name), f.name)
                        for f in dataclasses.fields(node)}
            if isinstance(node, dict):
                return {k: walk(v, field) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v, field) for v in node)
            if node is None or not hasattr(node, "shape"):
                return None
            if field in self.SHARED_CACHE_FIELDS:
                return self.cache_spec(field, (1,) + tuple(node.shape))[1:]
            return self.cache_spec(field, node.shape)

        return walk(cache_tree, "")

    # -- batch inputs -----------------------------------------------------

    def tokens(self, shape) -> Spec:
        """(B, ...) tokens: batch on the data axes when it divides."""
        B = shape[0]
        return _pad((self.data if _div(B, self.data_size) else None,),
                    len(shape))

    def extra(self, extra_shapes: Dict[str, Sequence[int]]
              ) -> Dict[str, Spec]:
        """Extra inputs (image embeddings, audio frames): batch on the data
        axes when it divides."""
        return {k: self.tokens(tuple(s)) for k, s in extra_shapes.items()}

    def replicated(self, ndim: int = 0) -> Spec:
        """The spec of a replicated leaf of ``ndim`` dims."""
        return _pad((), ndim)

    # -- activations of the sharded step ----------------------------------

    def activation(self, shape, heads: Sequence[int] = (),
                   seq: bool = False, batch: bool = True) -> Spec:
        """(B, S, ...) activation: :func:`activation_spec` on this mesh."""
        return activation_spec(self.mesh, shape, heads, seq, batch)

    def experts(self, shape) -> Spec:
        """An expert stack's tensor of ``shape``, E first ((E, K, N), or a
        packed stack's data in either layout and its scales), as the
        sharded step computes with it: E on "model" where the parameter
        rule puts it there, nothing on the data axes (FSDP's shards are
        gathered for the product)."""
        on_model = _div(shape[0], self.model_size)
        return _pad((self.model if on_model else None,), len(shape))


def activation_spec(mesh, shape, heads: Sequence[int] = (),
                    seq: bool = False, batch: bool = True) -> Spec:
    """Spec of a (B, S, H, ...) activation of the sharded step: the batch
    on the data axes where it divides them (and ``batch``); on "model"
    the sequence (``seq``: sequence-parallel prefill), or else the head
    axis where every count in ``heads`` divides it (whole KV groups a
    rank: q's and k's head counts), else nothing."""
    data = data_axes(mesh)
    m = axis_size(mesh, "model")
    spec: list = [None] * len(shape)
    if batch and _div(shape[0], axis_size(mesh, data)):
        spec[0] = data
    if seq:
        spec[1] = "model"
    elif heads and m > 1 and all(_div(h, m) for h in heads):
        spec[2] = "model"
    return tuple(spec)


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim named in entry d (a tuple of names: each, in order —
    row-major, as JAX reads it), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            i = names.index(a)
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: axis {a!r} used twice")
            out[i] = Shard(d)
    return tuple(out)


def _tree_map2(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors — dicts, lists, tuples,
    PackedWeights (specs ``{"data", "scales"}``) and dataclasses (specs a
    dict by field, as ``ShardingRules.cache`` gives them); None stays
    None."""
    from repro_torch.core.packing import PackedWeight
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map2(fn, v, s) for v, s in zip(tree, specs))
    if isinstance(tree, PackedWeight):
        return dataclasses.replace(tree, data=fn(tree.data, specs["data"]),
                                   scales=fn(tree.scales, specs["scales"]))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map2(fn, getattr(tree, f.name), specs[f.name])
            for f in dataclasses.fields(tree)})
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"distribute: {type(tree).__name__} is not a tensor")
    return fn(tree, specs)


def distribute(tree, specs, mesh):
    """``tree`` of tensors as DTensors on ``mesh`` by the matching tree of
    ``specs`` (each rank keeps its shard of the full tensor it holds).
    Leaves requiring grad stay leaves requiring grad.  Takes the trees of
    :func:`_tree_map2`."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, spec):
        out = distribute_tensor(t.detach(), mesh, placements(spec, mesh))
        return out.requires_grad_(t.requires_grad)

    return _tree_map2(one, tree, specs)


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` placed by
    ``spec`` (the rules shard only dims the axes divide)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            n = axis_size(mesh, entry)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"over {entry} ({n})")
            out[d] //= n
    return tuple(out)


def abstract(tree, specs, mesh):
    """A tree of stand-ins (tensors whose values are never read: meta or
    fake) as DTensors on ``mesh`` by ``specs``, each rank's local shard a
    new empty tensor of its shard's shape on the mesh's device type — made
    under ``FakeTensorMode``, nothing is allocated (the dry-run's
    arguments)."""
    from torch.distributed.tensor import DTensor
    dev = mesh.device_type

    def one(t, spec):
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device=dev)
        return DTensor.from_local(local, mesh, placements(spec, mesh),
                                  run_check=False, shape=tuple(t.shape),
                                  stride=_contiguous_stride(t.shape))

    return _tree_map2(one, tree, specs)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    out, n = [], 1
    for s in reversed(tuple(shape)):
        out.append(n)
        n *= s
    return tuple(reversed(out))
