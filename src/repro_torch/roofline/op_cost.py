"""A step's FLOPs and bytes, counted from the eager aten ops it runs: the
port's counterpart of ``repro.roofline.hlo_cost``.

The JAX package derives its counts from XLA's optimized HLO text, loop trip
counts included.  The port produces no HLO, so that parser has no port;
this module applies hlo_cost's rules to the aten ops PyTorch dispatches,
under a ``TorchDispatchMode`` (:class:`OpCounter`):

* **FLOPs.**  Matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  ``mv``, ``dot``: where ``torch.matmul``, ``F.linear`` and ``einsum`` land)
  count exactly 2·|out|·|contraction| (``matmul_flops``).  Elementwise
  arithmetic (ops tagged pointwise, and a dtype conversion: hlo's
  ``convert``) counts 1 per output element, a reduction 1 per input element,
  softmax and log-softmax 5 per element and their backward 4 (their XLA
  decompositions: max, subtract, exp, sum, divide or log)
  (``other_flops``).
* **Bytes.**  Each computing op counts its operands and its output.  As
  hlo_cost charges a dynamic-slice and an in-place dynamic-update-slice,
  a gather (``index_select``, ``gather``, ``embedding``, ``index``) counts
  twice its output and a scatter (``index_copy_``, ``index_put_``,
  ``scatter_``, ``index_add_``) twice its update; ``copy_`` its source
  and its destination.  Views, reshapes, allocations and other metadata
  ops count nothing.
* **Kernels.**  The CUDA kernels launch through ctypes, out of the
  dispatcher's sight, so each kernel wrapper declares its own cost
  (``kernels.cost``) to the active counter, and the counter ignores the
  aten ops the wrapper runs meanwhile (its plain version's, or a launch's
  output allocation).  A step therefore counts the same whether its
  kernels ran or their plain versions did (:func:`rerouted`).

* **Collectives.**  A sharded step's functional collectives
  (``_c10d_functional.all_reduce``, ``all_gather_into_tensor``,
  ``reduce_scatter_tensor``, ``all_to_all_single`` and their coalesced
  and autograd forms; ``wait_tensor`` counts nothing) count no FLOPs and
  no HBM bytes but the wire bytes of the reference's ring model
  (``repro/roofline/analysis.py``) on their output, N the group's size:
  all-reduce 2·(N−1)/N, all-gather, reduce-scatter and all-to-all
  (N−1)/N, a permute (``send`` / ``recv``) 1.  A DTensor's sharding
  propagation runs each op once more on global-shape fake tensors to
  learn its output's metadata; those runs are not the rank's work and are
  not counted: from the first DTensor op a counter sees, it runs them
  with the dispatch modes off (:func:`propagation_hidden`), and a count
  with no DTensor patches nothing.

With no counter active a wrapper pays one test of :data:`COUNTER`.
Eager op boundaries are not fusion boundaries: an intermediate that XLA
would keep on chip counts here as written and read back, and an L2 hit
counts as HBM traffic.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: the counter in effect (set by :class:`OpCounter` while its block runs)
COUNTER: Optional["OpCounter"] = None

_aten = torch.ops.aten


def _packets(*names: str) -> frozenset:
    return frozenset(getattr(_aten, n) for n in names if hasattr(_aten, n))


#: matmul-class ops → index of the operand whose last axis is contracted
_MATMUL = {getattr(_aten, n): i for n, i in (
    ("mm", 0), ("bmm", 0), ("mv", 0), ("dot", 0), ("addmm", 1),
    ("baddbmm", 1), ("addbmm", 1), ("addmv", 1)) if hasattr(_aten, n)}
#: the matmuls that also add their first operand
_BIAS = _packets("addmm", "baddbmm", "addbmm", "addmv")
_GATHER = _packets("index_select", "gather", "embedding", "index", "take")
_SCATTER = _packets(
    "index_copy", "index_copy_", "index_put", "index_put_",
    "_index_put_impl_", "scatter", "scatter_", "index_add", "index_add_",
    "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "masked_scatter", "masked_scatter_")
_COPY = _packets("clone", "_to_copy", "copy_", "_copy_from",
                 "_copy_from_and_resize")
#: ops that write their output and read no tensor
_FILL = _packets("fill_", "zero_", "full", "zeros", "ones", "full_like",
                 "zeros_like", "ones_like", "new_zeros", "new_ones",
                 "new_full", "scalar_tensor", "arange", "normal_",
                 "uniform_", "random_", "randn", "rand", "randint")
#: allocations and metadata: no FLOPs, no bytes
_FREE = _packets(
    "_unsafe_view", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "detach", "alias", "lift_fresh",
    "_local_scalar_dense", "set_", "resize_", "resize_as_", "is_same_size",
    "_has_compatible_shallow_copy_type", "record_stream", "_assert_async",
    "_assert_tensor_metadata", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset")
#: functional collectives by op name → (the reference's kind, wire factor
#: before the (N−1)/N share; a permute's is 1 with no share)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", 2.0), "all_reduce_": ("all-reduce", 2.0),
    "all_reduce_coalesced": ("all-reduce", 2.0),
    "all_reduce_coalesced_": ("all-reduce", 2.0),
    "all_gather_into_tensor": ("all-gather", 1.0),
    "all_gather_into_tensor_coalesced": ("all-gather", 1.0),
    "all_gather_into_tensor_out": ("all-gather", 1.0),
    "reduce_scatter_tensor": ("reduce-scatter", 1.0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 1.0),
    "all_to_all_single": ("all-to-all", 1.0),
    "send": ("collective-permute", 1.0), "recv": ("collective-permute", 1.0),
}
#: namespaces of the functional collectives (plain and autograd forms)
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")



def _group_size(args, kwargs) -> int:
    """The size of a functional collective's group, from its group name
    (the last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in tree_leaves((args, kwargs)) if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size()


def ring_bytes(kind: str, nbytes: int, n: int) -> float:
    """Wire bytes a device sends for a ``kind`` collective whose output is
    ``nbytes`` over a group of ``n`` (the reference's ring model)."""
    if kind == "collective-permute":
        return float(nbytes)
    factor = 2.0 if kind == "all-reduce" else 1.0
    return factor * (n - 1) / n * nbytes if n > 1 else 0.0


#: FLOPs per input element of the softmax family
_SOFTMAX = {getattr(_aten, n): f for n, f in (
    ("_softmax", 5), ("_safe_softmax", 5), ("_log_softmax", 5),
    ("_softmax_backward_data", 4), ("_log_softmax_backward_data", 4))
    if hasattr(_aten, n)}


def _nbytes(ts: List[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class Cost:
    """What a counted call did: matmul and other FLOPs, bytes, per kernel
    wrapper ``[calls, declared ops, declared bytes]``, and the bytes of
    the smallest tensor a counted aten op touched (None: none counted) —
    a step whose tensors all exceed the card's L2 cannot hide traffic
    there — and, by the reference's collective kind, ``[calls, wire
    bytes]`` of the collectives a device joined."""
    matmul_flops: int = 0
    other_flops: int = 0
    bytes: int = 0
    kernels: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    smallest_tensor: Optional[int] = None
    collectives: Dict[str, List[float]] = dataclasses.field(
        default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        """A device's wire bytes over every collective."""
        return sum(b for _, b in self.collectives.values())

    @property
    def collective_counts(self) -> Dict[str, int]:
        """Collective calls by kind (the reference's ``coll_counts``)."""
        return {k: int(n) for k, (n, _) in self.collectives.items()}

    def add_collective(self, kind: str, nbytes: int, n: int) -> None:
        """One ``kind`` collective of an ``nbytes`` output over ``n``
        ranks."""
        c = self.collectives.setdefault(kind, [0, 0.0])
        c[0] += 1
        c[1] += ring_bytes(kind, nbytes, n)

    @property
    def flops(self) -> int:
        """Every counted FLOP."""
        return self.matmul_flops + self.other_flops

    def add_kernel(self, name: str, ops: int, nbytes: int) -> None:
        """A kernel wrapper's declared cost: its operations are
        matmul-class (tensor-core dots, the GEMMs' and attention's)."""
        self.matmul_flops += int(ops)
        self.bytes += int(nbytes)
        k = self.kernels.setdefault(name, [0, 0, 0])
        k[0] += 1
        k[1] += int(ops)
        k[2] += int(nbytes)


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched while its ``with`` block runs (on
    any device, backward passes included), and the costs the kernel
    wrappers declare (:meth:`kernel`).  One counter at a time."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        #: > 0 while a kernel wrapper runs: its aten ops are not counted
        self.paused = 0

    def __enter__(self):
        global COUNTER
        if COUNTER is not None:
            raise RuntimeError("an OpCounter is already counting")
        COUNTER = self
        #: the open :func:`propagation_hidden` block, from the first DTensor
        #: op on (None: no DTensor op seen)
        self._hidden = None
        try:
            return super().__enter__()
        except BaseException:
            COUNTER = None
            raise

    def __exit__(self, *exc):
        global COUNTER
        COUNTER = None
        if self._hidden is not None:
            self._hidden.__exit__(None, None, None)
            self._hidden = None
        return super().__exit__(*exc)

    def kernel(self, name: str, cost: Callable[..., Tuple[int, int]],
               fn: Callable, *args, **kwargs):
        """Run kernel wrapper ``fn`` with aten counting paused and add its
        declared ``cost(*args, **kwargs)`` = (ops, bytes) instead."""
        self.paused += 1
        try:
            ops, nbytes = cost(*args, **kwargs)
            out = fn(*args, **kwargs)
        finally:
            self.paused -= 1
        self.cost.add_kernel(name, ops, nbytes)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and t.__name__ == "DTensor"
               for t in types):
            # a DTensor op: its local ops (a rank's work, collectives
            # included) come back through this mode; the global op is not
            # counted, nor its sharding propagation, hidden from here on
            # (a count with no DTensor patches nothing)
            if self._hidden is None:
                self._hidden = propagation_hidden()
                self._hidden.__enter__()
            return NotImplemented
        out = func(*args, **kwargs)
        if not self.paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        pkt = func.overloadpacket
        if func.is_view or pkt in _FREE or func.namespace == "prim":
            return                 # prim: metadata queries (``prim.device``)
        if func.namespace in _COLLECTIVE_NS:
            if pkt.__name__ in _COLLECTIVES:
                kind, _ = _COLLECTIVES[pkt.__name__]
                outs = [t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
                self.cost.add_collective(kind, _nbytes(outs),
                                         _group_size(args, kwargs))
            return
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        n_out = sum(t.numel() for t in outs)
        c = self.cost
        sizes = [t.numel() * t.element_size() for t in ins + outs]
        if sizes and (c.smallest_tensor is None or
                      min(sizes) < c.smallest_tensor):
            c.smallest_tensor = min(sizes)
        if pkt in _GATHER:
            c.bytes += 2 * _nbytes(outs)
            return
        if pkt in _SCATTER:
            c.bytes += 2 * ins[-1].numel() * ins[0].element_size()
            return
        if pkt in _FILL:
            c.bytes += _nbytes(outs)
            return
        if pkt in _COPY:
            src = ins[1] if pkt is _aten.copy_ else ins[0]
            c.bytes += _nbytes([src]) + _nbytes(outs)
            if outs and src.dtype != outs[0].dtype:
                c.other_flops += n_out          # hlo's convert
            return
        c.bytes += _nbytes(ins) + _nbytes(outs)
        if pkt in _MATMUL:
            c.matmul_flops += 2 * n_out * ins[_MATMUL[pkt]].shape[-1]
            if pkt in _BIAS:
                c.other_flops += n_out
        elif pkt in _SOFTMAX:
            c.other_flops += _SOFTMAX[pkt] * ins[0].numel()
        elif torch.Tag.reduction in func.tags:
            c.other_flops += ins[0].numel()
        elif torch.Tag.pointwise in func.tags:
            c.other_flops += n_out


_HIDDEN = [0]


@contextlib.contextmanager
def propagation_hidden() -> Iterator[None]:
    """For the block, DTensor's sharding propagation — the choice of an
    op's strategy (``propagate_op_sharding``) and the global-shape fake run
    that gives its output metadata (``_propagate_tensor_meta_non_cached``)
    — and a strided shard's size arithmetic run with every dispatch mode
    off, so neither a counter nor a memory tracker takes them for the
    rank's work, and a fake-tensor mode does not capture the small host
    tensors they compute with; the strategy is cached by the op's schema,
    as DTensor does outside fake-tensor modes.  Nested blocks share
    one patch; nothing is patched where ``torch.distributed.tensor`` was
    never loaded (no DTensor can run then)."""
    import sys
    if "torch.distributed.tensor._sharding_prop" not in sys.modules:
        yield
        return
    if _HIDDEN[0] == 0:
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.utils._python_dispatch import _disable_current_modes

        def hidden(fn):
            def run(*a, **k):
                with _disable_current_modes():
                    return fn(*a, **k)
            return run

        prop = DTensor._op_dispatcher.sharding_propagator
        _SAVED[:] = [ShardingPropagator._propagate_tensor_meta_non_cached,
                     prop.propagate_op_sharding]
        strided = _strided_shard()
        if strided is not None:
            _SAVED.append(strided.local_shard_size_and_offset)
            strided.local_shard_size_and_offset = hidden(_SAVED[2])
        ShardingPropagator._propagate_tensor_meta_non_cached = hidden(
            _SAVED[0])
        # both entries take the cache: DTensor skips it under a fake-tensor
        # mode (symbolic shapes when tracing); the shapes here are concrete
        prop.propagate_op_sharding = hidden(_SAVED[1])
        prop.propagate_op_sharding_non_cached = hidden(_SAVED[1])
    _HIDDEN[0] += 1
    try:
        yield
    finally:
        _HIDDEN[0] -= 1
        if _HIDDEN[0] == 0:
            from torch.distributed.tensor import DTensor
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator
            prop = DTensor._op_dispatcher.sharding_propagator
            ShardingPropagator._propagate_tensor_meta_non_cached = _SAVED[0]
            prop.propagate_op_sharding = _SAVED[1]
            del prop.propagate_op_sharding_non_cached
            if len(_SAVED) > 2:
                _strided_shard().local_shard_size_and_offset = _SAVED[2]


_SAVED: List[Callable] = []


def _strided_shard():
    """DTensor's strided-shard placement where its shard sizes are
    computed with index tensors (bookkeeping a fake-tensor mode must not
    capture), else None."""
    from torch.distributed.tensor import placement_types as P
    cls = getattr(P, "_StridedShard", None)
    return cls if cls is not None and \
        "local_shard_size_and_offset" in vars(cls) else None


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """The block's aten ops are not the step's (a measuring harness's
    own): the active counter, if any, skips them."""
    counter = COUNTER
    if counter is not None:
        counter.paused += 1
    try:
        yield
    finally:
        if counter is not None:
            counter.paused -= 1


def count(fn: Callable, *args, **kwargs) -> Tuple[Any, Cost]:
    """Run ``fn(*args, **kwargs)`` under a new :class:`OpCounter`; return
    its result and what it cost."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.cost


#: the kernel wrappers' call sites: (module, name) pairs by wrapper
_CALL_SITES = {
    "mpgemm_a16": (("ops", "mpgemm_a16"),),
    "mpgemm_int8": (("ops", "mpgemm_int8"),),
    "kvattn": (("ops", "kvattn"),),
    "paged_kvattn": (("ops", "paged_kvattn"),),
    "flash_prefill": (("ops", "flash_prefill"),
                      ("flashprefill", "flash_prefill")),
    "flash_prefill_bwd": (("flashprefill", "flash_prefill_bwd"),),
}


@contextlib.contextmanager
def rerouted(impls: Dict[str, Callable],
             costs: Optional[Dict[str, Callable]] = None) -> Iterator[None]:
    """For the block, every call of kernel wrapper ``name`` (at its call
    sites in ``kernels.ops`` and ``kernels.flashprefill``) runs
    ``impls[name]`` instead, taking the wrapper's arguments and declaring
    the wrapper's cost (``kernels.cost.OF``, or ``costs[name]`` where
    given) to an active counter — a step's count on another route, e.g.
    ``kernels.ref.PLAIN`` on the card.  Without a counter the
    implementations just run."""
    from repro_torch.kernels import cost as KC
    from repro_torch.kernels import flashprefill, ops
    mods = {"ops": ops, "flashprefill": flashprefill}
    of = dict(KC.OF, **(costs or {}))

    def declared(name, impl):
        def run(*args, **kwargs):
            if COUNTER is not None and not COUNTER.paused:
                return COUNTER.kernel(name, of[name], impl, *args,
                                      **kwargs)
            return impl(*args, **kwargs)
        return run

    saved = []
    try:
        for name, impl in impls.items():
            for mod, attr in _CALL_SITES[name]:
                saved.append((mods[mod], attr, getattr(mods[mod], attr)))
                setattr(mods[mod], attr, declared(name, impl))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
