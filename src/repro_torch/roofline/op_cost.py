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

With no counter active a wrapper pays one test of :data:`COUNTER`.
Collectives are not counted: one card (multi-device launch is not ported).
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
    there."""
    matmul_flops: int = 0
    other_flops: int = 0
    bytes: int = 0
    kernels: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    smallest_tensor: Optional[int] = None

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
        try:
            return super().__enter__()
        except BaseException:
            COUNTER = None
            raise

    def __exit__(self, *exc):
        global COUNTER
        COUNTER = None
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
        out = func(*args, **kwargs)
        if not self.paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        pkt = func.overloadpacket
        if func.is_view or pkt in _FREE:
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
def rerouted(impls: Dict[str, Callable]) -> Iterator[None]:
    """For the block, every call of kernel wrapper ``name`` (at its call
    sites in ``kernels.ops`` and ``kernels.flashprefill``) runs
    ``impls[name]`` instead, taking the wrapper's arguments and declaring
    the wrapper's cost (``kernels.cost.OF``) to an active counter — a
    step's count on another route, e.g. ``kernels.ref.PLAIN`` on the
    card.  Without a counter the implementations just run."""
    from repro_torch.kernels import cost as KC
    from repro_torch.kernels import flashprefill, ops
    mods = {"ops": ops, "flashprefill": flashprefill}

    def declared(name, impl):
        def run(*args, **kwargs):
            if COUNTER is not None and not COUNTER.paused:
                return COUNTER.kernel(name, KC.OF[name], impl, *args,
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
