"""Spans and counters of the serving path, on the clock of the device trace.

Nothing is recorded unless a ``torch.profiler`` session records.  At the
top of every ``Engine.step`` the engine calls :func:`begin_step`, which
reads the profiler's state once (``_profiler_enabled``, well under a µs),
and at its end :func:`end_step`.  While it is off, :func:`span` returns
one shared no-op context and nothing is kept anywhere.  While it is on,
``engine.step`` spans the two calls, and each span goes onto the
profiler's own timeline, the clock of its CUDA activity, as a ``cpu_op``
event named after the span (``_RecordFunctionFast``), and is also kept in
memory as a :class:`Span` on ``time.perf_counter`` in the :class:`Step`
record of the step that holds it.

A turn from off to on opens a new session: the records of the last one
are dropped, so after a profiled slice of a run :func:`session` holds the
slice's steps and nothing before them.  The record lives here, at module
level, so it outlives the engine that wrote it; it keeps the newest
``MAX_STEPS`` steps.

Spans, nested as the calls are (``model.layer`` once per held layer, the
``moe.*`` spans in the moe family's layers)::

    engine.step
      engine.admit     admission, the slots' block tables
      engine.plan      the step's width, growth, the per-slot host arrays
      engine.inputs    the host → device copies of the step's inputs
      model.forward    the model's decode_step
        model.layer
          moe.ffn
            moe.route      router and top-k
            moe.dispatch   capacity keep, the touched experts read back
            moe.experts    each touched expert's rows read back, its FFN
          moe.shared     the shared expert or dense residual beside it
        model.head     final norm and logits
      engine.sample
      engine.fetch     the sampled tokens read back
      engine.retire

Counters, always on (plain integer adds): ``host_syncs`` here, counted by
:func:`sync` at every call of the chunked serve path that waits for the
device when it is a card (a blocking host → device copy, a read back, an
op whose output size the host must know); ``moe_experts_packed``,
``moe_experts_plain`` and ``moe_expert_rows`` here, counted by
:func:`expert_ffn` at every routed expert's FFN; ``moe_layers_run`` here,
counted by :func:`moe_layer` at every call of the routed moe FFN (one a
routing layer and step); ``Engine.fed_tokens``,
``Engine.computed_rows`` and ``Request.admit_time`` on the engine.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Deque, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

#: steps a session keeps (the newest)
MAX_STEPS = 20_000

#: calls of the serve path that waited for the device, since import
host_syncs = 0
#: routed experts' FFNs run through the A16 GEMM kernel on their stacks'
#: fragment order, and through the plain path (dequantized members), since
#: import
moe_experts_packed = 0
moe_experts_plain = 0
#: rows those FFNs computed (each expert's kept assignments), since import
moe_expert_rows = 0
#: calls of the routed moe FFN (one a routing layer and step), since import
moe_layers_run = 0


class Counters(NamedTuple):
    """The counters a step record snapshots."""
    fed_tokens: int
    computed_rows: int
    host_syncs: int
    moe_experts_packed: int = 0
    moe_experts_plain: int = 0
    moe_expert_rows: int = 0
    moe_layers_run: int = 0


class Span(NamedTuple):
    """One span: ``perf_counter`` seconds; ``parent`` is the index of the
    enclosing span in its step's ``spans`` (-1 for ``engine.step``)."""
    name: str
    start: float
    end: float
    parent: int
    step: int


@dataclasses.dataclass
class Step:
    """One ``Engine.step`` of a session.  ``t_step`` is 0, and ``pos`` and
    ``valid`` are None, when the step ran no model step; ``waits`` holds
    ``(rid, admit_time - arrival_time)`` of each request first admitted
    in it."""
    index: int
    start: Counters
    end: Optional[Counters] = None
    t_step: int = 0
    pos: Optional[np.ndarray] = None
    valid: Optional[np.ndarray] = None
    waits: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    spans: List[Span] = dataclasses.field(default_factory=list)


_NULL = contextlib.nullcontext()
_session: Deque[Step] = deque(maxlen=MAX_STEPS)
#: whether the profiler recorded at the last step's start
_on = False
#: the open step's record while the profiler records, else None
_step: Optional[Step] = None
#: indices of the open spans in ``_step.spans``, outermost first
_open: List[int] = []
#: the open step's ``engine.step`` record function and its start
_top = None


def _counters(eng) -> Counters:
    return Counters(eng.fed_tokens, eng.computed_rows, host_syncs,
                    moe_experts_packed, moe_experts_plain, moe_expert_rows,
                    moe_layers_run)


def begin_step(eng) -> None:
    """Open ``eng``'s step: read the profiler's state and, while it
    records, enter the ``engine.step`` span (first, so that the step's
    own bookkeeping lies inside it) and start the step's record (a new
    session on a turn from off to on)."""
    global _on, _step, _top
    on = torch._C._autograd._profiler_enabled()
    if on:
        rf = torch._C._profiler._RecordFunctionFast("engine.step")
        rf.__enter__()
        _top = (rf, time.perf_counter())
        if not _on:
            _session.clear()
        _step = Step(len(_session), _counters(eng), spans=[None])
        _open[:] = [0]
    _on = on


def end_step(eng) -> None:
    """Close the step :func:`begin_step` opened, keep its record and
    leave the ``engine.step`` span last."""
    global _step
    if _step is not None:
        rf, start = _top
        _step.spans[0] = Span("engine.step", start, time.perf_counter(), -1,
                              _step.index)
        _step.end = _counters(eng)
        _session.append(_step)
        _step = None
        rf.__exit__(None, None, None)


class _Span:
    __slots__ = ("name", "rf", "index", "parent", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.parent = _open[-1]
        self.index = len(_step.spans)
        _step.spans.append(None)
        _open.append(self.index)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _open.pop()
        _step.spans[self.index] = Span(self.name, self.start, end,
                                       self.parent, _step.index)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records span ``name`` while a step records, else
    one shared no-op context."""
    return _NULL if _step is None else _Span(name)


def sync(n: int = 1) -> None:
    """Count ``n`` calls that waited for the device."""
    global host_syncs
    host_syncs += n


def expert_ffn(packed: bool, rows: int) -> None:
    """Count one routed expert's FFN over ``rows`` rows, run through the
    A16 GEMM kernel (``packed``) or the plain path."""
    global moe_experts_packed, moe_experts_plain, moe_expert_rows
    if packed:
        moe_experts_packed += 1
    else:
        moe_experts_plain += 1
    moe_expert_rows += rows


def moe_layer() -> None:
    """Count one call of the routed moe FFN."""
    global moe_layers_run
    moe_layers_run += 1


def note_plan(t_step: int, pos: np.ndarray, valid: np.ndarray) -> None:
    """Keep the open step's width and copies of its host ``pos`` and
    ``valid`` arrays (while a step records)."""
    if _step is not None:
        _step.t_step = t_step
        _step.pos, _step.valid = pos.copy(), valid.copy()


def admitted(rid: int, wait: float) -> None:
    """Keep a request's wait before its first admission (while a step
    records)."""
    if _step is not None:
        _step.waits.append((rid, wait))


def session() -> List[Step]:
    """The steps of the newest profiling session, oldest first (the open
    step excluded)."""
    return list(_session)
