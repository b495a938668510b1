"""The device trace of a run with ``--trace 1``: ``torch.profiler`` over
the last ``SLICE_S`` seconds of the window, read from its Chrome trace.

The profiler is started once during set-up around one step, so that
its own start-up is not paid inside the window.  What is read:

* busy seconds: the union of every kernel, copy and memset interval on
  the device (kernels that overlap are counted once), inside the
  ``window.slice`` span that marks the traced part of the window;
* each kernel name's device seconds;
* the device seconds of the kernels launched inside each harness span
  (a launch's runtime call is matched to its kernel by correlation id);
* the idle gaps between busy intervals, each filed under what the host's
  main thread was doing at the gap's middle (the innermost harness span
  and, inside it, the innermost operator).
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

#: seconds at the end of the window that a ``--trace 1`` run traces
SLICE_S = 6.0
SLICE_SPAN = "window.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    """What the traced slice of the window shows (seconds)."""
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    span_device_s: Dict[str, float]
    span_count: Dict[str, int]
    idle_by_host: Dict[str, float]
    first_step: int = 0          # index of the window's first traced step

    def top(self, d: Dict[str, float], n: int = 10) -> List[list]:
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> Dict[str, List[list]]:
        return {"device_ops": self.top(self.kernel_s),
                "idle_gaps": self.top(self.idle_by_host)}


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _innermost(events: List[Tuple[float, float, str]],
               points: List[float]) -> List[Optional[Tuple[str, ...]]]:
    """For each of the sorted ``points``, the names of the properly nested
    ``events`` (start, end, name) that hold it, outermost first."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(e[2] for e in stack) or None)
    return out


def read(trace_events: List[Dict], spans: Tuple[str, ...]) -> Trace:
    """A ``Trace`` from Chrome trace events (``traceEvents``)."""
    dev, launch, ann, ops = [], {}, [], []
    for ev in trace_events:
        if ev.get("ph") != "X":
            continue
        cat, ts = ev.get("cat"), float(ev["ts"])
        end = ts + float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            dev.append((ts, end, ev["name"], args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = ts
        elif cat == "user_annotation":
            ann.append((ts, end, ev["name"], ev.get("tid")))
        elif cat == "cpu_op":
            ops.append((ts, end, ev["name"], ev.get("tid")))
    sl = [a for a in ann if a[2] == SLICE_SPAN]
    if not sl:
        raise RuntimeError(f"the trace has no {SLICE_SPAN!r} span")
    s0, s1 = sl[0][0], sl[0][1]
    main = sl[0][3]
    dev = [(max(a, s0), min(b, s1), n, c) for a, b, n, c in dev
           if b > s0 and a < s1]
    busy = union([(a, b) for a, b, _, _ in dev])
    kernel_s: Dict[str, float] = defaultdict(float)
    for a, b, n, _ in dev:
        kernel_s[n] += (b - a) / 1e6
    span_iv = {n: sorted((a, b) for a, b, m, _ in ann if m == n)
               for n in spans}
    span_dev: Dict[str, float] = {n: 0.0 for n in spans}
    for a, b, _, c in dev:
        t = launch.get(c)
        if t is None:
            continue
        for n, iv in span_iv.items():
            j = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if j >= 0 and iv[j][0] <= t <= iv[j][1]:
                span_dev[n] += (b - a) / 1e6
    gaps, mids, edge = [], [], s0
    for a, b in busy + [(s1, s1)]:
        if a > edge:
            gaps.append(a - edge)
            mids.append((a + edge) / 2)
        edge = max(edge, b)
    host = [(a, b, n) for a, b, n, tid in ann + ops
            if tid == main and n != SLICE_SPAN]
    idle: Dict[str, float] = defaultdict(float)
    for g, names in zip(gaps, _innermost(host, mids)):
        if names is None:
            key = "outside any span"
        else:
            key = names[0] if len(names) == 1 else f"{names[0]}/{names[-1]}"
        idle[key] += g / 1e6
    return Trace(window_s=(s1 - s0) / 1e6,
                 busy_s=sum(b - a for a, b in busy) / 1e6,
                 kernel_s=dict(kernel_s), span_device_s=span_dev,
                 span_count={n: len(iv) for n, iv in span_iv.items()},
                 idle_by_host=dict(idle))


class Tracer:
    """``torch.profiler`` over the end of the window (module docstring)."""

    def __init__(self, spans: Tuple[str, ...]):
        self.spans, self.prof, self.first_step = spans, None, 0
        self._slice = None

    def _new(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self, fn) -> None:
        """Start and stop the profiler once around ``fn()`` (set-up)."""
        with self._new():
            fn()

    def start(self, step_index: int) -> None:
        import torch
        self.first_step = step_index
        self.prof = self._new()
        self.prof.start()
        self._slice = torch.profiler.record_function(SLICE_SPAN)
        self._slice.__enter__()

    @property
    def on(self) -> bool:
        return self.prof is not None

    def stop(self) -> Trace:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._slice.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        t = read(events, self.spans)
        t.first_step = self.first_step
        return t
