"""The program's own record of a traced run: the session of
``repro_torch.trace``, one record per ``Engine.step`` the profiler saw.

The harness profiles the window's last ``bench.trace.SLICE_S`` seconds,
and the program opens a new session when the profiler turns on, so the
session's steps are the window's steps from ``Trace.first_step`` on.
"""
from __future__ import annotations

import sys


def steps(w):
    """The session's step records of the window's traced steps, or None
    for an untraced run, a program without ``repro_torch.trace``, or a
    session that does not hold exactly the traced steps."""
    if w.trace is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    recs = trace.session()
    n = len(w.steps) - w.trace.first_step
    if not recs or len(recs) != n:
        print(f"bench: the program's session holds {len(recs)} steps, the "
              f"traced slice {n}", file=sys.stderr)
        return None
    return recs


def delta(recs, counter: str) -> int:
    """A counter's increase over the steps ``recs``."""
    return sum(getattr(r.end, counter) - getattr(r.start, counter)
               for r in recs)
