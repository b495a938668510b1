"""Tail arithmetic of the end-to-end metrics, frozen here.

``quantile`` is linear interpolation between order statistics (numpy's
default "linear" method, written out so that the benchmark's arithmetic
does not move with a library).  ``ttfts`` censors a request that has no
first token when the window closes at its wait so far, so a stall that
holds requests past the end still moves the tail.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence


def quantile(values: Iterable[float], q: float) -> Optional[float]:
    """The ``q`` quantile (0 ≤ q ≤ 1) of ``values``; None when empty."""
    x = sorted(values)
    if not x:
        return None
    h = (len(x) - 1) * q
    lo = math.floor(h)
    hi = min(lo + 1, len(x) - 1)
    return x[lo] + (h - lo) * (x[hi] - x[lo])


def ttfts(due: Dict[int, float], first: Dict[int, float], start: float,
          end: float) -> List[float]:
    """Time to first token of every request due in ``[start, end)``: from
    its due time to the return of the step that carried its first token,
    or to ``end`` when none came by then (censored)."""
    out = []
    for rid, t_due in due.items():
        if start <= t_due < end:
            t1 = first.get(rid)
            out.append((t1 if t1 is not None and t1 <= end else end) - t_due)
    return out


def gaps(returns: Dict[int, Sequence[float]], start: float, end: float
         ) -> List[float]:
    """Every inter-token gap of every request whose later token's step
    returned within ``[start, end]``: the time between the returns of the
    steps that carried two successive tokens of one request."""
    out = []
    for ts in returns.values():
        out.extend(b - a for a, b in zip(ts, ts[1:]) if start <= b <= end)
    return out

