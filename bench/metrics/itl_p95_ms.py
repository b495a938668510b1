"""itl_p95_ms: the 95th percentile over every inter-token gap that ended
in the window (between the returns of the steps that carried a request's
successive tokens).  Host clock."""
from bench.tails import gaps, quantile


def read(w):
    v = quantile(gaps(w.returns, 0.0, w.seconds), 0.95)
    return None if v is None else v * 1e3
