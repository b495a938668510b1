"""ttft_p95_ms: the 95th percentile of time to first token over every
request due in the window, from its due time to the return of the step
that carried its first token; a request with none by the window's end
counts its wait so far.  Host clock."""
from bench.tails import quantile, ttfts


def read(w):
    v = quantile(ttfts(w.due, w.first, 0.0, w.seconds), 0.95)
    return None if v is None else v * 1e3
