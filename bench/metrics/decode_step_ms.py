"""decode_step_ms: the median host time of the ``Engine.step`` calls in
the window in which every running slot decoded one token (tokens fed
equal tokens returned).  A harness span around the program's call."""
from bench.tails import quantile


def read(w):
    v = quantile([b - a for a, b, fed, out in w.steps
                  if out and fed == out], 0.5)
    return None if v is None else v * 1e3
