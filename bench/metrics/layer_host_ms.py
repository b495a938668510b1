"""layer_host_ms: the median host duration of the program's
``model.layer`` spans in the traced steps, in ms: one held layer's Python
and launches, and any wait for the device inside it (none in the dense
family: its syncs lie outside the layers).  Every step width counts: at
the chat cell's load a traced slice can hold no one-token-wide step.
Program spans (``repro_torch.trace``)."""
from bench import session
from bench.tails import quantile


def read(w):
    recs = session.steps(w)
    if recs is None:
        return None
    v = quantile([s.end - s.start for r in recs for s in r.spans
                  if s.name == "model.layer"], 0.5)
    return None if v is None else v * 1e3
