"""queue_wait_ms: the median wait of the requests first admitted in the
traced steps, from their submission to their admission (the engine's
``admit_time - arrival_time``), in ms.  Their count goes to standard
error.  The program's step records (``repro_torch.trace``)."""
import sys

from bench import session
from bench.tails import quantile


def read(w):
    recs = session.steps(w)
    if recs is None:
        return None
    waits = [wait for r in recs for _, wait in r.waits]
    print(f"queue_wait_ms: {len(waits)} requests admitted in the traced "
          "steps", file=sys.stderr)
    v = quantile(waits, 0.5)
    return None if v is None else v * 1e3
