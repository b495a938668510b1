"""fed_row_share: the engine's ``fed_tokens`` over its ``computed_rows``
across the traced steps, in %: of the rows the model steps computed
(``n_slots × t_step`` a step), the share that fed a stream token; the
rest are padding and idle slots.  Program counters, from the program's
step records (``repro_torch.trace``)."""
from bench import session


def read(w):
    recs = session.steps(w)
    if recs is None:
        return None
    rows = session.delta(recs, "computed_rows")
    if rows <= 0:
        return None
    return 100.0 * session.delta(recs, "fed_tokens") / rows
