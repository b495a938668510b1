"""host_syncs_per_step: the program's ``host_syncs`` over the traced
steps, per step: calls of the serve path that waited for the device
(input copies, block-table rows, the KV write filter, the token fetch,
and moe's reads of its kept assignments and each touched expert's rows).
Program counter, from the program's step records
(``repro_torch.trace``)."""
from bench import session


def read(w):
    recs = session.steps(w)
    if recs is None:
        return None
    return session.delta(recs, "host_syncs") / len(recs)
