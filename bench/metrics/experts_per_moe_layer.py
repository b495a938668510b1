"""experts_per_moe_layer: iterations of the per-expert host loop a routed
moe layer runs, over the traced steps: Δ(``moe_experts_packed`` +
``moe_experts_plain``) / Δ``moe_layers_run``, of the layer's E experts.
Program counters, from the program's step records (``repro_torch.trace``);
None for a program that keeps no ``moe_layers_run`` or ran no routed
layer."""
from bench import session


def read(w):
    recs = session.steps(w)
    if recs is None or not hasattr(recs[0].start, "moe_layers_run"):
        return None
    layers = session.delta(recs, "moe_layers_run")
    if layers <= 0:
        return None
    experts = session.delta(recs, "moe_experts_packed") + \
        session.delta(recs, "moe_experts_plain")
    return experts / layers
