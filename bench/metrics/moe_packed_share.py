"""moe_packed_share: of the routed experts' FFNs over the traced steps,
the share the program ran through its A16 GEMM kernel on expert stacks in
the kernel's fragment order, in %: Δ``moe_experts_packed`` /
(Δ``moe_experts_packed`` + Δ``moe_experts_plain``).  Program counters,
from the program's step records (``repro_torch.trace``); None for a
program that keeps no such counters or ran no expert."""
from bench import session


def read(w):
    recs = session.steps(w)
    if recs is None or not hasattr(recs[0].start, "moe_experts_packed"):
        return None
    packed = session.delta(recs, "moe_experts_packed")
    total = packed + session.delta(recs, "moe_experts_plain")
    if total <= 0:
        return None
    return 100.0 * packed / total
