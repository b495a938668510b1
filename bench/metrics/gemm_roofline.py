"""gemm_roofline: the share of the packed GEMMs' roofline the GEMM
kernel reaches in the traced steps, in %.

Needed work, from the configuration's architecture module
(``bench/archs/<arch>.py``):

* every traced step, each packed weight a token passes through the
  kernel in each held layer (``layer_gemms``) times the tokens the step
  fed (rows the scheduler pads are not needed work): ``2·M·K·N``
  operations, the packed weight's values and scales read once and the
  activations in and out;
* moe: every traced step, from the program's step records
  (``repro_torch.trace``), the routed experts' work of the rows the step
  fed, in each held layer that routes (``moe_layers``: its experts E and
  top-k k): ``fed·k`` rows, each ``2·K·N`` operations a product of one
  expert (``expert_gemms``) with its activations in and out in bf16, and
  the packed weights and scales of every product of ``min(E, fed·k)``
  experts read once, at most the step's Δ``moe_experts_packed``.  Which
  experts the fed rows chose is not recorded, so that count is the most
  they can touch, a bound padding cannot raise, and the reading bounds
  the kernel's share of the needed work from above.  Rows the scheduler
  pads, and the experts only they touch, are not needed work: the count
  stays the same whatever kernel implements the experts.  None where the
  step records are missing, or where a traced step ran an expert down
  the plain path (its time is not the kernel's).

Its least time at the card's published peaks (``bench.hw``), summed over
the steps and the products, over the device time of the kernels named
``gemm_kernel`` (``repro_torch/csrc/gemm_tile.cuh``) in the trace."""
from bench import hw, session

KERNEL = "gemm_kernel"


def read(w):
    t = w.trace
    if t is None:
        return None
    dev = sum(s for n, s in t.kernel_s.items() if KERNEL in n)
    if dev <= 0:
        return None
    bits = int(w.policy[1:w.policy.index("a")])

    def wbytes(K, N):
        return hw.weight_bytes(K, N, bits, hw.weight_group(K, N))
    layers = w.arch.layer_gemms(w.model)
    least = 0.0
    for _, _, fed, _ in w.steps[t.first_step:]:
        for layer in layers:
            for _, K, N in layer:
                least += hw.least_seconds(*hw.gemm(fed, K, N, wbytes(K, N)))
    experts = w.arch.expert_gemms(w.model)
    routed = w.arch.moe_layers(w.model)
    if experts and routed:
        recs = session.steps(w)
        if recs is None or not hasattr(recs[0].start, "moe_experts_packed") \
                or session.delta(recs, "moe_experts_plain"):
            return None
        for r in recs:
            fed = r.end.fed_tokens - r.start.fed_tokens
            ran = r.end.moe_experts_packed - r.start.moe_experts_packed
            n = min(ran, sum(min(E, fed * k) for E, k in routed))
            if not n:
                continue
            rows = fed * sum(k for _, k in routed)
            for _, K, N in experts:
                least += hw.least_seconds(*hw.gemm(rows, K, N,
                                                   n * wbytes(K, N)))
    return 100.0 * least / dev
