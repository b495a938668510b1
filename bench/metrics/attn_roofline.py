"""attn_roofline: the share of paged attention's roofline the kernel
reaches in the traced steps, in %.

Needed work, from each traced step's host ``pos`` and ``valid`` (the
program's step records, ``repro_torch.trace``) and each held layer's
geometry (the architecture module's ``attn_layers``: heads, KV heads,
head dimension, window): per held layer and slot that fed ``valid`` rows
at ``pos``, its live keys ``min(pos + valid, window)`` read once, each
``Hkv × 2 × (D·kv_bits/8 + 4)`` bytes (K and V with their f32 scales),
the fed rows' queries and outputs in bf16, and ``4·H·D`` operations for
each pair of a fed row and a key it attends.  The same whatever kernel
implements the attention: walk buckets and padding rows are not counted.
Its least time at the card's published peaks (``bench.hw``), summed over
the calls, over the device time of the kernels named ``paged_kvattn``
(``repro_torch/csrc/paged_kvattn.cu``) in the trace."""
from bench import hw, session

KERNEL = "paged_kvattn"


def layer_work(pos, valid, H, Hkv, D, kv_bits, window):
    """(operations, bytes) of one layer's attention over a step's slots."""
    ops = nbytes = 0
    for p, v in zip(pos.tolist(), valid.tolist()):
        if v <= 0:
            continue
        live = p + v if window is None else min(p + v, window)
        nbytes += live * Hkv * 2 * (D * kv_bits // 8 + 4) + 2 * v * H * D * 2
        keys = sum(p + t + 1 if window is None else min(p + t + 1, window)
                   for t in range(v))
        ops += 4 * H * D * keys
    return ops, nbytes


def read(w):
    t = w.trace
    if t is None:
        return None
    dev = sum(s for n, s in t.kernel_s.items() if KERNEL in n)
    recs = session.steps(w)
    if dev <= 0 or recs is None:
        return None
    layers = w.arch.attn_layers(w.model)
    kv_bits = int(w.policy[w.policy.index("kv") + 2:])
    least = 0.0
    for r in recs:
        if r.t_step == 0:
            continue
        for H, Hkv, D, win in layers:
            least += hw.least_seconds(*layer_work(r.pos, r.valid, H, Hkv, D,
                                                  kv_bits, win))
    return 100.0 * least / dev
