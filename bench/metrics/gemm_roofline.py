"""gemm_roofline: the share of the packed GEMMs' roofline the GEMM
kernel reaches in the traced steps, in %.

Needed work: every step, each packed weight a token passes through the
kernel (``bench.hw.packed_gemms``, every held layer) times the tokens the
step fed (rows the scheduler pads are not needed work): 2·M·K·N
operations, the packed weight's values and scales read once and the
activations in and out.  Its least time at the card's published peaks,
summed over the traced steps, over the device time of the kernels named
``gemm_kernel`` (``repro_torch/csrc/gemm_tile.cuh``) in the trace."""
from bench import hw

KERNEL = "gemm_kernel"


def read(w):
    t = w.trace
    if t is None:
        return None
    dev = sum(s for n, s in t.kernel_s.items() if KERNEL in n)
    if dev <= 0:
        return None
    bits = int(w.policy[1:w.policy.index("a")])
    least = 0.0
    for _, _, fed, _ in w.steps[t.first_step:]:
        for _, K, N in hw.packed_gemms(w.model):
            wb = hw.weight_bytes(K, N, bits, hw.weight_group(K, N))
            least += hw.least_seconds(*hw.gemm(fed, K, N, wb))
    return 100.0 * least * w.model["n_layers"] / dev
