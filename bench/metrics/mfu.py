"""mfu: model FLOPs of the window over the window's seconds at the card's
bf16 peak, in %.  Model FLOPs: 2 × the matmul parameters a token passes
(the architecture module's ``matmul_params``: the held layers) × tokens
fed, plus 2 × d_model × vocab × tokens returned (the head runs once per
token served).
Attention's own score and value products are left out.  Program counters
and the host clock."""
from bench import hw


def read(w):
    m = w.model
    if w.seconds <= 0:
        return None
    flops = 2 * w.arch.matmul_params(m) * w.fed_tokens + \
        2 * m["d_model"] * m["vocab"] * w.emitted
    return 100.0 * flops / (w.seconds * hw.PEAK_BF16_FLOPS)
