"""A cell of ``BENCHMARK.json`` cut to a size the CPU tests can serve in
seconds: the same configuration, traffic and check at small widths, few
layers, four slots and short prompts and answers."""
from __future__ import annotations

from typing import Dict

from bench import harness

#: ``max_logit_gap``'s limit at this size, where logits are smaller: from
#: 12 seeds of each cell on the CPU (``runs.readings``), the program read
#: 0 to 0.022 and the KV4 control 0.111 to 0.273.  The chat cell's
#: ``mean_logit_gap`` limit holds as it is: the program read 0 to 0.0006
#: there, the KV4 control 0.019 to 0.035
LIMIT = 0.06

WIDTHS = dict(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=1024,
              n_layers=2)


def cell(name: str) -> Dict:
    """``harness.load_cell(name)``, cut down (module docstring)."""
    c = harness.load_cell(name)
    m = c["config"]["model"]
    m.update(WIDTHS)
    if m.get("n_experts"):
        m.update(n_experts=8, n_layers=1)
        c["config"]["drawn"] = {"residual_d_ff": WIDTHS["d_model"]}
    c["config"]["engine"].update(n_slots=4, max_seq=128, prefill_chunk=8,
                                 block_size=8)
    c["config"]["check"].update(served_tokens=120, max_logit_gap=LIMIT)
    t = c["traffic"]
    t["warmup_s"] = 0.5
    t["prompt_tokens"].update(median=24, min=9, max=60)
    t["output_tokens"].update(median=8, min=2, max=32)
    if t["loop"] == "open":
        t["rate_per_s"] = 4.0
    return c
