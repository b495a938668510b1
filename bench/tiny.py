"""A cell of ``BENCHMARK.json`` cut to a size the CPU tests can serve in
seconds: the same configuration, traffic and check at small widths, few
layers, four slots and short prompts and answers.  The cut of the model
is its architecture module's (``tiny``); the engine, check and traffic
cut is this file's."""
from __future__ import annotations

from pathlib import Path
from typing import Dict

from bench import harness

#: ``max_logit_gap``'s limit at this size, where logits are smaller: from
#: 12 seeds of each cell on the CPU (``runs.readings``), the program read
#: 0 to 0.022 and the KV4 control 0.111 to 0.273.  The chat cell's
#: ``mean_logit_gap`` limit holds as it is: the program read 0 to 0.0006
#: there, the KV4 control 0.019 to 0.035
LIMIT = 0.06


def cell(name: str, root: Path = harness.ROOT) -> Dict:
    """``harness.load_cell(name, root)``, cut down (module docstring)."""
    c = harness.load_cell(name, root)
    c["config"]["engine"].update(n_slots=4, max_seq=128, prefill_chunk=8,
                                 block_size=8)
    c["config"]["check"].update(served_tokens=120, max_logit_gap=LIMIT)
    c["arch"].tiny(c["config"])
    t = c["traffic"]
    t["warmup_s"] = 0.5
    t["prompt_tokens"].update(median=24, min=9, max=60)
    t["output_tokens"].update(median=8, min=2, max=32)
    if t["loop"] == "open":
        t["rate_per_s"] = 4.0
    return c
