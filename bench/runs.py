"""Drives for the CPU tests of whole runs: a cut-down cell (``bench.tiny``)
served on the CPU with the program's path broken underneath, and the
control's reading beside the program's."""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Tuple

import torch

from bench import check, harness, tiny

SECONDS = 2.0


def _bad_token():
    import repro_torch.serving.sampler as S
    orig = S.sample

    def sample(logits, *a):
        out = orig(logits, *a)
        out[0] = (out[0] + 1) % logits.shape[-1]     # slot 0's token altered
        return out
    return S, "sample", sample


def _kv_unwritten():
    import repro_torch.core.paged_kvcache as PKV
    return PKV, "scatter_rows", lambda *a, **k: None   # the pool unchanged


def _routing_reversed():
    import repro_torch.models.moe as M
    orig = M.top_k

    def top_k(probs, k):                               # the least likely
        vals, idx = orig(-probs, k)
        return probs.gather(-1, idx), idx
    return M, "top_k", top_k


#: faults planted where the program produces its answer or keeps its state
FAULTS = {"token_altered": _bad_token, "kv_unwritten": _kv_unwritten,
          "routing_reversed": _routing_reversed}


@contextlib.contextmanager
def planted(fault: str):
    mod, attr, fn = FAULTS[fault]()
    orig = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def run(cell: str, seed: int, fault: str = "") -> Tuple[Dict, list]:
    """A whole run of the cut-down cell on the CPU, the chip's look
    skipped, with ``fault`` planted (or none)."""
    torch.set_num_threads(1)
    with planted(fault) if fault else contextlib.nullcontext():
        return harness.run(tiny.cell(cell), seed, SECONDS, False, "cpu",
                           time.perf_counter())


def readings(cell: str, seed: int) -> Dict[str, Dict]:
    """The numbers ``correct`` compares for the program's served tokens
    and, in its place, for the KV4 and A8 controls, over the same sample
    at the cut-down size, each as (value, limit)."""
    torch.set_num_threads(1)
    c = tiny.cell(cell)
    cfg = c["config"]
    _, out, _ = harness.serve(c, seed, SECONDS, False, "cpu",
                              time.perf_counter())
    params = c["arch"].draw(harness.shapes(cfg), seed, "cpu")
    program, _ = check.compare(c, params, out.finished, seed)
    rids = check.sample(out.finished, seed, cfg["check"]["served_tokens"])
    judge = check.Judge(c, params, out.finished, rids)
    return {"program": program,
            "kv4": check.control(c, params, out.finished, seed, judge,
                                 kv_bits=4)[0],
            "a8": check.control(c, params, out.finished, seed, judge,
                                act_bits=8)[0]}
