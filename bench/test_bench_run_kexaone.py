"""Whole runs of ``kexaone236b.batch`` cut down to the CPU (``bench.tiny``,
the architecture's cut: 1 dense + 4 routed layers of 16 experts, top-4,
window 8), in 6 s windows, so that a run's sample holds ~100 served
tokens and its ``mean_logit_gap`` settles: ``correct`` holds on a sound
program, and comes out false with each fault planted in the timed path
(a served token altered, one routed choice dropped, RoPE applied on the
global layer, the post-FFN norm skipped, the bias used in the gates); and
the control (the reference with a KV4 cache in its place) comes out
false."""
import contextlib
import time

import pytest
import torch

from bench import check, harness, runs, tiny
from bench.test_bench_kexaone import EQUATION_FAULTS

CELL = "kexaone236b.batch"
SECONDS = 6.0


def _choice_dropped():
    import repro_torch.models.moe as M
    orig = M.dispatch_einsum

    def dispatch(gate_idx, E, cap):
        keep = orig(gate_idx, E, cap)
        keep[..., -1] = False                 # every token's last choice
        return keep
    return M, "dispatch_einsum", dispatch


FAULTS = {"token_altered": runs.FAULTS["token_altered"],
          "choice_dropped": _choice_dropped,
          **{k: EQUATION_FAULTS[k] for k in ("rope_on_global",
                                             "post_norm_skipped",
                                             "bias_in_gates")}}


def run(seed, fault=""):
    torch.set_num_threads(1)
    with contextlib.ExitStack() as stack:
        if fault:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(*FAULTS[fault]())
        return harness.run(tiny.cell(CELL), seed, SECONDS, False, "cpu",
                           time.perf_counter())


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 20])
def test_sound_run_is_correct(seed):
    res, lines = run(seed)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"short_answers", "max_logit_gap",
                                  "mean_logit_gap"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_correct_false(fault):
    res, lines = run(11, fault)
    assert not res["correct"], lines


def test_control_reads_far_above_the_program():
    """The reference with a KV4 cache in the program's place, judged as a
    run judges the program, at the cut's own limits."""
    torch.set_num_threads(1)
    c = tiny.cell(CELL)
    _, out, _ = harness.serve(c, 5, SECONDS, False, "cpu",
                              time.perf_counter())
    params = c["arch"].draw(harness.shapes(c["config"]), 5, "cpu")
    program, _ = check.compare(c, params, out.finished, 5)
    kv4, _ = check.control(c, params, out.finished, 5, kv_bits=4)
    assert check.judged(program), program
    assert not check.judged(kv4), kv4
    assert kv4["mean_logit_gap"][0] >= 3 * program["mean_logit_gap"][0]
