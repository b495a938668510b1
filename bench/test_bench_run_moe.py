"""Whole runs of ``arctic480b.batch`` cut down to the CPU (``bench.tiny``):
``correct`` holds on a sound program, and comes out false with each
fault the cell can have planted in the timed path; and the
control (the reference with a KV4 cache in its place) comes out false."""
import pytest

from bench import check, runs

CELL = "arctic480b.batch"


def test_sound_run_is_correct():
    res, lines = runs.run(CELL, 2 ** 31 + 3)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["token_altered", "kv_unwritten",
                                   "routing_reversed"])
def test_fault_makes_correct_false(fault):
    res, lines = runs.run(CELL, 11, fault)
    assert not res["correct"], lines


def test_control_reads_far_above_the_program():
    # the reference with a KV4 cache in the program's place, judged as a
    # run judges the program, at the cut-down size's own limit
    r = runs.readings(CELL, 5)
    assert check.judged(r["program"]), r
    assert not check.judged(r["kv4"]), r
    gap = r["program"]["max_logit_gap"][0]
    assert r["kv4"]["max_logit_gap"][0] >= 3 * gap, r
