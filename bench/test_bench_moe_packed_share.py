"""``moe_packed_share``: the share of the routed experts' FFNs that ran
through the A16 GEMM kernel, from the program's step records, on a
hand-built session; None where no expert ran, without a trace, and for a
program whose step records keep no such counters."""
from collections import namedtuple

import numpy as np
import pytest

from bench import harness
from bench.test_bench_trace_readers import step, window
from repro_torch import trace as T

READ = "moe_packed_share.tput"


@pytest.fixture
def held(monkeypatch):
    def hold(recs):
        monkeypatch.setattr(T, "session", lambda: list(recs))
    return hold


def test_share_of_packed_expert_ffns(held):
    # counters: fed, rows, syncs, packed, plain, expert rows
    held([step(0, 8, [8], [8], (0, 0, 0, 10, 4, 0), (8, 8, 9, 70, 4, 300)),
          step(1, 1, [8], [1], (8, 8, 9, 70, 4, 300),
               (9, 9, 12, 72, 6, 304))])
    assert harness.reader(READ)(window(2)) == pytest.approx(
        100 * 62 / (62 + 2))
    assert harness.reader(READ)(window(2, trace=False)) is None


def test_no_expert_ran_reads_none(held):
    held([step(0, 1, [3], [1], (0, 0, 0), (1, 1, 1))])
    assert harness.reader(READ)(window(1)) is None


def test_a_program_without_the_counters_reads_none(held):
    Old = namedtuple("Counters", "fed_tokens computed_rows host_syncs")
    held([T.Step(0, Old(0, 0, 0), Old(1, 1, 1), 1, np.array([3]),
                 np.array([1]))])
    assert harness.reader(READ)(window(1)) is None
