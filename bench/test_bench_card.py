"""Runs on the card: each cell once, a short window, through the command
the driver runs.  Skips without a CUDA device (decided in a fixture)."""
import json
import subprocess
import sys

import pytest

from bench import harness

CELLS = [c["name"] for c in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 1), "--seconds", "8", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], p.stderr[-2000:]
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
