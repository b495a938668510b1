"""The readers of the program's own trace (``repro_torch.trace``): each on
a hand-built session and window against the value worked out by hand,
None without a trace or with a session that is not the traced slice;
and traced runs of the cut-down cells on the CPU, where the session
holds exactly the traced steps and every reader but the device trace's
gives a value."""
import time

import numpy as np
import pytest

from bench import harness, hw, tiny
from bench.trace import Trace
from repro_torch import trace as T

C = T.Counters
DECODER = harness.arch("decoder")


def window(steps, model=None, kernel_s=None, first_step=0, trace=True):
    tr = Trace(window_s=6.0, busy_s=1.0, kernel_s=kernel_s or {},
               span_device_s={}, span_count={}, idle_by_host={},
               first_step=first_step) if trace else None
    return harness.Window(model=model or {}, arch=DECODER, policy="w4a16kv8",
                          setup_s=1.0,
                          seconds=10.0, due={}, first={}, returns={},
                          steps=[(0.0, 0.1, 1, 1)] * steps, model_steps=steps,
                          fed_tokens=steps, trace=tr)


def step(i, t_step, pos, valid, start, end, waits=(), layer_s=()):
    spans = [T.Span("engine.step", 0.0, 1.0, -1, i)]
    spans += [T.Span("model.layer", 0.0, s, 0, i) for s in layer_s]
    return T.Step(i, C(*start), C(*end), t_step,
                  np.array(pos, np.int32), np.array(valid, np.int32),
                  list(waits), spans)


@pytest.fixture
def held(monkeypatch):
    """Hand the readers ``recs`` as the program's session."""
    def hold(recs):
        monkeypatch.setattr(T, "session", lambda: list(recs))
    return hold


def test_fed_row_share_counts_padding_and_idle_slots(held):
    # 4 slots: a chunk step (8 wide) feeding 3 and 8 rows, two slots idle;
    # then a decode step feeding 2 of 4 rows
    held([step(0, 8, [8, 0, 0, 0], [3, 8, 0, 0], (10, 0, 5), (21, 32, 9)),
          step(1, 1, [11, 8, 0, 0], [1, 1, 0, 0], (21, 32, 9), (23, 36, 14))])
    w = window(2)
    assert harness.reader("fed_row_share.ttft")(w) == \
        pytest.approx(100 * 13 / 36)
    assert harness.reader("host_syncs_per_step.tput")(w) == 9 / 2


def test_attn_roofline_with_a_window(held):
    # layer 0 local (window 16), layer 1 global; H 4, Hkv 2, D 64, KV8;
    # slot 0 feeds 2 rows at position 20, slot 1 is idle
    model = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                 window=16, local_global_period=2)
    held([step(0, 2, [20, 0], [2, 0], (0, 0, 0), (2, 4, 0))])
    w = window(1, model, {"void paged_kvattn_kernel<0>": 2e-6,
                          "gemm_kernel": 1.0})
    per_key = 2 * 2 * (64 + 4)              # K and V, values and scales
    q_out = 2 * 2 * 4 * 64 * 2               # 2 rows of q and out, bf16
    local = hw.least_seconds(4 * 4 * 64 * (16 + 16), 16 * per_key + q_out)
    glob = hw.least_seconds(4 * 4 * 64 * (21 + 22), 22 * per_key + q_out)
    assert harness.reader("attn_roofline.itl")(w) == \
        pytest.approx(100 * (local + glob) / 2e-6)
    # no paged attention kernel in the trace
    assert harness.reader("attn_roofline.itl")(window(1, model)) is None


def test_queue_wait_and_layer_host_time(held, capsys):
    held([step(0, 8, [0], [8], (0, 0, 0), (8, 8, 0),
               waits=[(0, 0.010), (1, 0.030)], layer_s=[0.5]),
          step(1, 1, [8], [1], (8, 8, 0), (9, 9, 0),
               waits=[(2, 0.020)], layer_s=[0.002, 0.004]),
          step(2, 1, [9], [1], (9, 9, 0), (10, 10, 0), layer_s=[0.003])])
    w = window(3)
    assert harness.reader("queue_wait_ms.ttft")(w) == pytest.approx(20.0)
    assert "3 requests" in capsys.readouterr().err
    # every step width's layers, and no other span (engine.step: 1 s)
    assert harness.reader("layer_host_ms.itl")(w) == pytest.approx(3.5)


NEW = ["queue_wait_ms.ttft", "fed_row_share.ttft", "fed_row_share.tput",
       "attn_roofline.itl", "host_syncs_per_step.tput", "layer_host_ms.itl"]


@pytest.mark.parametrize("metric", NEW)
def test_no_trace_or_another_slice_reads_none(held, metric):
    held([step(0, 1, [3], [1], (0, 0, 0), (1, 1, 1), waits=[(0, 0.1)],
               layer_s=[0.001])])
    model = dict(n_layers=1, d_model=256, n_heads=4, n_kv_heads=2)
    ks = {"paged_kvattn": 1e-6}
    read = harness.reader(metric)
    assert read(window(1, model, ks)) is not None
    assert read(window(1, model, ks, trace=False)) is None
    # the session is not the traced slice: two steps traced, one held
    assert read(window(3, model, ks, first_step=1)) is None


@pytest.mark.parametrize("cell", ["mistral123b.chat", "arctic480b.batch"])
def test_traced_cpu_run_reads_the_program_s_session(cell):
    c = tiny.cell(cell)
    w, out, _ = harness.serve(c, 2 ** 31 + 7, 7.0, True, "cpu",
                              time.perf_counter())
    recs = T.session()
    assert len(recs) == len(w.steps) - w.trace.first_step > 0
    for m in c["per_layer"]:
        if m["name"] not in NEW:
            continue
        v = harness.reader(m["name"])(w)
        if m["source"] == "device_trace":
            assert v is None                # no device kernels on the CPU
        else:
            assert v is not None and v >= 0, m["name"]
            if m["unit"] == "%":
                assert 0 < v <= 100
