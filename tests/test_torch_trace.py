"""``repro_torch.trace``: the serving step's spans and counters.

With no profiler running a step records nothing and never enters the
profiler's record-function machinery.  Under ``torch.profiler`` every
``Engine.step`` leaves one record and properly nested spans on the
profiler's timeline.  On the card (marked ``cuda``; this file imports
nothing of JAX, so ``PYTHONPATH=src python -m pytest --noconftest -q
tests/test_torch_trace.py`` runs it there) ``trace.host_syncs`` rises by
exactly the syncs ``torch.cuda.set_sync_debug_mode`` reports in each
step; the moe engine's experts run through the A16 GEMM on stacks in its
fragment order, adding no sync, and so do K-EXAONE's (its QK and post
norms, RoPE per layer, sigmoid router and shared expert add none).
"""
import json
import warnings
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace as T
from repro_torch.configs import get_reduced
from repro_torch.serving import Engine, EngineConfig, SamplingParams

ARCHS = {"dense": "smollm-360m", "moe": "arctic-480b",
         "kexaone": "k-exaone-236b-a23b"}
CHUNK = 8


def engine(family, device="cpu"):
    """A tiny paged engine with chunked prefill (REDUCED widths: head dims
    64 and 32, which the card's kernels take)."""
    return Engine(EngineConfig(model=get_reduced(ARCHS[family]),
                               device=device, n_slots=4,
                               max_seq=128, block_size=8,
                               prefill_chunk=CHUNK, cache_kind="paged"))


def submit(eng, lengths, new_tokens=3):
    """Submit prompts of ``lengths``; returns their Request objects (kept
    past their retirement)."""
    reqs = []
    for n in lengths:
        rid = eng.submit([(7 * i) % 1000 + 1 for i in range(n)],
                         SamplingParams(max_new_tokens=new_tokens))
        reqs.append(eng._requests[rid])
    return reqs


@pytest.fixture
def fresh_session(monkeypatch):
    monkeypatch.setattr(T, "_session", deque(maxlen=T.MAX_STEPS))


def _raise(*a, **k):
    raise AssertionError("a record function was entered with no profiler")


@pytest.mark.parametrize("family", list(ARCHS))
def test_no_profiler_no_record(family, fresh_session, monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    eng = engine(family)
    submit(eng, [11, 5, 19])
    syncs, steps = T.host_syncs, 0
    while not eng.scheduler.idle:
        eng.step()
        steps += 1
    assert T.session() == [] and T._step is None
    # the counters are always on
    assert T.host_syncs - syncs >= 3 * steps
    assert eng.computed_rows >= eng.fed_tokens > 0
    assert eng.computed_rows % eng.n_slots == 0


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X"]


def _inside(ev, outer):
    return outer["ts"] <= ev["ts"] and \
        ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("family", list(ARCHS))
def test_profiled_steps_nest_and_record(family, fresh_session, tmp_path):
    eng = engine(family)
    reqs = submit(eng, [11, 5])
    fed = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(6):
            if i == 2:
                reqs += submit(eng, [19, 3])
            fed0 = eng.fed_tokens
            eng.step()
            fed.append(eng.fed_tokens - fed0)
    recs = T.session()
    assert [r.index for r in recs] == list(range(6))
    L = eng.model_cfg.n_layers
    for r, f in zip(recs, fed):
        assert r.end.computed_rows - r.start.computed_rows == \
            eng.n_slots * r.t_step
        assert r.end.fed_tokens - r.start.fed_tokens == f == r.valid.sum()
        names = [s.name for s in r.spans]
        assert names[0] == "engine.step" and r.spans[0].parent == -1
        assert names.count("model.layer") == L
        if family == "moe":
            for n in ("moe.ffn", "moe.route", "moe.dispatch", "moe.experts"):
                assert names.count(n) == L
        for s in r.spans[1:]:
            p = r.spans[s.parent]
            assert p.start <= s.start <= s.end <= p.end and s.step == r.index
    # every request's wait, once, at its first admission
    waits = dict(w for r in recs for w in r.waits)
    assert sorted(waits) == [q.rid for q in reqs]
    for q in reqs:
        assert waits[q.rid] == q.admit_time - q.arrival_time >= 0
    # the profiler's timeline: engine.step ⊃ model.forward ⊃ L model.layer
    ev = _events(prof, tmp_path)
    steps = [e for e in ev if e["name"] == "engine.step"]
    fwd = [e for e in ev if e["name"] == "model.forward"]
    layers = [e for e in ev if e["name"] == "model.layer"]
    assert len(steps) == len(fwd) == 6 and len(layers) == 6 * L
    for s, f in zip(sorted(steps, key=lambda e: e["ts"]),
                    sorted(fwd, key=lambda e: e["ts"])):
        assert _inside(f, s)
        assert sum(_inside(x, f) for x in layers) == L


@pytest.mark.parametrize("family", ["moe", "kexaone"])
def test_routed_layers_counted_and_shared_expert_spanned(family,
                                                         fresh_session):
    """``trace.moe_layers_run`` rises by the routed layers each model step
    (K-EXAONE's dense layer 0 routes nothing), and ``moe.shared`` spans
    the shared expert (arctic: the dense residual) in each of them."""
    eng = engine(family)
    cfg = eng.model_cfg
    routed = cfg.n_layers - cfg.first_dense_layers
    submit(eng, [11, 5, 19])
    with profile(activities=[ProfilerActivity.CPU]):
        while not eng.scheduler.idle:
            eng.step()
    recs = [r for r in T.session() if r.t_step]
    assert recs
    for r in recs:
        assert r.end.moe_layers_run - r.start.moe_layers_run == routed
        names = [s.name for s in r.spans]
        assert names.count("moe.shared") == names.count("moe.ffn") == routed
        for i, s in enumerate(r.spans):
            if s.name == "moe.shared":
                assert r.spans[s.parent].name == "model.layer"


def test_a_new_session_clears_the_last(fresh_session):
    eng = engine("dense")
    submit(eng, [11, 5, 19], new_tokens=6)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step()
        eng.step()
    assert len(T.session()) == 2
    eng.step()                          # off: the record stays
    assert len(T.session()) == 2
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            eng.step()
    assert [r.index for r in T.session()] == [0, 1, 2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("family", list(ARCHS))
def test_host_syncs_are_the_card_s_syncs(card, family):
    """Each step's ``host_syncs`` increment equals the synchronizing
    calls the sync debug mode reports: admitting chunk-wide steps, a
    step that finishes a prompt, decode steps, and retiring steps."""
    eng = engine(family, device="cuda")
    packed0 = T.moe_experts_packed, T.moe_experts_plain
    eng.generate([[1] * (CHUNK + 1)], SamplingParams(max_new_tokens=2))
    submit(eng, [CHUNK + 1, 3], new_tokens=3)
    widths = []
    while not eng.scheduler.idle:
        torch.cuda.synchronize()
        n0, fed0 = T.host_syncs, eng.fed_tokens
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [f"{w.filename}:{w.lineno}" for w in ws
                 if "called a synchronizing" in str(w.message)]
        assert len(syncs) == T.host_syncs - n0, syncs
        widths.append(eng.fed_tokens - fed0)
    assert widths[0] == CHUNK + 3 and widths[-1] == 1, widths
    if family == "moe":
        assert all(lp[n].layout == "frag_a16" for lp in eng.params["layers"]
                   for n in ("we1", "we3", "we2"))
        assert T.moe_experts_packed > packed0[0]
        assert T.moe_experts_plain == packed0[1]
