"""A configuration names its architecture module (``bench/archs/<arch>.py``)
and the harness, the check, the control and the readers take everything
specific to a model from it.

The decoder module gives what the benchmark's pieces gave before it
existed: the same weights, reference logits, routing and work counts.  A
module in another root, a copy of the decoder whose exports record their
calls, is reached in its place by a configuration that names it, with no
file of the benchmark edited; a run there comes out correct, and with its
reference altered, not correct."""
import json
import shutil
import time

import numpy as np
import pytest
import torch

from bench import check, harness, hw, tiny, weights
from bench.reference.model import Reference
from bench.test_bench_trace_readers import step, window
from repro_torch import trace as T

torch.set_num_threads(1)
CELLS = ["mistral123b.chat", "arctic480b.batch"]
DECODER = harness.arch("decoder")


def parent_rank(p):
    return torch.log(p.double())


def parent_windows(model):
    win, period = model.get("window"), model.get("local_global_period")
    return [None if win is None or
            (period and i % period == period - 1) else win
            for i in range(model["n_layers"])]


def served_requests(vocab, seed):
    g = np.random.default_rng(seed)
    return {rid: check.Served(g.integers(0, vocab, n).tolist(),
                              g.integers(0, vocab, k).tolist(), k)
            for rid, (n, k) in enumerate([(20, 6), (13, 9), (9, 3)])}


@pytest.mark.parametrize("cell", CELLS)
def test_decoder_draws_and_judges_as_before(cell):
    c = tiny.cell(cell)
    cfg = c["config"]
    model = harness.shapes(cfg)
    assert c["arch"].__name__ == "bench.archs.decoder"
    # the decoder binds the benchmark's own weights and reference
    assert c["arch"].draw is weights.draw
    assert c["arch"].Reference is Reference
    seed = 2 ** 31 + 9
    params = c["arch"].draw(model, seed, "cpu")
    served = served_requests(model["vocab"], seed % 1000)
    rids = sorted(served)
    judge = check.Judge(c, params, served, rids)
    route = None
    if model.get("n_experts"):
        route = check.Routing([served[r] for r in rids], cfg["model"],
                              cfg["engine"]["prefill_chunk"],
                              cfg["check"]["tie_eps"], parent_rank)
    seqs, at = zip(*(check._positions(served[r]) for r in rids))
    ref = Reference(cfg["model"], params, cfg["policy"]).logits(seqs, at,
                                                                 route)
    assert len(judge.logits) == len(ref)
    for a, b in zip(judge.logits, ref):
        assert torch.equal(a, b)
    if route is not None:
        assert judge.route.ties == route.ties
        assert judge.route.open == route.open


def test_routing_ranks_as_before():
    g = torch.Generator().manual_seed(3)
    probs = [torch.softmax(torch.randn(n, 8, generator=g, dtype=torch.float64)
                           * 2, -1) for n in (12, 5)]
    served = [check.Served([1] * 9, [1] * 4, 4), check.Served([1] * 3, [1] * 3,
                                                              3)]
    outs = []
    for rank in (DECODER.rank, parent_rank):
        r = check.Routing(served, dict(topk=2, n_experts=8), 4, 0.1, rank)
        outs.append((r(0, probs, [[8, 11], [2, 4]]), r.ties, r.open))
    (new, new_ties, new_open), (old, old_ties, old_open) = outs
    for (i, k, (ai, ak)), (i0, k0, (ai0, ak0)) in zip(new, old):
        assert torch.equal(i, i0) and torch.equal(k, k0)
        assert torch.equal(ai, ai0) and torch.equal(ak, ak0)
    assert (new_ties, new_open) == (old_ties, old_open)


@pytest.mark.parametrize("size", ["published", "tiny"])
@pytest.mark.parametrize("cell", CELLS)
def test_decoder_counts_the_work_as_before(cell, size):
    c = tiny.cell(cell) if size == "tiny" else harness.load_cell(cell)
    m = harness.shapes(c["config"])
    a = c["arch"]
    assert len(a.layer_gemms(m)) == m["n_layers"]
    routed = [(m["n_experts"], m["topk"])] * m["n_layers"] \
        if m.get("n_experts") else []
    assert a.moe_layers(m) == routed
    if size == "published":
        # the packed GEMMs and the top-k experts' products a token passes
        # are the matmul parameters it multiplies (every weight packed)
        per_token = sum(K * N for layer in a.layer_gemms(m)
                        for _, K, N in layer)
        per_token += sum(k for _, k in routed) * sum(
            K * N for _, K, N in a.expert_gemms(m))
        assert per_token == a.matmul_params(m)
    H, Hkv = m["n_heads"], m["n_kv_heads"]
    D = m.get("head_dim") or m["d_model"] // H
    for model in (m, dict(m, n_layers=6, window=128, local_global_period=4)):
        assert a.attn_layers(model) == [(H, Hkv, D, w)
                                        for w in parent_windows(model)]
    d, f = m["d_model"], m["d_ff"]
    assert a.expert_gemms(m) == ([("we1", d, f), ("we3", d, f),
                                  ("we2", f, d)] if m.get("n_experts") else [])


MOE = dict(n_layers=1, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
           vocab=1024, n_experts=8, topk=2, moe_dense_residual=True,
           residual_d_ff=256)


def parent_gemm_roofline(w):
    """The reader before architecture modules: one layer's packed GEMMs,
    times the held layers."""
    least = 0.0
    for _, _, fed, _ in w.steps[w.trace.first_step:]:
        for _, K, N in hw.packed_gemms(w.model):
            wb = hw.weight_bytes(K, N, 4, hw.weight_group(K, N))
            least += hw.least_seconds(*hw.gemm(fed, K, N, wb))
    dev = sum(s for n, s in w.trace.kernel_s.items() if "gemm_kernel" in n)
    return 100.0 * least * w.model["n_layers"] / dev


@pytest.fixture
def held(monkeypatch):
    def hold(recs):
        monkeypatch.setattr(T, "session", lambda: list(recs))
    return hold


def test_gemm_roofline_counts_the_routed_experts(held):
    read = harness.reader("gemm_roofline.tput")
    ks = {"void gemm_kernel<false, 4, 1, 8>": 2e-3}
    # counters: fed, rows, syncs, packed, plain, expert rows
    held([step(0, 8, [0], [8], (0,) * 6, (8, 8, 9, 0, 0, 0)),
          step(1, 1, [8], [1], (8, 8, 9, 0, 0, 0), (9, 9, 12, 0, 0, 0))])
    dense = read(window(2, MOE, ks))
    assert dense == pytest.approx(parent_gemm_roofline(window(2, MOE, ks)),
                                  rel=1e-12)
    # the first step feeds 2 rows and runs all 8 experts (padding rows
    # touched the rest): its 2 rows x top-2 need at most 4; the second
    # feeds 1 row and runs 1 expert.  we1 / we3 256 x 512 (group 128),
    # we2 512 x 256 (group 32)
    w13 = 256 * 512 // 2 + 2 * 512 * 4
    w2 = 512 * 256 // 2 + 16 * 256 * 4

    def experts(rows, n):
        return 2 * (rows * 768 * 2 + n * w13) + rows * 768 * 2 + n * w2
    by_hand = (experts(4, 4) + experts(2, 1)) / hw.HBM_BYTES_PER_S
    for ran in (8, 5, 4):
        held([step(0, 8, [0, 0], [1, 1], (0,) * 6, (2, 16, 9, ran, 0, 64)),
              step(1, 1, [1, 1], [1, 0], (2, 16, 9, ran, 0, 64),
                   (3, 18, 12, ran + 1, 0, 65))])
        assert read(window(2, MOE, ks)) - dense == pytest.approx(
            100 * by_hand / 2e-3, rel=1e-9)
    # fewer experts ran than the fed rows could touch: those are read
    held([step(0, 8, [0, 0], [1, 1], (0,) * 6, (2, 16, 9, 3, 0, 64)),
          step(1, 1, [1, 1], [1, 0], (2, 16, 9, 3, 0, 64),
               (3, 18, 12, 4, 0, 65))])
    by_hand = (experts(4, 3) + experts(2, 1)) / hw.HBM_BYTES_PER_S
    assert read(window(2, MOE, ks)) - dense == pytest.approx(
        100 * by_hand / 2e-3, rel=1e-9)
    # two moe layers: the bound and the rows are each layer's
    held([step(0, 8, [0, 0], [1, 1], (0,) * 6, (2, 16, 9, 16, 0, 128))])
    two = dict(MOE, n_layers=2)
    dense2 = parent_gemm_roofline(window(1, two, ks))
    by_hand = experts(8, 8) / hw.HBM_BYTES_PER_S
    assert read(window(1, two, ks)) - dense2 == pytest.approx(
        100 * by_hand / 2e-3, rel=1e-9)


def test_gemm_roofline_without_the_experts_counts_reads_none(held):
    read = harness.reader("gemm_roofline.tput")
    ks = {"gemm_kernel": 1e-3}
    # an expert ran down the plain path: its rows cannot be told apart
    held([step(0, 1, [3], [1], (0,) * 6, (1, 1, 1, 2, 1, 7))])
    assert read(window(1, MOE, ks)) is None
    # no session of the traced slice (two steps traced, one held)
    assert read(window(3, MOE, ks, first_step=1)) is None
    assert read(window(1, MOE, ks, trace=False)) is None
    # a dense model needs no step records
    dense = dict(MOE, n_experts=0)
    assert read(window(3, dense, ks, first_step=1)) == pytest.approx(
        parent_gemm_roofline(window(3, dense, ks, first_step=1)), rel=1e-12)


SPY = '''

import dataclasses

SEEN = set()


@dataclasses.dataclass
class Held:
    """A dataclass, as a module loaded by path may define."""
    layers: int


def _spied(name, fn):
    def spy(*a, **k):
        SEEN.add(name)
        return fn(*a, **k)
    return spy


for _name in __all__:
    globals()[_name] = _spied(_name, globals()[_name])
'''

ALTERED = '''

class Reference(Reference):
    """The decoder's reference with each position's least likely token
    put first."""

    def logits(self, *a, **k):
        return [x.scatter_add(-1, x.argmin(-1, keepdim=True),
                              torch.full_like(x[..., :1], 1e3))
                for x in super().logits(*a, **k)]
'''


def spy_root(tmp_path, altered=False):
    """A root that holds one cell, ``spy.batch``: arctic's configuration
    naming the architecture ``spy``, the batch traffic, and ``spy.py``, a
    copy of the decoder whose exports record their calls."""
    src = harness.ROOT
    bench = json.loads((src / "BENCHMARK.json").read_text())
    arctic = json.loads((src / "bench/configs/arctic-480b.w4a16kv8.json")
                        .read_text())
    entry = dict(next(c for c in bench["configs"]
                      if c["name"] == arctic["name"]),
                 name="spy-arctic", file="bench/configs/spy-arctic.json")
    for d in ("configs", "traffic", "archs"):
        (tmp_path / "bench" / d).mkdir(parents=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(dict(
        bench, configs=[entry], workloads=[dict(
            name="spy.batch", config="spy-arctic", traffic="batch_closed_16",
            chips=1, why="a configuration naming its own architecture")])))
    (tmp_path / entry["file"]).write_text(json.dumps(dict(
        arctic, name="spy-arctic", arch="spy")))
    shutil.copy(src / "bench/traffic/batch_closed_16.json",
                tmp_path / "bench/traffic")
    code = (src / "bench/archs/decoder.py").read_text()
    (tmp_path / "bench/archs/spy.py").write_text(
        code + (ALTERED if altered else "") + SPY)
    return tmp_path


def test_a_configuration_reaches_its_own_architecture(tmp_path, held):
    root = spy_root(tmp_path)
    c = tiny.cell("spy.batch", root)
    spy = c["arch"]
    assert spy.__file__ == str(root / "bench/archs/spy.py")
    assert spy.SEEN == {"tiny"}
    res, lines = harness.run(c, 2 ** 31 + 3, 2.0, False, "cpu",
                             time.perf_counter())
    assert res["correct"], lines
    assert spy.SEEN >= {"tiny", "draw", "Reference", "rank"}
    # the control: the reference with a KV4 cache in the program's place
    spy.SEEN.clear()
    _, out, _ = harness.serve(c, 5, 2.0, False, "cpu", time.perf_counter())
    assert spy.SEEN == {"draw"}
    params = spy.draw(harness.shapes(c["config"]), 5, "cpu")
    spy.SEEN.clear()
    nums, _ = check.control(c, params, out.finished, 5, kv_bits=4)
    assert not check.judged(nums)
    assert spy.SEEN == {"Reference", "rank"}
    # each reader of the architecture's work counts
    spy.SEEN.clear()
    held([step(0, 8, [0], [8], (0,) * 6, (8, 8, 9, 3, 0, 10))])
    w = window(1, MOE, {"gemm_kernel": 1e-3, "paged_kvattn": 1e-4})
    w.arch = spy
    for metric in ("mfu.tput", "gemm_roofline.tput", "attn_roofline.itl"):
        assert harness.reader(metric)(w) > 0
    assert spy.SEEN == {"matmul_params", "layer_gemms", "expert_gemms",
                        "moe_layers", "attn_layers"}


def test_an_altered_reference_in_its_place_is_not_correct(tmp_path):
    c = tiny.cell("spy.batch", spy_root(tmp_path, altered=True))
    res, lines = harness.run(c, 2 ** 31 + 3, 2.0, False, "cpu",
                             time.perf_counter())
    assert not res["correct"], lines
    assert "Reference" in c["arch"].SEEN


def test_an_unknown_or_partial_architecture_is_refused(tmp_path):
    with pytest.raises(harness.CellError):
        harness.arch("decoder", tmp_path)
    (tmp_path / "bench/archs").mkdir(parents=True)
    (tmp_path / "bench/archs/half.py").write_text(
        "def draw(model, seed, device):\n    return {}\n")
    with pytest.raises(harness.CellError, match="does not export"):
        harness.arch("half", tmp_path)
