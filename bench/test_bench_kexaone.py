"""K-EXAONE's architecture module (``bench/archs/kexaone.py``) and its plain
reference (``bench/reference/kexaone.py``) at the cut-down size on the
CPU: the reference against the port's decode step, teacher-forced through
a paged KV8 pool in the engine's chunks, on the same raw weights and the
same expert choices (the tests may import both; the reference imports
nothing of the program); the module's interface (draw, the work counts,
the ranking, the dropless routing it hands the reference); the reader
``attn_roofline`` on its layers and the reader ``experts_per_moe_layer``;
a traced run of the cut-down cell; and every cell's module, this one's
among them, held to the interface and its counts."""
import collections
import json
import time

import numpy as np
import pytest
import torch

from bench import check, harness, hw, tiny
from bench.test_bench_trace_readers import step, window
from repro_torch import trace as T

torch.set_num_threads(1)

CELL = "kexaone236b.batch"
KX = harness.arch("kexaone")


def cut():
    """The cut-down cell's configuration and its drawn shapes."""
    c = tiny.cell(CELL)
    return c, harness.shapes(c["config"])


class Recorded:
    """``models.moe.route`` recording each routed layer's expert ids step
    by step, as the program chose them."""

    def __init__(self, monkeypatch):
        import repro_torch.models.moe as M
        self.steps, self.orig = [], M.route
        monkeypatch.setattr(M, "route", self)

    def __call__(self, x, lp, cfg, policy):
        probs, gates, idx = self.orig(x, lp, cfg, policy)
        self.steps.append(idx[0])
        return probs, gates, idx

    def route(self, routed, first):
        """The reference's ``route`` handed the program's choices: its
        ``routed`` layers follow the ``first`` dense ones."""
        per = [torch.cat(self.steps[i::routed]) for i in range(routed)]

        def route(layer, probs, at):
            ids = per[layer - first]
            return [(ids, torch.ones_like(ids, dtype=torch.bool), None)]
        return route


def program_logits(m, raw, stream, chunk, policy="w4a16kv8"):
    """The port's logits at every position from ``chunk - 1`` on (a chunk,
    then one token a step, as the engine feeds a slot)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    pol = get_policy(policy)
    model = build(ModelConfig(**m))
    params = quantize_params(raw, pol, "cpu")
    bps = 16
    cache = model.init_paged_cache(pol, 1, bps, 8, bps, "cpu")
    cache.block_table.copy_(torch.arange(bps, dtype=torch.int32)[None])
    out, p = [], 0
    for n in [chunk] + [1] * (len(stream) - chunk):
        logits, _ = model.decode_step(params, pol,
                                      torch.tensor([stream[p:p + n]]), cache,
                                      torch.tensor([p], dtype=torch.int32),
                                      max_live=bps * 8)
        out.append(logits[0].float())
        p += n
    return torch.stack(out)


def follow(seed, monkeypatch, kv_bits=None):
    """(program, reference) logits at positions 23 .. 59 of a seeded
    stream, the reference handed the program's expert choices."""
    c, m = cut()
    mm = c["config"]["model"]
    raw = KX.draw(m, seed, "cpu")
    stream = torch.randint(0, m["vocab"], (60,), generator=torch.Generator()
                           .manual_seed(seed % 1000)).tolist()
    rec = Recorded(monkeypatch)
    got = program_logits(mm, raw, stream, 24)
    first = mm["first_dense_layers"]
    ref = KX.kexaone.Reference(mm, raw, c["config"]["policy"], kv_bits) \
        .logits([stream], [range(23, 60)],
                rec.route(mm["n_layers"] - first, first))[0][:, 0]
    return got, ref


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_reference_follows_the_program(seed, monkeypatch):
    got, ref = follow(seed, monkeypatch)
    scale = ref.abs().max()
    # bf16 activations against float32, the same experts: a few % of the
    # largest logit (2.2-2.6 % on these seeds)
    err = (got - ref).abs().max()
    assert err < 4e-2 * scale
    # the control's precision (a KV4 pool) is told apart by far
    monkeypatch.undo()
    _, ref4 = follow(seed, monkeypatch, kv_bits=4)
    assert (got - ref4).abs().max() > 3 * err


def _rope_on_global():
    import repro_torch.models.transformer as TR
    return TR, "layer_rope", lambda cfg, i: True


def _post_norm_skipped():
    import repro_torch.models.transformer as TR
    orig = TR.sublayer_out
    return TR, "sublayer_out", lambda y, lp, name, cfg: (
        y if name == "post_ffn_norm" else orig(y, lp, name, cfg))


def _bias_in_gates():
    import repro_torch.models.moe as M
    return M, "biased_top_k", lambda s, b, k: M.top_k(s + b.float(), k)


def _qk_norm_skipped():
    import repro_torch.models.common as CM
    import repro_torch.models.transformer as TR
    orig = TR.qkv

    def qkv(h, lp, cfg, policy):
        B, T_, _ = h.shape
        q = CM.split_heads(CM.linear(h, lp["wq"], policy), B, T_,
                           cfg.n_heads, cfg.hd)
        _, k, v = orig(h, lp, cfg, policy)
        return q, k, v                               # q not normalised
    return TR, "qkv", qkv


#: faults of the layer equations, each planted in the program
EQUATION_FAULTS = {"rope_on_global": _rope_on_global,
                   "post_norm_skipped": _post_norm_skipped,
                   "bias_in_gates": _bias_in_gates,
                   "qk_norm_skipped": _qk_norm_skipped}


@pytest.mark.parametrize("fault", sorted(EQUATION_FAULTS))
def test_an_equation_fault_leaves_the_reference(fault, monkeypatch):
    mod, attr, fn = EQUATION_FAULTS[fault]()
    monkeypatch.setattr(mod, attr, fn)
    got, ref = follow(0, monkeypatch)
    assert (got - ref).abs().max() > 8e-2 * ref.abs().max()


def test_draw_gives_the_program_s_leaves():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.registry import build
    c, m = cut()
    raw = KX.draw(m, 7, "cpu")
    mine = build(ModelConfig(**c["config"]["model"])).init_params(0, "cpu")
    assert raw.keys() == mine.keys()
    for a, b in zip(raw["layers"], mine["layers"]):
        assert {k: v.shape for k, v in a.items()} == \
            {k: v.shape for k, v in b.items()}
        assert all(v.dtype == torch.bfloat16 for v in a.values())
    # the same seed, the same tensors; norm gains around 1, not at it
    again = KX.draw(m, 7, "cpu")
    assert torch.equal(again["layers"][2]["we2"], raw["layers"][2]["we2"])
    assert raw["layers"][1]["q_norm"].float().std() > 0.05


def test_draw_refuses_a_program_without_the_fields(monkeypatch):
    _, m = cut()
    monkeypatch.setattr(KX, "PROGRAM_FIELDS",
                        KX.PROGRAM_FIELDS + ("no_such_field",))
    with pytest.raises(ValueError, match="no_such_field"):
        KX.draw(m, 1, "cpu")


@pytest.mark.parametrize("size", ["published", "tiny"])
def test_work_counts(size):
    c = harness.load_cell(CELL) if size == "published" else cut()[0]
    m = harness.shapes(c["config"])
    d, f, fd = m["d_model"], m["d_ff"], m["dense_d_ff"]
    E, k, L = m["n_experts"], m["topk"], m["n_layers"]
    layers = KX.layer_gemms(m)
    assert len(layers) == L
    assert [n for n, _, _ in layers[0]][-3:] == ["w1", "w3", "w2"]
    assert ("w1", d, fd) in layers[0] and ("w2", fd, d) in layers[0]
    for layer in layers[1:]:
        assert ("router", d, E) in layer or d * E < hw.MIN_PACKED
        assert ("ws1", d, f) in layer and ("ws2", f, d) in layer
    assert KX.moe_layers(m) == [(E, k)] * (L - 1)
    assert KX.expert_gemms(m) == [("we1", d, f), ("we3", d, f),
                                  ("we2", f, d)]
    windows = [w for *_, w in KX.attn_layers(m)]
    assert windows == [m["window"]] * 3 + [None, m["window"]]
    if size == "published":
        assert (d, fd, f, E, k, L) == (6144, 18432, 2048, 128, 8, 5)
        # every weight packed: the GEMMs a token passes and its top-k
        # experts are the matmul parameters it multiplies
        per_token = sum(K * N for layer in layers for _, K, N in layer)
        per_token += (L - 1) * k * sum(K * N for _, K, N in
                                       KX.expert_gemms(m))
        assert per_token == KX.matmul_params(m)


def test_rank_is_the_biased_score_in_f64():
    s = torch.rand(3, 16)
    r = KX.rank(s)
    assert r.dtype == torch.float64 and torch.equal(r, s.double())


def routing(served, factor=4.0, eps=0.05, chunk=8):
    return check.Routing(served, dict(topk=2, n_experts=8,
                                      capacity_factor=factor), chunk, eps,
                         KX.rank)


def test_dropless_keeps_every_choice_and_opens_only_ties():
    served = [check.Served([1] * 9, [1] * 4, 4)]
    scores = torch.tensor([[0.9, 0.8, 0.79, 0.1, 0.1, 0.1, 0.1, 0.1]] * 12,
                          dtype=torch.float64)
    r = routing(served)
    raw_alts = r(0, [scores], [[8, 11]])[0][2][0].shape[1]
    r = routing(served)
    [(idx, keep, (ids, kept))] = KX.Dropless(r)(0, [scores], [[8, 11]])
    assert idx[:, :2].tolist() == [[0, 1]] * 12 and keep.all() and kept.all()
    # the routing's keep alternatives beside padding rows are gone: the
    # two sets of the tie (0.8 against 0.79) are left
    assert raw_alts > 2
    assert [sorted(map(tuple, p)) for p in ids.tolist()] == \
        [[(0, 1), (0, 2)]] * 2
    assert r.open == [2, 2]
    assert [sorted(t) for t in r.ties[0]] == [[0.0, pytest.approx(0.01)]] * 2
    # a factor under E/k could drop a choice of a chunk-wide row: refused
    with pytest.raises(ValueError, match="dropless"):
        KX.Dropless(routing(served, factor=1.0))


def test_attn_roofline_reads_the_local_and_global_layers(monkeypatch):
    """One slot feeding 2 rows at position 200 on the published geometry:
    four layers read the window's 128 keys, the global one all 202."""
    read = harness.reader("attn_roofline.tput")
    m = harness.shapes(harness.load_cell(CELL)["config"])
    monkeypatch.setattr(T, "session", lambda: [
        step(0, 2, [200], [2], (0,) * 7, (2, 2, 0, 0, 0, 0, 4))])
    w = window(1, m, {"paged_kvattn_kernel": 1e-3})
    w.arch = KX
    H, Hkv, D = 64, 8, 128
    per_key = Hkv * 2 * (D + 4)
    q_out = 2 * 2 * H * D * 2
    local = hw.least_seconds(4 * H * D * 256, 128 * per_key + q_out)
    glob = hw.least_seconds(4 * H * D * (201 + 202), 202 * per_key + q_out)
    assert read(w) == pytest.approx(100 * (4 * local + glob) / 1e-3)


def test_traced_cpu_run_reads_every_program_metric():
    c = tiny.cell(CELL)
    w, out, _ = harness.serve(c, 2 ** 31 + 7, 7.0, True, "cpu",
                              time.perf_counter())
    assert len(T.session()) == len(w.steps) - w.trace.first_step > 0
    for m in c["per_layer"]:
        v = harness.reader(m["name"])(w)
        if m["name"].endswith("_roofline.tput"):
            assert v is None, m["name"]        # no device kernels here
        elif m["source"] != "device_trace" and \
                m["name"] != "moe_packed_share.tput":
            assert v is not None and v > 0, m["name"]
    # the CPU's tile stacks run plain; each routed layer runs at most E
    E = c["config"]["model"]["n_experts"]
    assert harness.reader("moe_packed_share.tput")(w) == 0.0
    assert 0 < harness.reader("experts_per_moe_layer.tput")(w) <= E


def test_experts_per_moe_layer_reads_the_counters(monkeypatch):
    read = harness.reader("experts_per_moe_layer.tput")
    # counters: fed, rows, syncs, packed, plain, expert rows, moe layers
    recs = [step(0, 8, [0], [8], (0,) * 7, (8, 8, 9, 50, 0, 90, 4)),
            step(1, 1, [8], [1], (8, 8, 9, 50, 0, 90, 4),
                 (9, 9, 12, 80, 2, 99, 8))]
    monkeypatch.setattr(T, "session", lambda: list(recs))
    assert read(window(2)) == pytest.approx(82 / 8)
    assert read(window(2, trace=False)) is None
    # a program without the counter (its step records' counters lack it)
    Old = collections.namedtuple("Counters", T.Counters._fields[:6])
    old = [T.Step(0, Old(0, 0, 0, 0, 0, 0), Old(8, 8, 9, 50, 0, 90), 8,
                  np.array([0]), np.array([8]))]
    monkeypatch.setattr(T, "session", lambda: list(old))
    assert read(window(1)) is None
    # no routed layer ran (a dense model)
    monkeypatch.setattr(T, "session", lambda: [step(0, 1, [3], [1], (0,) * 7,
                                                    (1, 1, 1, 0, 0, 0, 0))])
    assert read(window(1)) is None


ALL_CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_each_cell_s_module_counts_its_held_layers(cell):
    """Every cell's architecture module (K-EXAONE's too) gives the whole
    interface, and its counts agree on the published shapes: a GEMM list
    and an attention entry per held layer, at most one routing entry per
    layer, expert products exactly where some layer routes, and a matmul
    count at least the packed GEMMs a token passes."""
    c = harness.load_cell(cell)
    a, m = c["arch"], harness.shapes(c["config"])
    assert all(callable(getattr(a, f)) for f in harness.ARCH_API)
    L = m["n_layers"]
    assert len(a.layer_gemms(m)) == len(a.attn_layers(m)) == L
    assert len(a.moe_layers(m)) <= L
    assert bool(a.moe_layers(m)) == bool(a.expert_gemms(m))
    packed = sum(K * N for layer in a.layer_gemms(m) for _, K, N in layer)
    assert a.matmul_params(m) >= packed
