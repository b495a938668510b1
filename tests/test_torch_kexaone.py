"""K-EXAONE's layer kinds in the port (``configs/k_exaone_236b.py``,
REDUCED: one dense layer, then routed layers ``L L G L`` of 16 experts,
top-4, window 8): the sigmoid router, whose bias selects and never
weighs; RoPE on the windowed layers only; the window's reach; the QK and
post-sub-layer norms; the dense first layer; the three forwards agreeing;
the new leaves packed and sharded; and a configuration that sets none of
the new fields drawing the same leaves as before.  No JAX: the JAX package
has no such model (the plain reference, ``bench/reference/kexaone.py``,
holds the port to the equations in ``bench/test_bench_kexaone.py``)."""
import dataclasses

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import ARCHS, PORT_ONLY, get_config, get_reduced
from repro_torch.configs.base import jax_fields
from repro_torch.core import attention as A
from repro_torch.core.packing import PackedWeight
from repro_torch.core.precision import get_policy
from repro_torch.launch import mesh as TM
from repro_torch.launch.sharding import ShardingRules
from repro_torch.models import common as C
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.registry import build
from repro_torch.serving.engine import _SKIP_KEYS, quantize_params

torch.set_num_threads(1)

ARCH = "k-exaone-236b-a23b"
CFG = get_reduced(ARCH)
BF16 = get_policy("w16a16kv16")


@pytest.fixture(scope="module")
def raw():
    """REDUCED parameters with nonzero norm gains (zeros would hide a
    gain read from the wrong leaf)."""
    p = build(CFG).init_params(3, "cpu")
    g = torch.Generator().manual_seed(4)
    for lp in p["layers"]:
        for n in ("post_attn_norm", "post_ffn_norm", "q_norm", "k_norm"):
            lp[n] = (torch.randn(lp[n].shape, generator=g) * 0.1).to(
                torch.bfloat16)
    return p


def test_configuration_is_the_published_model():
    c = get_config(ARCH)
    assert ARCH in PORT_ONLY and ARCH not in ARCHS
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.hd) == \
        (48, 6144, 64, 8, 128)
    assert (c.n_experts, c.topk, c.d_ff, c.dense_ff, c.vocab) == \
        (128, 8, 2048, 18432, 153600)
    assert (c.window, c.local_global_period, c.rope_theta) == \
        (128, 4, 1_000_000.0)
    assert (c.router_scoring, c.routed_scaling, c.first_dense_layers) == \
        ("sigmoid", 2.5, 1)
    # 236B in all, 23B a token (the name's)
    assert 235e9 < c.param_count() < 238e9
    assert 23e9 < c.active_param_count() < 24e9
    # dropless: every per-row buffer is wider than the row
    for cfg in (c, CFG):
        for S in (1, 7, 64, 512):
            assert M._capacity(cfg, S) > S
    with pytest.raises(ValueError, match="port's own field"):
        jax_fields(c)


def test_fields_left_unset_draw_the_leaves_as_before():
    """arctic / llama4 REDUCED: the leaves and their draw order of the JAX
    package's layout, none of the new ones."""
    for arch in ("arctic-480b", "llama4-scout-17b-a16e", "smollm-360m"):
        cfg = get_reduced(arch)
        jax_fields(cfg)
        p = build(cfg).init_params(0, "cpu")
        keys = {"ln1", "ln2", "wq", "wk", "wv", "wo"}
        keys |= ({"router", "we1", "we3", "we2", "ws1", "ws3", "ws2"}
                 if cfg.n_experts else {"w1", "w3", "w2"})
        for lp in p["layers"]:
            assert set(lp) == keys
        assert [T.layer_rope(cfg, i) for i in range(cfg.n_layers)] == \
            [True] * cfg.n_layers


def test_leaves_of_the_new_layout(raw):
    d, hd, E = CFG.d_model, CFG.hd, CFG.n_experts
    first, rest = raw["layers"][0], raw["layers"][1:]
    assert set(first) == {"wq", "wk", "wv", "wo", "w1", "w3", "w2",
                          "q_norm", "k_norm", "post_attn_norm",
                          "post_ffn_norm"}
    assert first["w1"].shape == (d, CFG.dense_ff)
    for lp in rest:
        assert set(lp) == {"wq", "wk", "wv", "wo", "router", "router_bias",
                           "we1", "we3", "we2", "ws1", "ws3", "ws2",
                           "q_norm", "k_norm", "post_attn_norm",
                           "post_ffn_norm"}
        assert lp["router_bias"].shape == (E,)
        assert lp["q_norm"].shape == lp["k_norm"].shape == (hd,)
        assert lp["ws1"].shape == (d, CFG.d_ff)


def test_route_bias_selects_and_does_not_weigh():
    g = torch.Generator().manual_seed(0)
    d, E, k = CFG.d_model, CFG.n_experts, CFG.topk
    x = torch.randn(2, 32, d, generator=g).to(torch.bfloat16)
    lp = {"router": C.dense_init(g, (d, E), scale=0.02),
          "router_bias": (torch.randn(E, generator=g) * 0.1).to(
              torch.bfloat16)}
    probs, gates, idx = M.route(x, lp, CFG, None)
    s = torch.sigmoid(M.router_logits(x, lp["router"], None).float())
    assert torch.equal(probs, s)
    assert torch.equal(idx, M.top_k(s + lp["router_bias"].float(), k)[1])
    plain = M.top_k(s, k)[1]
    moved = sum(set(a) != set(b) for a, b in
                zip(idx.reshape(-1, k).tolist(),
                    plain.reshape(-1, k).tolist()))
    assert moved > 8                      # the bias reorders choices
    chosen = s.gather(-1, idx)            # the unbiased scores weigh
    torch.testing.assert_close(gates, chosen / chosen.sum(-1, keepdim=True)
                               * 2.5, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gates.sum(-1), torch.full((2, 32), 2.5))
    # no bias: the plain top-k of the scores
    lp0 = dict(lp, router_bias=torch.zeros(E, dtype=torch.bfloat16))
    assert torch.equal(M.route(x, lp0, CFG, None)[2], plain)


def _layer(raw, i, x, cfg=CFG, rotation=None, lp=None):
    """Layer ``i`` on x (1, S, d) with flash attention and RoPE tables at
    positions 0 .. S-1."""
    S = x.shape[1]
    if rotation is None:
        rotation = C.rope_rotation(torch.arange(S)[None], cfg.hd,
                                   theta=cfg.rope_theta)
    win = T.layer_window(cfg, i)
    win = None if win == T.BIG_WINDOW else win

    def attend(q, k, v):
        return A.flash_attention(q, k, v, causal=True, window=win)
    return T.layer(x, raw["layers"][i] if lp is None else lp, cfg, None, i,
                   rotation, attend)


def _x(S=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(1, S, CFG.d_model, generator=g).to(torch.bfloat16)


def test_rope_on_windowed_layers_only(raw):
    assert [T.layer_rope(CFG, i) for i in range(5)] == \
        [True, True, True, False, True]
    assert [T.layer_window(CFG, i) for i in range(5)] == \
        [8, 8, 8, T.BIG_WINDOW, 8]
    x = _x()
    other = C.rope_rotation(torch.arange(24)[None] + 1000, CFG.hd,
                            theta=CFG.rope_theta)
    # the global layer (3) reads no positions: another table, the same
    assert torch.equal(_layer(raw, 3, x), _layer(raw, 3, x, rotation=other))
    # a windowed layer does
    assert not torch.equal(_layer(raw, 2, x),
                           _layer(raw, 2, x, rotation=other))


def test_a_query_sees_the_window_s_keys(raw):
    """Layer 0 (windowed, dense FFN): the output at p moves with the input
    at p - 7 and not with the input at p - 8."""
    x, p = _x(), 20
    y = _layer(raw, 0, x)
    for j, moves in ((p - 8, False), (p - 7, True), (p, True)):
        x2 = x.clone()
        x2[0, j] += 1.0
        y2 = _layer(raw, 0, x2)
        assert torch.equal(y2[0, p], y[0, p]) != moves, j
        assert torch.equal(y2[0, :j], y[0, :j])          # causal
    # the global layer sees every earlier key
    x2 = x.clone()
    x2[0, 0] += 1.0
    assert not torch.equal(_layer(raw, 3, x2)[0, p], _layer(raw, 3, x)[0, p])


def _scaled(lp, name, by=2.0):
    return dict(lp, **{name: (lp[name].float() * by).to(torch.bfloat16)})


@pytest.mark.parametrize("leaf", ["wq", "wk", "wo", "w2"])
def test_norms_remove_the_scale_of_what_they_normalise(raw, leaf):
    """QK norm: q (k) is normalised, so doubling wq (wk) leaves the layer as
    it was; post norms: so does doubling wo, or the FFN's w2.  With the
    norms switched off the same doubling moves the layer."""
    x, lp = _x(), raw["layers"][0]
    y, y2 = _layer(raw, 0, x), _layer(raw, 0, x, lp=_scaled(lp, leaf))
    # doubling is exact in bf16; what is left is the rounding of the
    # normalised values (a bf16 ulp here and there)
    assert (y2.float() - y.float()).abs().max() < \
        0.02 * y.float().abs().max()
    off = dataclasses.replace(CFG, qk_norm=False, post_norms=False)
    zeros = torch.zeros(CFG.d_model, dtype=torch.bfloat16)
    lp0 = dict(lp, ln1=zeros, ln2=zeros)
    z = _layer(raw, 0, x, cfg=off, lp=lp0)
    z2 = _layer(raw, 0, x, cfg=off, lp=_scaled(lp0, leaf))
    assert (z2.float() - z.float()).abs().max() > \
        0.1 * z.float().abs().max()


class HeldRouting:
    """``models.moe.route`` recording each routed layer's expert ids over
    a full sequence, or replaying them at a step's positions (gates from
    the step's own scores): near-tied bf16 scores may order two forwards'
    choices differently, which would compare routings, not layer bodies."""

    def __init__(self, monkeypatch):
        self.ids, self.calls, self.pos = [], 0, None
        self.orig = M.route
        monkeypatch.setattr(M, "route", self)

    def __call__(self, x, lp, cfg, policy):
        probs, gates, idx = self.orig(x, lp, cfg, policy)
        if self.pos is None:
            self.ids.append(idx)
            return probs, gates, idx
        layer = self.calls % len(self.ids)
        self.calls += 1
        T_ = x.shape[1]
        idx = self.ids[layer][:, self.pos:self.pos + T_]
        chosen = probs.gather(-1, idx)
        return probs, chosen / chosen.sum(-1, keepdim=True) * \
            cfg.routed_scaling, idx


def test_the_three_forwards_agree(raw, monkeypatch):
    """``decode_step`` (a chunk, then one token a step, through the paged
    pool), ``prefill`` and ``hidden_states`` run one layer body: the same
    logits (KV16, bf16 weights; the routing held to ``hidden_states``')
    within 4 % of the largest: the decode kernels' plain versions round
    the attention's probabilities to bf16 where the flash walk does not,
    and the bf16 residual carries that through five layers."""
    model = build(CFG)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, CFG.vocab, (2, 30), generator=g)
    held = HeldRouting(monkeypatch)
    h = model.hidden_states(raw, toks, policy=BF16)
    full = model.logits(raw, h).float()
    assert len(held.ids) == 4             # layer 0 is dense
    held.pos = 0
    cache = model.init_cache(BF16, 2, 32, "cpu")
    pre, _ = model.prefill(raw, BF16, toks, cache)
    scale = full.abs().max()
    assert (pre.float() - full[:, -1]).abs().max() < 4e-2 * scale
    pool = model.init_paged_cache(BF16, 2, 8, 8, 4, "cpu")
    pool.block_table.copy_(torch.arange(8, dtype=torch.int32).reshape(2, 4))
    runs0 = trace.moe_layers_run
    lg, _ = model.decode_step(raw, BF16, toks[:, :16], pool,
                              torch.zeros(2, dtype=torch.int32), max_live=32)
    assert (lg.float() - full[:, 15]).abs().max() < 4e-2 * scale
    for t in range(16, 30):
        held.pos = t
        lg, _ = model.decode_step(raw, BF16, toks[:, t:t + 1], pool,
                                  torch.full((2,), t, dtype=torch.int32),
                                  max_live=32)
        assert (lg.float() - full[:, t]).abs().max() < 4e-2 * scale, t
    # layer 0 is dense: 4 routed layers a step
    assert trace.moe_layers_run - runs0 == 4 * 15


def test_quantize_params_packs_every_weight_of_the_new_layout(raw):
    """Every 2-D weight the packing rule takes is packed (layer 0's SwiGLU
    at its own width, the shared expert, the stacks), the norms and the
    bias stay bf16, and no 2-D leaf has a name the skip list holds back."""
    pol = get_policy("w4a16kv8")
    q = quantize_params(raw, pol, "cpu")
    for lp, qp in zip(raw["layers"], q["layers"]):
        for name, w in lp.items():
            if w.dim() == 1:
                assert torch.equal(qp[name], w), name
                continue
            assert not any(name.startswith(s) for s in _SKIP_KEYS), name
            big = w.shape[-2] * w.shape[-1] >= 256 * 256
            assert isinstance(qp[name], PackedWeight) == big, name
    assert isinstance(q["layers"][0]["w1"], PackedWeight)
    assert q["layers"][0]["w1"].shape == (CFG.d_model, CFG.dense_ff)
    for name in ("we1", "we3", "we2", "ws1", "ws3", "ws2"):
        assert isinstance(q["layers"][1][name], PackedWeight), name


class FakeMesh:
    def __init__(self, shape):
        self.axis_names = TM.AXES[len(shape)]
        self.shape = dict(zip(self.axis_names, shape))


def test_sharding_has_a_spec_for_each_new_leaf(raw):
    """On a (2, 2) mesh: norms and the bias replicated, layer 0's SwiGLU
    column / row parallel as a dense model's, the stacks on their expert
    axis, the router replicated."""
    rules = ShardingRules(FakeMesh((2, 2)), CFG)
    specs = rules.params(raw)
    for lp, sp in zip(raw["layers"], specs["layers"]):
        assert set(sp) == set(lp)
        for n in ("q_norm", "k_norm", "post_attn_norm", "post_ffn_norm"):
            assert sp[n] == (None,)
    first, routed = specs["layers"][0], specs["layers"][1]
    assert first["w1"] == first["w3"] == (None, "model")
    assert first["w2"] == ("model", None)
    assert routed["router_bias"] == (None,)
    assert routed["router"] == (None, None)
    assert routed["we1"] == ("model", None, None)
    assert routed["ws1"] == (None, "model") and routed["ws2"] == ("model",
                                                                  None)
