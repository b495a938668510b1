"""Routed experts through the A16 GEMM on expert stacks in its fragment
order (``core.packing.to_kernel_layout`` of a stack, ``models.moe``).

On the CPU: a stack's fragment layout is an exact permutation of each
member's values, and a stack it cannot hold is refused; ``quantize_params``
leaves the CPU's stacks in the tile layout, whose experts take the plain
path; a fragment-order stack takes the kernel's path (on the CPU its
plain version, ``kernels.ref.mpgemm_ref``: the same bf16 products and
f32 sums as the plain path, so bit for bit).  On the card (marked
``cuda``; this file imports nothing of JAX, so ``PYTHONPATH=src python
-m pytest --noconftest -q tests/test_torch_moe_packed.py`` runs it
there) the kernel's path against the plain one (``models.moe._swiglu``
on the dequantized members) at arctic's expert widths: each product
within one bf16 ulp of the largest output (|Δ| ≤ 2^-7 · max|y|, f32 sums
in other orders, rounded once), an expert's SwiGLU within two (the first
products' ulps carried into the last), and ``moe_partial`` keeping the
same assignments, with 3 kernel launches a touched expert; a packed
stack on the card in any other layout is refused.
"""
import dataclasses

import pytest
import torch

from repro_torch import trace as T
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import packing as P
from repro_torch.core.precision import get_policy
from repro_torch.kernels import mpgemm as MG
from repro_torch.models import moe as MOE
from repro_torch.models.registry import build
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.engine import quantize_params

torch.set_num_threads(1)

EXPERTS = ("we1", "we3", "we2")


@pytest.fixture(autouse=True)
def einsum_dispatch(monkeypatch):
    monkeypatch.setattr(MOE, "_DISPATCH_IMPL", "einsum")


def _counts():
    return T.moe_experts_packed, T.moe_experts_plain, T.moe_expert_rows


def _delta(c0):
    return tuple(b - a for a, b in zip(c0, _counts()))


# -- the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["a16", "a8"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K,N,group,bk", [(256, 384, 64, 64),
                                          (352, 128, 32, 32)])
def test_stacked_kernel_layout_is_a_permutation(K, N, group, bk, bits,
                                                kernel):
    """Member by member: the fragment stack's member e is member e's own
    fragment layout, its values and dequantized bf16 are the tile
    stack's bit for bit (a group-32 K of 32 × 11 included: its last
    chunk's 32 padding rows dropped), and it lies contiguous at a 16-byte
    boundary, as the kernel takes it."""
    gen = torch.Generator().manual_seed(K + bits)
    p = P.pack_stack(torch.randn(3, K, N, generator=gen), bits=bits,
                     group=group, block_k=bk, block_n=128)
    f = P.to_kernel_layout(p, kernel)
    assert f.stacked and f.layout == P.KERNEL_LAYOUTS[kernel]
    assert f.data.shape == (3, N // 16, P.frag_chunks(K), 32, 4 * bits)
    assert f.scales is p.scales and P.to_kernel_layout(f, kernel) is f
    assert torch.equal(P.dequantize_packed(f), P.dequantize_packed(p))
    for e in range(3):
        m = f[e]
        assert torch.equal(m.data, P.to_kernel_layout(p[e], kernel).data)
        assert torch.equal(P.unpack_weight(m), P.unpack_weight(p[e]))
        assert torch.equal(P.dequantize_packed(m), P.dequantize_packed(p[e]))
        assert m.data.is_contiguous() and m.data.data_ptr() % 16 == 0
        assert m.scales.data_ptr() % 16 == 0


@pytest.mark.parametrize("K,N,group,bk,bn", [(128, 40, 64, 64, 8),
                                              (96, 128, 96, 96, 128)])
def test_stacked_kernel_layout_refuses_what_the_kernel_cannot_hold(
        K, N, group, bk, bn):
    """An N off the 16-wide blocks, a K off the 64-deep fragments at a
    group other than 32: refused, as a single weight of that shape is."""
    p = P.pack_stack(torch.randn(2, K, N), bits=4, group=group, block_k=bk,
                     block_n=bn)
    for w in (p, p[0]):
        with pytest.raises(ValueError, match="fragment layout needs"):
            P.to_kernel_layout(w, "a16")


def _reduced_layer(policy="w4a16kv8"):
    cfg = get_reduced("arctic-480b")
    raw = build(cfg).init_params(0, "cpu")
    return cfg, quantize_params(raw, get_policy(policy))["layers"][0]


@pytest.mark.parametrize("policy", ["w4a16kv8", "w4a8kv4"])
def test_quantize_params_keeps_cpu_stacks_tiled(policy):
    _, lp = _reduced_layer(policy)
    for n in EXPERTS:
        assert lp[n].stacked and lp[n].layout == "tile", n
    assert lp["wq"].layout == "tile"


def _x(cfg, B=2, S=16, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(B, S, cfg.d_model, generator=gen).bfloat16()


@pytest.mark.parametrize("impl", ["einsum", "sort", "static"])
def test_cpu_experts_take_the_plain_path_and_fragment_stacks_the_kernel_s(
        impl, monkeypatch):
    """The CPU's tile stacks count ``moe_experts_plain``; the same stacks
    in the A16 fragment order count ``moe_experts_packed`` and give the
    same output bit for bit (the kernel's CPU version is the plain
    product); both count the rows each expert computed."""
    monkeypatch.setattr(MOE, "_DISPATCH_IMPL", impl)
    cfg, lp = _reduced_layer()
    x = _x(cfg)
    c0 = _counts()
    y = MOE.moe_ffn(x, lp, cfg)
    packed, plain, rows = _delta(c0)
    assert packed == 0 and 0 < plain <= cfg.n_experts
    assert 0 < rows and (impl == "static" or rows <= x.shape[0] * x.shape[1]
                         * cfg.topk)
    frag = dict(lp, **{n: P.to_kernel_layout(lp[n], "a16") for n in EXPERTS})
    c0 = _counts()
    assert torch.equal(MOE.moe_ffn(x, frag, cfg), y)
    assert _delta(c0) == (plain, 0, rows)


def test_a_mixed_layer_takes_the_plain_path():
    """The kernel's path needs all three stacks in its order."""
    cfg, lp = _reduced_layer()
    x = _x(cfg)
    y = MOE.moe_ffn(x, lp, cfg)
    mixed = dict(lp, we2=P.to_kernel_layout(lp["we2"], "a16"))
    c0 = _counts()
    assert torch.equal(MOE.moe_ffn(x, mixed, cfg), y)
    assert _delta(c0)[0] == 0 and _delta(c0)[1] > 0


# -- the card -----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


ARCTIC = get_config("arctic-480b")
_STACKS = {}


def _arctic_stacks(bits, group, E=2):
    """Tile stacks of E experts at arctic's widths (d 7168, d_ff 4864) on
    the card, kept across cases."""
    key = (bits, group, E)
    if key not in _STACKS:
        _STACKS.clear()
        d, f = ARCTIC.d_model, ARCTIC.d_ff
        gen = torch.Generator(device="cuda").manual_seed(bits + group)
        lp = {}
        for n, (K, N) in (("we1", (d, f)), ("we3", (d, f)), ("we2", (f, d))):
            w = torch.randn((E, K, N), generator=gen, device="cuda") / K ** 0.5
            lp[n] = P.pack_stack(w.bfloat16(), bits=bits, group=group,
                                 block_k=group, block_n=128)
        _STACKS[key] = lp
    return _STACKS[key]


def _close(y, ref, ulps):
    err = (y.float() - ref.float()).abs().max().item()
    assert err <= ulps * 2.0 ** -8 * ref.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4, 8, 64])
@pytest.mark.parametrize("group", [128, 32])
@pytest.mark.parametrize("bits", [4, 8])
def test_packed_expert_ffn_matches_plain(card, bits, group, rows):
    tile = _arctic_stacks(bits, group)
    frag = {n: P.to_kernel_layout(w, "a16") for n, w in tile.items()}
    gen = torch.Generator(device="cuda").manual_seed(rows)
    xs = torch.randn(rows, ARCTIC.d_model, generator=gen,
                     device="cuda").bfloat16()
    for e in range(2):
        # each product: K 7168 × N 4864 (we1, we3), K 4864 × N 7168 (we2)
        for n in EXPERTS:
            x = xs if n != "we2" else torch.randn(
                rows, ARCTIC.d_ff, generator=gen, device="cuda").bfloat16()
            _close(MOE._expert_mm(x, frag[n], e, True),
                   MOE._expert_mm(x, tile[n], e, False), 2)
        n0, c0 = MG.mpgemm_a16.launches, _counts()
        y = MOE._expert_ffn(xs, frag, e)
        assert MG.mpgemm_a16.launches == n0 + 3
        assert _delta(c0) == (1, 0, rows)
        _close(y, MOE._swiglu(xs, [tile[n] for n in EXPERTS], e, False), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_packed_moe_partial_keeps_the_same_set(card, impl, monkeypatch):
    """8 experts at arctic's widths, top-2, capacity 1.25: the kernel's
    path computes the same experts on the same
    rows as the plain path, 3 launches an expert, and the sums agree."""
    monkeypatch.setattr(MOE, "_DISPATCH_IMPL", impl)
    E = 8
    cfg = dataclasses.replace(ARCTIC, n_experts=E)
    tile = dict(_arctic_stacks(4, 128, E))
    gen = torch.Generator(device="cuda").manual_seed(11)
    tile["router"] = (torch.randn(cfg.d_model, E, generator=gen,
                                  device="cuda") * 0.02).bfloat16()
    frag = dict(tile, **{n: P.to_kernel_layout(tile[n], "a16")
                         for n in EXPERTS})
    x = torch.randn(4, 32, cfg.d_model, generator=gen,
                    device="cuda").bfloat16()
    ran = []

    def plain(xs, lp, e):
        ran.append((e, xs.shape[0]))
        return MOE._swiglu(xs, [lp[n] for n in EXPERTS], e, False)

    with monkeypatch.context() as m:
        m.setattr(MOE, "_expert_ffn", plain)
        ref = MOE.moe_partial(x, tile, cfg)
    rows = sum(r for _, r in ran)
    n0, c0 = MG.mpgemm_a16.launches, _counts()
    y = MOE.moe_partial(x, frag, cfg)
    assert _delta(c0) == (len(ran), 0, rows) and 0 < rows <= 4 * 32 * 2
    assert MG.mpgemm_a16.launches == n0 + 3 * len(ran)
    _close(y, ref, 4)


@pytest.mark.cuda
def test_card_refuses_packed_stacks_in_another_layout(card):
    """On the card a layer whose packed stacks are not all in the A16
    fragment order raises instead of taking the plain path: tile stacks,
    and a mixed layer; bf16 stacks (training's) stay plain."""
    tile = _arctic_stacks(4, 128)
    frag = {n: P.to_kernel_layout(w, "a16") for n, w in tile.items()}
    xs = torch.ones(2, ARCTIC.d_model, device="cuda").bfloat16()
    for lp in (tile, dict(frag, we2=tile["we2"])):
        c0 = _counts()
        with pytest.raises(ValueError, match="fragment order"):
            MOE._expert_ffn(xs, lp, 0)
        assert _delta(c0) == (0, 0, 0)
    E, d, f = 2, 256, 512
    bf16 = {n: torch.randn((E,) + s, device="cuda").bfloat16() / 16
            for n, s in (("we1", (d, f)), ("we3", (d, f)), ("we2", (f, d)))}
    c0 = _counts()
    MOE._expert_ffn(xs[:, :d], bf16, 1)
    assert _delta(c0) == (0, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["w4a16kv8", "w4a8kv4"])
def test_card_engine_runs_its_experts_through_the_kernel(card, policy):
    """The card's engine lays every expert stack out for the A16 kernel
    (under A8 too: the experts take bf16 activations), and its steps run
    every routed expert there."""
    eng = Engine(EngineConfig(model=get_reduced("arctic-480b"),
                              policy=policy, device="cuda", n_slots=2,
                              max_seq=64, block_size=8, prefill_chunk=8,
                              cache_kind="paged"))
    for lp in eng.params["layers"]:
        assert all(lp[n].layout == "frag_a16" for n in EXPERTS)
        assert lp["wq"].layout == ("frag_a8" if "a8" in policy
                                   else "frag_a16")
    c0 = _counts()
    eng.generate([[5, 9, 2, 7, 1, 3, 8, 4, 6]],
                 SamplingParams(max_new_tokens=3))
    packed, plain, rows = _delta(c0)
    assert packed > 0 and plain == 0 and rows > 0
