"""The moe family in the port — ``models/moe.py`` and arctic-480b /
llama4-scout-17b-a16e REDUCED — against the JAX package, and its engine.

* Units against ``repro.models.moe`` on the same numpy inputs:
  ``_capacity`` over a grid; the stacked packer's bytes and scales
  against ``jax.vmap(pack_weight)``, bit for bit; ``moe_ffn`` (einsum and
  sort dispatch, bf16 and packed experts) within 2e-2 · max |y| (bf16
  expert matmuls summed in other orders); top-k ties to the lower index;
  the (row, choice) pairs a tight capacity drops, exactly.  Plus the
  JAX suite's own ``test_moe.py`` checks on the port.
* Teacher-forced logits of ``decode_step`` against jitted JAX
  (``attn_impl="pallas"``, GEMMs on the engine's ``impl="xla"``), both
  backends, w4a16kv8 within 2e-2 · max |logit| and w4a8kv4 within 1e-1
  (``test_torch_model``'s bars).  Routing is held too: each router call
  of JAX is read back (a debug callback on its ``router_probs``), and
  where the port's top-k differs, the port's router probabilities must
  put the two choices within a fifth of the logit bar of each other
  (4e-3 for A16, 2e-2 for A8, whose GEMM inputs are re-quantized per
  token and differ more upstream) — a near-tie that the sum-order
  differences the logit bar allows can flip (largest seen: 1.6e-4 for
  A16, 1.04e-2 for A8).  The port then takes JAX's choice (so later steps stay
  comparable) and the flip is reported as a warning; any wider
  disagreement fails.  A flip is not a near-tie in the logits: the token
  takes another expert's FFN.
* Engines: the port's paged engine with prefix caching and block growth
  against the JAX engine's streams on one scripted workload at the same
  schedule (``attn_impl="xla"`` on both: the reference's gathered-view
  route), routing held as above, up to a near-tie of the JAX engine's own
  logits at the first difference; dense ≡ paged streams bit for bit; and, with
  ``capacity_factor`` raised so no call drops a token (capacity is per
  call), chunk size, prefix caching and growth leave the streams
  unchanged.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import packing as JP
from repro.core.precision import get_policy as j_policy
from repro.models import common as JC
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.engine import quantize_params as j_quantize
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core import packing as TP
from repro_torch.core.precision import get_policy as t_policy
from repro_torch.models import common as TC
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from repro_torch.serving.engine import quantize_params as t_quantize
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

ARCHS = ["arctic-480b", "llama4-scout-17b-a16e"]
TOL, TOL_A8 = 2e-2, 1e-1
#: a routing flip is accepted where the port's router probabilities of
#: its own choice and JAX's differ by less than the logit bar times this
#: (module docstring)
FLIP_SHARE = 0.2


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _cfgs(E=4, k=2, cf=1.25, d=64, f=128):
    kw = dict(name="m", family="moe", n_layers=1, d_model=d, n_heads=4,
              n_kv_heads=2, d_ff=f, vocab=256, n_experts=E, topk=k,
              capacity_factor=cf)
    return JModelConfig(**kw), ModelConfig(**kw)


def _layer(rng, E, d, f, router_scale=0.02):
    """One moe layer's router and expert stacks, f32 numpy."""
    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    return {"router": (rng.standard_normal((d, E)) * router_scale).astype(
        np.float32), "we1": w(E, d, f), "we3": w(E, d, f), "we2": w(E, f, d)}


def _both(lp):
    """The same layer as JAX arrays and torch tensors (bf16)."""
    jl = {k: jnp.asarray(v, jnp.bfloat16) for k, v in lp.items()}
    return jl, {k: _t(v) for k, v in jl.items()}


# ---------------------------------------------------------------------------
# Units
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.1, 1.0, 1.25, 4.0])
def test_capacity_matches_jax(cf):
    for T in (1, 3, 8, 32, 100, 512):
        for E in (1, 4, 16, 128):
            for k in (1, 2):
                cj, ct = _cfgs(E=E, k=k, cf=cf)
                assert TMOE._capacity(ct, T) == JMOE._capacity(cj, T)


@pytest.mark.parametrize("bits,group,bk,bn", [
    (4, 64, 64, 128), (8, 64, 64, 128), (4, 128, 128, 64),
    (8, 32, 32, 96)])
def test_stacked_packer_equals_jax_vmap(bits, group, bk, bn):
    rng = np.random.default_rng(bits + group)
    w = rng.standard_normal((3, 256, 384)).astype(np.float32)
    pj = jax.vmap(lambda m: JP.pack_weight(m, bits=bits, group=group,
                                           block_k=bk, block_n=bn))(
        jnp.asarray(w))
    pt = TP.pack_stack(torch.from_numpy(w), bits=bits, group=group,
                       block_k=bk, block_n=bn)
    assert pt.stacked and pt.n_members == 3 and pt.shape == (256, 384)
    np.testing.assert_array_equal(pt.data.numpy(), np.asarray(pj.data))
    np.testing.assert_array_equal(pt.scales.numpy(), np.asarray(pj.scales))
    deq_j = np.asarray(JMOE._expert_weights(pj), np.float32)
    np.testing.assert_array_equal(_np(TMOE._expert_weights(pt)), deq_j)
    np.testing.assert_array_equal(_np(TMOE._expert(pt, 2)), deq_j[2])
    # the engine's packer: a REDUCED arctic layer's experts, as JAX's
    # quantize_params packs its (L, E, K, N) stack
    pol_j, pol_t = j_policy("w4a16kv8"), t_policy("w4a16kv8")
    stack = rng.standard_normal((2, 4, 256, 512)).astype(np.float32)
    qj = j_quantize({"we1": jnp.asarray(stack, jnp.bfloat16)}, pol_j)["we1"]
    qt = TC.maybe_quantize(_t(np.asarray(jnp.asarray(stack, jnp.bfloat16))
                              )[1], pol_t)
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(qj.data)[1])
    np.testing.assert_array_equal(qt.scales.numpy(),
                                  np.asarray(qj.scales)[1])


def test_stacks_are_not_gemm_operands():
    """A stack in either layout is refused as a GEMM operand; its
    fragment layout is laid out member by member (``models.moe`` hands
    the kernel a member)."""
    pt = TP.pack_stack(torch.randn(2, 128, 128), bits=4, group=64,
                       block_k=64, block_n=128)
    ft = TP.to_kernel_layout(pt, "a16")
    for w in (pt, ft):
        with pytest.raises(ValueError, match="stack"):
            TC.linear(torch.randn(3, 128).bfloat16(), w,
                      t_policy("w4a16kv8"))
    assert ft.stacked and ft.layout == "frag_a16"
    assert torch.equal(ft[1].data, TP.to_kernel_layout(pt[1], "a16").data)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("impl", ["einsum", "sort"])
def test_moe_ffn_matches_jax(impl, k, packed):
    """B 3, S 16, E 4, capacity factor 1.25 (einsum drops some tokens at
    this S), bf16 or w4 packed experts."""
    cj, ct = _cfgs(k=k)
    rng = np.random.default_rng(k)
    jl, tl = _both(_layer(rng, 4, 64, 128, router_scale=0.5))
    if packed:
        pol_j, pol_t = j_policy("w4a16kv8"), t_policy("w4a16kv8")
        for name in ("we1", "we3", "we2"):
            jl[name] = JC.maybe_quantize(jl[name], pol_j, min_size=0)
            tl[name] = TC.maybe_quantize(tl[name], pol_t, min_size=0)
            assert tl[name].stacked
    x = jnp.asarray(rng.standard_normal((3, 16, 64)), jnp.bfloat16)
    JMOE.set_dispatch_impl(impl)
    TMOE.set_dispatch_impl(impl)
    yj = np.asarray(jax.jit(lambda x, lp: JMOE.moe_ffn(x, lp, cj))(x, jl),
                    np.float32)
    yt = TMOE.moe_ffn(_t(x), tl, ct)
    assert yt.dtype == torch.bfloat16 and yt.shape == (3, 16, 64)
    assert np.abs(_np(yt) - yj).max() <= 2e-2 * np.abs(yj).max()


def test_top_k_ties_go_to_the_lower_index():
    rng = np.random.default_rng(3)
    p = rng.integers(0, 3, (64, 6)).astype(np.float32) / 4
    for k in (1, 2, 3):
        vj, ij = jax.lax.top_k(jnp.asarray(p), k)
        vt, it = TMOE.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # through the router: columns 1 and 3 equal and 0 and 2 zero tie
    # every token's two choices, (1, 3) or (0, 2), lower index first
    cj, ct = _cfgs(k=2)
    lp = _layer(rng, 4, 64, 128)
    lp["router"][:, 3] = lp["router"][:, 1]
    lp["router"][:, [0, 2]] = 0
    x = jnp.asarray(rng.standard_normal((2, 8, 64)), jnp.bfloat16)
    jl, tl = _both(lp)
    probs, gates, idx = TMOE.route(_t(x), tl, ct, None)
    pj = JMOE.router_probs(x, jl["router"], None, "xla")
    _, ij = jax.lax.top_k(pj, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ij))
    pairs = {tuple(p) for p in idx.reshape(-1, 2).tolist()}
    assert pairs <= {(1, 3), (0, 2)} and len(pairs) == 2


def _kept_experts(y, E, block):
    """(B, S, E) bool: expert e's output block of a row is nonzero."""
    return np.abs(y.reshape(y.shape[:2] + (E, block))).max(-1) > 0


@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("k", [1, 2])
def test_capacity_overflow_drops_the_same_pairs(k, impl):
    """Capacity factor 0.5: each expert's output lands in its own 16-wide
    block of d, so the nonzero blocks of a row are exactly the
    (row, choice) pairs its experts kept; both packages must keep the
    same ones (and drop some)."""
    E, d, f, block = 4, 64, 128, 16
    cj, ct = _cfgs(k=k, cf=0.5)
    rng = np.random.default_rng(10 + k)
    lp = _layer(rng, E, d, f, router_scale=0.5)
    for e in range(E):
        mask = np.zeros(d, np.float32)
        mask[e * block:(e + 1) * block] = 1
        lp["we2"][e] *= mask
    jl, tl = _both(lp)
    x = jnp.asarray(rng.standard_normal((2, 24, d)), jnp.bfloat16)
    JMOE.set_dispatch_impl(impl)
    TMOE.set_dispatch_impl(impl)
    yj = np.asarray(JMOE.moe_ffn(x, jl, cj), np.float32)
    yt = _np(TMOE.moe_ffn(_t(x), tl, ct))
    kj, kt = _kept_experts(yj, E, block), _kept_experts(yt, E, block)
    np.testing.assert_array_equal(kt, kj)
    assert kt.sum() < 2 * 24 * k, "nothing dropped: proves nothing"
    assert np.abs(yt - yj).max() <= 2e-2 * np.abs(yj).max()


# -- the JAX suite's test_moe.py, on the port ------------------------------


def _small(cf=4.0):
    cj, ct = _cfgs(k=2, cf=cf)
    rng = np.random.default_rng(0)
    jl, tl = _both(_layer(rng, 4, 64, 128))
    return ct, tl, rng


def test_dispatch_impls_agree():
    ct, tl, rng = _small()
    x = torch.from_numpy(rng.standard_normal((2, 16, 64))).bfloat16()
    y_e = TMOE.moe_ffn(x, tl, ct)
    TMOE.set_dispatch_impl("sort")
    y_s = TMOE.moe_ffn(x, tl, ct)
    np.testing.assert_allclose(_np(y_e), _np(y_s), rtol=0.06, atol=0.03)


def test_capacity_drops_overflow():
    ct, tl, rng = _small()
    x = torch.from_numpy(rng.standard_normal((2, 32, 64))).bfloat16()
    TMOE.set_dispatch_impl("sort")
    y = TMOE.moe_ffn(x, tl, dataclasses.replace(ct, capacity_factor=0.1))
    TMOE.set_dispatch_impl("einsum")
    assert torch.isfinite(y.float()).all()
    assert y.float().norm() <= TMOE.moe_ffn(x, tl, ct).float().norm() * 1.05


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(5)
    probs = np.array(jax.nn.softmax(jnp.asarray(rng.standard_normal(
        (2, 16, 4)), jnp.float32), -1))
    idx = np.argsort(-probs, -1)[..., :2]
    lj = float(JMOE.load_balance_loss(jnp.asarray(probs), jnp.asarray(idx),
                                      4))
    lt = float(TMOE.load_balance_loss(torch.from_numpy(probs),
                                      torch.from_numpy(idx), 4))
    assert lt >= 0.99 and abs(lt - lj) <= 1e-6


def test_single_expert_equals_dense():
    """E=1, top-1 MoE ≡ plain SwiGLU through the same weights."""
    _, ct = _cfgs(E=1, k=1, cf=8.0)
    rng = np.random.default_rng(6)
    _, tl = _both(_layer(rng, 1, 64, 128))
    x = torch.from_numpy(rng.standard_normal((1, 8, 64))).bfloat16()
    y = TMOE.moe_ffn(x, tl, ct)
    dense = TC.swiglu(x, {"w1": tl["we1"][0], "w3": tl["we3"][0],
                          "w2": tl["we2"][0]})
    np.testing.assert_allclose(_np(y), _np(dense), rtol=0.05, atol=0.03)


def test_dispatch_impl_names():
    with pytest.raises(ValueError, match="dispatch"):
        TMOE.set_dispatch_impl("dense")


# ---------------------------------------------------------------------------
# The models against jitted JAX, routing held
# ---------------------------------------------------------------------------


class RoutingLock:
    """JAX's routing read back, the port held to it up to a near-tie of
    the port's router probabilities (``eps``).  ``strict``: a wider
    difference fails; otherwise the port keeps its own choice there and
    the difference is counted in ``wide`` (an engine's slot whose stream
    already took another token routes other tokens)."""

    def __init__(self, monkeypatch, eps, strict=True):
        self.eps, self.strict = eps, strict
        self.jax_probs, self.flips, self.wide = [], [], 0
        orig_probs, orig_top_k = JMOE.router_probs, TMOE.top_k

        def jax_probs(x, router_w, policy, impl):
            probs = orig_probs(x, router_w, policy, impl)
            jax.debug.callback(lambda p: self.jax_probs.append(
                np.asarray(p, np.float32)), probs, ordered=True)
            return probs

        def port_top_k(probs, k):
            vals, idx = orig_top_k(probs, k)
            pj = self.jax_probs.pop(0)
            ij = np.argsort(-pj, axis=-1, kind="stable")[..., :k]
            it = idx.numpy()
            p = probs.float().numpy()
            gap = (np.take_along_axis(p, it, -1) -
                   np.take_along_axis(p, ij, -1)).max(-1)
            diff = (ij != it).any(-1)
            near = diff & (gap < eps)
            wide = diff & ~near
            assert not (self.strict and wide.any()), (
                f"routing differs from JAX's beyond a near-tie: the port's "
                f"probabilities put its choice {gap[wide].max()} above "
                f"JAX's (eps {eps})")
            self.wide += int(wide.sum())
            if not near.any():
                return vals, idx
            self.flips.append(float(gap[near].max()))
            idx_j = torch.from_numpy(np.where(near[..., None], ij, it))
            return torch.gather(probs, -1, idx_j), idx_j

        monkeypatch.setattr(JMOE, "router_probs", jax_probs)
        monkeypatch.setattr(TMOE, "top_k", port_top_k)

    def report(self, what):
        if self.flips:
            warnings.warn(f"{what}: {len(self.flips)} router call(s) took "
                          f"JAX's choice at a near-tie (largest gap "
                          f"{max(self.flips):.2e} < {self.eps})")


N_SLOTS, N_BLOCKS, BS, BPS = 2, 16, 8, 7


def _step_fn():
    """A freshly traced jitted JAX decode_step (the router callback must
    be in its trace)."""
    def step(*a, **k):
        return JT.decode_step(*a, **k)
    return jax.jit(step, static_argnums=(1, 2), static_argnames=(
        "impl", "attn_impl", "attn_block_s", "max_live"))


@pytest.mark.parametrize("policy,kind", [
    ("w4a16kv8", "dense"), ("w4a16kv8", "paged"), ("w4a8kv4", "dense"),
    ("w4a8kv4", "paged")])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_jax(arch, policy, kind, monkeypatch):
    """Five 8-token chunks (slot 1 ragged in the last), then four
    single-token steps, on two slots."""
    cfg_j, cfg_t = j_reduced(arch), get_reduced(arch)
    pol_j, pol_t = j_policy(policy), t_policy(policy)
    tol = TOL_A8 if pol_t.int8_matmul else TOL
    lock = RoutingLock(monkeypatch, FLIP_SHARE * tol)
    raw_j = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    params_j = j_quantize(raw_j, pol_j)
    params_t = t_quantize(params_from_jax(jax.device_get(raw_j), cfg_t,
                                          device="cpu"), pol_t)
    assert params_t["layers"][0]["we1"].stacked
    rng = np.random.default_rng(1)
    if kind == "paged":
        tbl = rng.permutation(N_BLOCKS)[:N_SLOTS * BPS].reshape(
            N_SLOTS, BPS).astype(np.int32)
        cache_j = JT.init_paged_cache(cfg_j, pol_j, N_SLOTS, N_BLOCKS, BS,
                                      BPS)
        cache_j = dataclasses.replace(cache_j, block_table=jnp.broadcast_to(
            jnp.asarray(tbl), cache_j.block_table.shape))
        cache_t = TT.init_paged_cache(cfg_t, pol_t, N_SLOTS, N_BLOCKS, BS,
                                      BPS, device="cpu")
        cache_t.block_table.copy_(torch.from_numpy(tbl))
    else:
        cache_j = JT.init_cache(cfg_j, pol_j, N_SLOTS, BPS * BS)
        cache_t = TT.init_cache(cfg_t, pol_t, N_SLOTS, BPS * BS,
                                device="cpu")
    step_j = _step_fn()
    stream = rng.integers(1, cfg_t.vocab, (N_SLOTS, 48)).astype(np.int32)
    nxt = np.zeros(N_SLOTS, np.int32)
    for valid in [[8, 8]] * 4 + [[8, 6]] + [[1, 1]] * 4:
        valid = np.array(valid, np.int32)
        T = int(valid.max())
        toks = np.stack([stream[b, nxt[b]:nxt[b] + T] for b in range(2)])
        if kind == "paged":                 # the engine's live bound
            nb = -(-(int(nxt.max()) + 1) // BS)
            kw = dict(max_live=min(1 << (nb - 1).bit_length(), BPS) * BS)
        else:
            kw = dict(attn_block_s=BS)
        lj, cache_j = step_j(params_j, cfg_j, pol_j, jnp.asarray(toks),
                             cache_j, jnp.asarray(nxt), attn_impl="pallas",
                             valid=jnp.asarray(valid), **kw)
        lj = np.asarray(jax.device_get(lj), np.float32)
        assert len(lock.jax_probs) == cfg_t.n_layers
        lt, cache_t = TT.decode_step(params_t, cfg_t, pol_t,
                                     torch.from_numpy(toks), cache_t,
                                     torch.from_numpy(nxt),
                                     valid=torch.from_numpy(valid), **kw)
        assert not lock.jax_probs
        lt = _np(lt)
        assert lt.shape == lj.shape == (N_SLOTS, cfg_t.vocab)
        assert np.isfinite(lt).all()
        scale = np.abs(lj).max()
        assert np.abs(lt - lj).max() <= tol * scale
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > tol * scale
        np.testing.assert_array_equal(lt.argmax(-1)[clear],
                                      lj.argmax(-1)[clear])
        nxt = nxt + valid
    lock.report(f"{arch} {policy} {kind}")


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

#: a scripted workload on a pool of 4-token blocks: a shared 8-token
#: system prompt (prefix hits), ragged tails, lengths that make block
#: growth on 8 or 12 blocks preempt
SYSP = [7, 7, 7, 7, 3, 1, 4, 1]
WORKLOAD = [(SYSP + [5, 9], 10), (SYSP + [9], 8), ([2, 3, 4, 5, 6], 9),
            (SYSP + [9, 8, 7, 6], 6), (SYSP, 7), ([1] * 6, 8)]
ENGINE_KW = dict(policy="w4a16kv8", n_slots=3, max_seq=32, max_prompt=16,
                 seed=0, cache_kind="paged", block_size=4, prefill_chunk=4)


def _record(decode_step, log, to_np):
    """decode_step that appends each step's logits to ``log``."""
    def step(*a, **k):
        logits, cache = decode_step(*a, **k)
        to_np(logits, log)
        return logits, cache
    return step


def _run(eng, SP, log):
    """Drive the workload; returns per request its stream and, per
    emitted token, the logits row it was sampled from."""
    rids = [eng.submit(p, SP(max_new_tokens=n)) for p, n in WORKLOAD]
    reqs, rows, final = {}, {r: [] for r in rids}, {}
    for _ in range(1000):
        if eng.scheduler.idle:
            break
        reqs.update(eng._requests)
        n0 = len(log)
        outs = eng.step()
        if not outs:
            continue
        assert len(log) == n0 + 1
        for o in outs:
            rows[o.rid].append(log[-1][reqs[o.rid].slot])
            if o.finished:
                final[o.rid] = o
    return [(final[r].output_token_ids, rows[r], final[r]) for r in rids]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax_engine(arch, monkeypatch):
    """The paged engine with prefix caching and growth on an 8-block pool
    and 16-token chunks (preemptions, prefix hits and capacity drops
    happen): the host decisions equal the JAX engine's; each stream is
    JAX's up to a near-tie — where the two first differ, the port's token
    sits within 2e-2 · max |logit| of JAX's own choice in the logits JAX
    sampled it from (after it the contexts differ and the streams are not
    compared)."""
    cfg_j, cfg_t = j_reduced(arch), get_reduced(arch)
    lock = RoutingLock(monkeypatch, FLIP_SHARE * TOL, strict=False)
    drops = _count_drops(monkeypatch)
    kw = dict(ENGINE_KW, attn_impl="xla", n_blocks=8, prefill_chunk=16,
              enable_prefix_caching=True, enable_block_growth=True)
    raw_j = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    eng_j = JEngine(JEngineConfig(model=cfg_j, **kw), params=raw_j)
    eng_t = Engine(EngineConfig(model=cfg_t, device="cpu", **kw),
                   params=params_from_jax(jax.device_get(raw_j), cfg_t,
                                          device="cpu"))
    log_j, log_t = [], []
    eng_j.model = dataclasses.replace(eng_j.model, decode_step=_record(
        eng_j.model.decode_step, log_j, lambda l, log: jax.debug.callback(
            lambda v: log.append(np.asarray(v, np.float32)), l,
            ordered=True)))
    eng_t.model = dataclasses.replace(eng_t.model, decode_step=_record(
        eng_t.model.decode_step, log_t, lambda l, log: log.append(_np(l))))
    got_j = _run(eng_j, JSamplingParams, log_j)
    got_t = _run(eng_t, SamplingParams, log_t)
    assert not lock.jax_probs            # one port router call per JAX's
    lock.report(f"{arch} engine")
    same = 0
    for (sj, rows_j, oj), (st, _, ot) in zip(got_j, got_t):
        assert (ot.cached_tokens, ot.num_preemptions, ot.replay_iterations,
                len(st)) == (oj.cached_tokens, oj.num_preemptions,
                             oj.replay_iterations, len(sj))
        if st == sj:
            same += 1
            continue
        i = next(i for i, (a, b) in enumerate(zip(sj, st)) if a != b)
        lg = rows_j[i]
        assert lg.argmax() == sj[i]
        assert lg[sj[i]] - lg[st[i]] <= TOL * np.abs(lg).max(), i
    assert sum(o.num_preemptions for _, _, o in got_t) > 0
    assert sum(o.cached_tokens for _, _, o in got_t) > 0
    assert drops[0] > 0
    assert same >= len(WORKLOAD) // 2
    # routing beyond a near-tie differs only where a stream already did
    assert lock.wide == 0 or same < len(WORKLOAD)


def _streams(cfg, **kw):
    eng = Engine(EngineConfig(model=cfg, device="cpu",
                              **dict(ENGINE_KW, **kw)))
    rids = [eng.submit(p, SamplingParams(max_new_tokens=n))
            for p, n in WORKLOAD]
    final = {o.rid: o for o in eng.run_until_idle()}
    return [final[r].output_token_ids for r in rids], [final[r] for r in rids]


def _count_drops(monkeypatch):
    """[dropped, routed] assignments of every einsum dispatch from here
    on."""
    seen, orig = [0, 0], TMOE.dispatch_einsum

    def count(gate_idx, E, cap):
        keep = orig(gate_idx, E, cap)
        seen[0] += int((~keep).sum())
        seen[1] += keep.numel()
        return keep

    monkeypatch.setattr(TMOE, "dispatch_einsum", count)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_and_paged_streams_identical(arch, monkeypatch):
    """Default capacity and 16-token chunks, where prompt chunks drop
    tokens: both backends make the same calls, so the same tokens drop
    and the streams are equal."""
    cfg = get_reduced(arch)
    drops = _count_drops(monkeypatch)
    dense, _ = _streams(cfg, cache_kind="dense", prefill_chunk=16)
    assert drops[0] > 0, "nothing dropped: proves nothing"
    paged, _ = _streams(cfg, prefill_chunk=16)
    assert dense == paged


@pytest.mark.parametrize("arch", ARCHS)
def test_invariants_hold_where_nothing_drops(arch):
    """capacity_factor 64: no call drops a token, so the prompt's chunking
    (chunk 4 against 8 and against one token a step), prefix caching and
    growth with preemption leave every stream unchanged."""
    cfg = dataclasses.replace(get_reduced(arch), capacity_factor=64.0)
    base, _ = _streams(cfg)
    assert _streams(cfg, prefill_chunk=8)[0] == base
    assert _streams(cfg, prefill_chunk=1)[0] == base
    cached, outs = _streams(cfg, enable_prefix_caching=True)
    assert cached == base and sum(o.cached_tokens for o in outs) > 0
    grown, outs = _streams(cfg, enable_block_growth=True, n_blocks=12,
                           enable_prefix_caching=True)
    assert grown == base and sum(o.num_preemptions for o in outs) > 0


def test_full_configs_match_assignment():
    """layers, d_model, heads, KV heads, d_ff, vocab, experts, top-k."""
    spec = {"arctic-480b": (35, 7168, 56, 8, 4864, 32000, 128, 2),
            "llama4-scout-17b-a16e": (48, 5120, 40, 8, 8192, 202048, 16, 1)}
    for arch, want in spec.items():
        c = get_config(arch)
        assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
                c.vocab, c.n_experts, c.topk) == want
    assert get_config("arctic-480b").moe_dense_residual
    assert get_config("llama4-scout-17b-a16e").shared_expert


def test_full_width_packing_plan():
    """What the card packs at full width: the routers (arctic's 7168 x
    128 packs as 64 x 128 tiles; llama4's 16-wide one stays bf16) and
    K % 64 == 0 for every packed 2-D weight."""
    assert TC.pick_blocks(7168, 128) == (64, 128)
    assert TC.pick_blocks(5120, 16)[1] is None
    for arch in ARCHS:
        c = get_config(arch)
        for K in (c.d_model, c.d_ff, c.n_heads * c.hd):
            assert K % 64 == 0
