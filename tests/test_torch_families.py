"""The one-shot-prefill families in the port — recurrentgemma-2b (hybrid)
and whisper-tiny (audio), REDUCED — against the JAX package, and their
serving engine.

* Logits: ``prefill`` of a 6-token prompt, then three teacher-forced
  ``decode_step`` calls at per-slot positions, on two slots; JAX jitted
  (its XLA flash walk and fused decode attention, GEMMs on the engine's
  ``impl="xla"`` path), the port on the CPU (plain versions), from the same
  parameters carried across by ``params_from_jax`` and packed by each
  package's own packer.  Tolerance 2e-2 · max |logit| per step (whisper),
  and top-1 agreement wherever JAX's top-2 margin exceeds it, under
  w16a16kv16 and w4a16kv8.  recurrentgemma needs more: 3e-2, against a
  measured 2.15e-2 (w16a16kv16) and 2.1e-2 (w4a16kv8).  Not the scan —
  the port's RG-LRU (conv, gates, log-depth scan with XLA's fused
  multiply-add combine) is bit for bit with jitted JAX on the same inputs
  (``test_rglru_pieces_bit_for_bit``) — but XLA's excess precision: the
  jitted layer body keeps some bf16 intermediates in f32 (the conv output
  feeding the LRU's input term, h before the gate), which the source
  rounds and the port rounds as the source says.  Dropping the port's
  rounding of h alone takes the first step from 2.0e-2 to 1.5e-2.
* The port's own prefill ≡ prefill + decode (JAX's ``test_consistency``):
  prefill(t0..t6) then decode(t7) against prefill(t0..t7), normalized
  logits within JAX's TOLS (0.06 for the hybrid's scan-vs-sequential
  recurrence).
* Engine (one-shot path, CPU): greedy streams equal the teacher-forced
  argmax of the same steps; the slot splice writes one slot's extent and
  leaves the other slots bit for bit; a request served after another in
  the same slot streams as if served alone; paged is rejected for both
  families; ``rwkv6-7b`` (the ssm family, ``tests/test_torch_rwkv6.py``)
  builds and serves through the same one-shot path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_reduced as j_reduced
from repro.core.precision import get_policy as j_policy
from repro.models import encdec as JED
from repro.models import rglru as JG
from repro.serving.engine import quantize_params as j_quantize
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core.precision import get_policy as t_policy
from repro_torch.models import rglru as TG
from repro_torch.models.registry import build
from repro_torch.serving import (Engine, EngineConfig, EngineError,
                                 SamplingParams)
from repro_torch.core.paged_kvcache import cache_leaves
from repro_torch.serving.engine import _slot_insert
from repro_torch.serving.engine import quantize_params as t_quantize
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

TOL = 2e-2
#: recurrentgemma's bar against jitted JAX (module docstring)
TOL_HYBRID = 3e-2
FAMS = ["recurrentgemma-2b", "whisper-tiny"]
JAX_MODULES = {"recurrentgemma-2b": JG, "whisper-tiny": JED}
#: JAX's prefill ≡ prefill + decode tolerances (tests/test_consistency.py)
TOLS = {"w16a16kv16": 0.03, "w4a16kv8": 0.35}


@pytest.fixture(scope="module", params=FAMS)
def raw(request):
    arch = request.param
    cfg_j, cfg_t = j_reduced(arch), t_reduced(arch)
    raw_j = JAX_MODULES[arch].init_params(cfg_j, jax.random.PRNGKey(0))
    extra = {}
    if cfg_t.family == "audio":
        rng = np.random.default_rng(9)
        extra["frames"] = rng.standard_normal(
            (2, cfg_t.enc_seq, cfg_t.d_model)).astype(np.float32)
    return arch, cfg_j, cfg_t, raw_j, jax.device_get(raw_j), extra


def _np(x):
    return to_tensor(np.asarray(x), "cpu").float().numpy()


def _close(lt, lj, tol):
    """Port logits within tol · max |logit| of JAX's, top-1 equal where
    JAX's margin is clear."""
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    scale = np.abs(lj).max()
    err = np.abs(lt - lj).max()
    assert err <= tol * scale, (err, scale)
    top2 = np.sort(lj, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > tol * scale
    np.testing.assert_array_equal(lt.argmax(-1)[clear], lj.argmax(-1)[clear])


@pytest.mark.parametrize("policy", ["w16a16kv16", "w4a16kv8"])
def test_prefill_and_decode_logits_match_jax(raw, policy):
    arch, cfg_j, cfg_t, raw_j, raw_np, extra = raw
    JM = JAX_MODULES[arch]
    pol_j, pol_t = j_policy(policy), t_policy(policy)
    params_j = j_quantize(raw_j, pol_j)
    params_t = t_quantize(params_from_jax(raw_np, cfg_t, device="cpu"),
                          pol_t)
    model = build(cfg_t)
    tol = TOL_HYBRID if cfg_t.family == "hybrid" else TOL
    ex_j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in extra.items()}
    ex_t = {k: to_tensor(np.asarray(v), "cpu") for k, v in ex_j.items()}
    rng = np.random.default_rng(1)
    stream = rng.integers(1, cfg_t.vocab, (2, 9)).astype(np.int32)
    S = 16
    prefill_j = jax.jit(JM.prefill, static_argnames=("cfg", "policy"))
    step_j = jax.jit(JM.decode_step, static_argnames=("cfg", "policy"))

    lj, cache_j = prefill_j(params_j, cfg_j, pol_j, jnp.asarray(stream[:, :6]),
                            JM.init_cache(cfg_j, pol_j, 2, S), **ex_j)
    lt, cache_t = model.prefill(params_t, pol_t,
                                torch.from_numpy(stream[:, :6]),
                                model.init_cache(pol_t, 2, S, "cpu"), **ex_t)
    _close(lt.float().numpy(), _np(lj), tol)
    for p in range(6, 9):
        pos = np.array([p, p], np.int32)
        lj, cache_j = step_j(params_j, cfg_j, pol_j,
                             jnp.asarray(stream[:, p:p + 1]), cache_j,
                             jnp.asarray(pos))
        lt, cache_t = model.decode_step(params_t, pol_t,
                                        torch.from_numpy(stream[:, p:p + 1]),
                                        cache_t, torch.from_numpy(pos))
        _close(lt.float().numpy(), _np(lj), tol)


@pytest.mark.parametrize("policy", ["w16a16kv16", "w4a16kv8"])
def test_prefill_matches_prefill_then_decode(raw, policy):
    arch, _, cfg_t, _, _, extra = raw
    model = build(cfg_t)
    pol = t_policy(policy)
    params = t_quantize(model.init_params(0, "cpu"), pol)
    ex = {k: torch.from_numpy(v[:1]).to(torch.bfloat16)
          for k, v in extra.items()}
    toks = torch.randint(1, cfg_t.vocab, (1, 8),
                         generator=torch.Generator().manual_seed(2))
    full, _ = model.prefill(params, pol, toks,
                            model.init_cache(pol, 1, 16, "cpu"), **ex)
    _, cache = model.prefill(params, pol, toks[:, :7],
                             model.init_cache(pol, 1, 16, "cpu"), **ex)
    inc, _ = model.decode_step(params, pol, toks[:, 7:8], cache, 7)
    a = full.float().numpy()
    b = inc.float().numpy()
    a, b = a - a.max(-1, keepdims=True), b - b.max(-1, keepdims=True)
    tol = TOLS[policy]
    if cfg_t.family == "hybrid":
        tol = max(tol, 0.06)
    assert np.abs(a - b).max() < tol
    ia, ib = int(a.argmax()), int(b.argmax())
    assert ia == ib or abs(a[0, ia] - a[0, ib]) < tol


def test_rglru_pieces_bit_for_bit():
    """The causal conv and the whole RG-LRU (gates, log-depth scan, final
    state) equal jitted JAX's bit for bit on the same bf16 inputs."""
    cfg_j, cfg_t = j_reduced("recurrentgemma-2b"), \
        t_reduced("recurrentgemma-2b")
    raw_j = JG.init_params(cfg_j, jax.random.PRNGKey(1))
    lp_j = jax.tree.map(lambda a: a[0], raw_j["rec1"])
    lp_t = params_from_jax(jax.device_get(raw_j), cfg_t, "cpu")["rec1"][0]
    rng = np.random.default_rng(6)
    W = cfg_t.lru_width
    x = jnp.asarray(rng.standard_normal((2, 13, W)), jnp.bfloat16)
    tail = jnp.asarray(rng.standard_normal((2, 3, W)), jnp.bfloat16)
    h0 = jnp.asarray(rng.standard_normal((2, W)), jnp.float32)
    t = lambda a: to_tensor(np.asarray(a), "cpu")       # noqa: E731
    yj, tj = jax.jit(JG._causal_conv_seq)(x, lp_j["conv_w"], tail)
    yt, tt = TG._causal_conv_seq(t(x), lp_t["conv_w"], t(tail))
    assert torch.equal(yt, t(yj)) and torch.equal(tt, t(tj))
    yj, hj = jax.jit(lambda y: JG._rglru_seq(y, lp_j, None, "xla", h0))(yj)
    yt, ht = TG._rglru_seq(yt, lp_t, None, t(h0))
    assert torch.equal(yt, t(yj)) and torch.equal(ht, t(hj))


def test_params_from_jax_keeps_every_leaf(raw):
    """Every JAX leaf arrives, per layer, with its dtype (the hybrid's f32
    Λ included)."""
    arch, _, cfg_t, _, raw_np, _ = raw
    pt = params_from_jax(raw_np, cfg_t, device="cpu")
    flat_j = jax.tree_util.tree_leaves(raw_np)
    n_t = sum(1 for _ in _tensors(pt))
    stacks = {"rec1", "rec2", "attn", "trail", "encoder", "decoder"}
    n_j = sum(np.asarray(x).shape[0] if k in stacks else 1
              for k, sub in raw_np.items()
              for x in jax.tree_util.tree_leaves(sub))
    assert n_t == n_j and len(flat_j) > 0
    if cfg_t.family == "hybrid":
        assert pt["rec1"][0]["lam"].dtype == torch.float32
        assert len(pt["trail"]) == 0 or "wa" in pt["trail"][0]
    else:
        assert set(pt["decoder"][0]) >= {"xwq", "xwk", "xwv", "xwo", "lnx"}


def _tensors(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, list):
        for v in node:
            yield from _tensors(v)
    else:
        yield node


# ---------------------------------------------------------------------------
# Engine: the one-shot path
# ---------------------------------------------------------------------------


def _kw(arch, **kw):
    return dict(dict(model=t_reduced(arch), n_slots=2, max_seq=32,
                     device="cpu", prefill_chunk=4), **kw)


@pytest.fixture(scope="module", params=FAMS)
def engine(request):
    return Engine(EngineConfig(**_kw(request.param)))


def _teacher_forced(eng, prompts, n_new):
    """Greedy continuation of equal-length prompts with the engine's step
    shapes: each prompt minus its last token prefilled into a B=1 cache and
    spliced into its slot, then lockstep single-token decode steps."""
    n = len(prompts[0])
    cache = eng.model.init_cache(eng.policy, eng.n_slots, eng.max_seq, "cpu")
    for b, p in enumerate(prompts):
        c1 = eng.model.init_cache(eng.policy, 1, eng.max_seq, "cpu")
        _, c1 = eng.model.prefill(eng.params, eng.policy,
                                  torch.tensor([p[:n - 1]]), c1, **eng._extra)
        _slot_insert(cache, c1, b)
    toks = [p[-1] for p in prompts]
    out = [[] for _ in prompts]
    for i in range(n_new):
        logits, cache = eng.model.decode_step(
            eng.params, eng.policy, torch.tensor(toks)[:, None], cache,
            torch.full((len(prompts),), n - 1 + i, dtype=torch.int32))
        toks = logits.float().argmax(-1).tolist()
        for b, t in enumerate(toks):
            out[b].append(t)
    return out


def test_greedy_streams_equal_teacher_forced_argmax(engine):
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, engine.model_cfg.vocab, (2, 7)).tolist()
    outs = engine.generate(prompts, SamplingParams(max_new_tokens=5))
    assert [o.output_token_ids for o in outs] == \
        _teacher_forced(engine, prompts, 5)


def test_slot_reuse_streams_as_if_alone(engine):
    """A request whose slot held another request's state (a longer prompt,
    then a single-token prompt, which resets instead of prefilling) gives
    the stream it gives on a fresh engine."""
    arch = engine.model_cfg.name.replace("-reduced", "")
    sp = SamplingParams(max_new_tokens=4)
    eng = Engine(EngineConfig(**_kw(arch, n_slots=1)))
    eng.generate([[9, 8, 7, 6, 5, 4, 3, 2]], sp)
    for prompt in ([4, 5, 6], [11]):
        after = eng.generate([prompt], sp)[0].output_token_ids
        alone = Engine(EngineConfig(**_kw(arch, n_slots=1))).generate(
            [prompt], sp)[0].output_token_ids
        assert after == alone


def test_slot_splice_isolated(engine):
    """Splicing a B=1 cache into slot 1 writes that slot's extent (here a
    shorter slab than the engine's) and leaves slots 0 and 2 bit for bit."""
    model, pol = engine.model, engine.policy
    gen = torch.Generator().manual_seed(5)
    big = model.init_cache(pol, 3, 32, "cpu")
    for t in cache_leaves(big):
        t.copy_(torch.randint(-100, 100, t.shape, generator=gen).to(t.dtype))
    small = model.init_cache(pol, 1, 16, "cpu")
    for t in cache_leaves(small):
        t.copy_(torch.randint(-100, 100, t.shape, generator=gen).to(t.dtype))
    before = [t.clone() for t in cache_leaves(big)]
    _slot_insert(big, small, 1)
    for b, a, s in zip(before, cache_leaves(big), cache_leaves(small)):
        for other in (0, 2):
            assert torch.equal(a[:, other].float(), b[:, other].float())
        ext = (slice(None), 1) + tuple(slice(0, n) for n in s.shape[2:])
        assert torch.equal(a[ext].float(), s[:, 0].float())
        if a.shape[2:] != s.shape[2:]:            # the tail stays stale
            assert torch.equal(a[:, 1, 16:].float(), b[:, 1, 16:].float())


def test_one_shot_engine_shape(engine):
    """Non-chunked: every step feeds one token per slot."""
    assert not engine._chunked and engine.model.init_paged_cache is None
    assert engine._has_extra == (engine.model_cfg.family == "audio")
    rid = engine.submit([3, 1, 4, 1, 5])
    engine.step()
    assert engine.scheduler.running()[0].pos == 5     # 4 prefilled + 1 fed
    engine.abort(rid)
    assert engine.kv_resident_bytes() == sum(
        t.numel() * t.element_size() for t in cache_leaves(engine.cache))


@pytest.mark.parametrize("arch", FAMS)
def test_paged_rejected(arch):
    with pytest.raises(EngineError, match="has no KV cache to page"):
        EngineConfig(**_kw(arch, cache_kind="paged", max_seq=32,
                           block_size=8))


def test_rwkv6_not_yet_ported():
    """Formerly "not yet ported" (ROADMAP queue 1 item 8): the full config,
    copied field for field from the JAX package's, is accepted and builds
    the ssm family with no pool; REDUCED serves through the one-shot path
    and, like the families above, refuses the paged pool."""
    cfg = ModelConfig(**dataclasses.asdict(j_config("rwkv6-7b")))
    assert EngineConfig(model=cfg, device="cpu").model.family == "ssm"
    model = build(cfg)
    assert model.init_paged_cache is None and model.prefill is not None
    eng = Engine(EngineConfig(**_kw("rwkv6-7b")))
    assert not eng._chunked and not eng._has_extra
    outs = eng.generate([[3, 1, 4, 1, 5], [9]],
                        SamplingParams(max_new_tokens=3))
    assert [len(o.output_token_ids) for o in outs] == [3, 3]
    with pytest.raises(EngineError, match="has no KV cache to page"):
        EngineConfig(**_kw("rwkv6-7b", cache_kind="paged", block_size=8))
