"""The vlm family's text tower in the port — internvl2-2b REDUCED — and its
one-shot image prefill, against the JAX package.

* ``prefill``: the stub image embeddings (JAX's, carried across) go
  through ``img_proj`` and are prepended to a 7-token prompt; logits and
  the written cache rows (dequantized) against jitted JAX's ``prefill``
  within 2e-2 · max |value|, then teacher-forced ``decode_step``s after
  it against jitted JAX (``attn_impl="pallas"`` at the engine's tile, as
  the JAX engine passes it), w4a16kv8 and w16a16kv16.
* The engine against the JAX engine (kernels on both; the JAX one
  interprets its Pallas kernels): the same streams, up to a near-tie of
  JAX's own logits at the first difference.
* The reference's image-row decode, mirrored: a slot decodes from
  position n - 1 of its n-token prompt although the prefill wrote
  n_img + n - 1 rows, so while n - 1 < n_img each step overwrites and
  attends to image rows and the prompt is read only through its last
  token: two prompts with the same last token serve the same stream, in
  both packages.
* Refusals: a paged vlm engine ("modality-stub", as the reference's
  config), and a prompt whose image rows + prompt do not fit ``max_seq``
  (the reference fails there on a shape error).
* The engine passes its attention tile to the one-shot family's decode
  steps (a spy on ``decode_step``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core.precision import get_policy as j_policy
from repro.models import transformer as JT
from repro.models.registry import build as j_build
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.engine import quantize_params as j_quantize
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core.kvcache import dequant_k, dequant_v
from repro_torch.core.precision import get_policy as t_policy
from repro_torch.models import transformer as TT
from repro_torch.models.registry import VIT_WIDTH, build
from repro_torch.serving import (Engine, EngineConfig, EngineError,
                                 SamplingParams)
from repro_torch.serving.engine import quantize_params as t_quantize
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

ARCH = "internvl2-2b"
TOL = 2e-2
BS = 8
#: the two prompts of the image-row check: the same last token
PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 42], [100, 200, 300, 400, 500, 600, 700,
                                         42]]


def _t(a) -> torch.Tensor:
    return to_tensor(np.asarray(a), "cpu")


def _close(lt, lj, tol=TOL):
    """lt within tol · max |lj|, top-1 equal where JAX's margin is clear
    (logits)."""
    assert lt.shape == lj.shape and np.isfinite(lt).all()
    scale = np.abs(lj).max()
    assert np.abs(lt - lj).max() <= tol * scale
    if lt.ndim == 2:
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > tol * scale
        np.testing.assert_array_equal(lt.argmax(-1)[clear],
                                      lj.argmax(-1)[clear])


@pytest.fixture(scope="module")
def raw():
    cfg_j, cfg_t = j_reduced(ARCH), get_reduced(ARCH)
    raw_j = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    img = j_build(cfg_j).extra_inputs(jax.random.PRNGKey(3), 2)["img_embeds"]
    return cfg_j, cfg_t, raw_j, jax.device_get(raw_j), img


@pytest.mark.parametrize("policy", ["w4a16kv8", "w16a16kv16"])
def test_prefill_and_decode_match_jax(raw, policy):
    cfg_j, cfg_t, raw_j, raw_np, img = raw
    pol_j, pol_t = j_policy(policy), t_policy(policy)
    params_j = j_quantize(raw_j, pol_j)
    params_t = t_quantize(params_from_jax(raw_np, cfg_t, device="cpu"),
                          pol_t)
    S, P, n_img = 48, 7, cfg_t.n_img_tokens
    stream = np.random.default_rng(1).integers(
        1, cfg_t.vocab, (2, P + 3)).astype(np.int32)
    lj, cache_j = jax.jit(JT.prefill, static_argnames=("cfg", "policy"))(
        params_j, cfg_j, pol_j, jnp.asarray(stream[:, :P]),
        JT.init_cache(cfg_j, pol_j, 2, S), img_embeds=img)
    lt, cache_t = TT.prefill(params_t, cfg_t, pol_t,
                             torch.from_numpy(stream[:, :P]),
                             TT.init_cache(cfg_t, pol_t, 2, S, "cpu"),
                             img_embeds=_t(img))
    _close(lt.float().numpy(), _t(lj).float().numpy())
    # the written rows, dequantized; the rows past them untouched
    n = n_img + P
    for deq, qj, sj in ((dequant_k, cache_j.k, cache_j.k_scale),
                        (dequant_v, cache_j.v, cache_j.v_scale)):
        ref = (_t(qj).float() * _t(sj).float())[:, :, :n]
        got = deq(cache_t, pol_t.kv, torch.float32)[:, :, :n]
        _close(got.numpy(), ref.numpy())
    assert not cache_t.k[:, :, n:].any()

    step_j = jax.jit(JT.decode_step, static_argnames=(
        "cfg", "policy", "attn_impl", "attn_block_s"))
    # the engine's decode positions: from n - 1 of the n-token prompt
    for p in range(P, P + 3):
        pos = np.array([p, p], np.int32)
        tok = stream[:, p:p + 1]
        lj, cache_j = step_j(params_j, cfg_j, pol_j, jnp.asarray(tok),
                             cache_j, jnp.asarray(pos), attn_impl="pallas",
                             attn_block_s=BS)
        lt, cache_t = TT.decode_step(params_t, cfg_t, pol_t,
                                     torch.from_numpy(tok), cache_t,
                                     torch.from_numpy(pos), attn_block_s=BS)
        _close(lt.float().numpy(), _t(lj).float().numpy())


def test_prefill_refuses_what_does_not_fit(raw):
    _, cfg_t, _, raw_np, img = raw
    pol = t_policy("w4a16kv8")
    params = params_from_jax(raw_np, cfg_t, device="cpu")
    toks = torch.ones((1, 9), dtype=torch.int64)
    with pytest.raises(ValueError, match="does not fit max_seq=24"):
        TT.prefill(params, cfg_t, pol, toks,
                   TT.init_cache(cfg_t, pol, 1, 24, "cpu"),
                   img_embeds=_t(img)[:1])


def _record(model, log, to_np):
    def step(*a, **k):
        logits, cache = model.decode_step(*a, **k)
        to_np(logits, log)
        return logits, cache
    return dataclasses.replace(model, decode_step=step)


ENGINE_KW = dict(policy="w4a16kv8", n_slots=2, max_seq=48, block_size=BS,
                 seed=0)


def _serve(eng, SP, prompts, log):
    """Greedy streams, and per emitted token the logits row it was
    sampled from."""
    rids = [eng.submit(p, SP(max_new_tokens=6)) for p in prompts]
    reqs, rows, final = {}, {r: [] for r in rids}, {}
    while not eng.scheduler.idle:
        reqs.update(eng._requests)
        for o in eng.step():
            rows[o.rid].append(log[-1][reqs[o.rid].slot])
            if o.finished:
                final[o.rid] = o
    return [(final[r].output_token_ids, rows[r]) for r in rids]


def test_engine_streams_match_jax_engine(raw):
    """Four prompts (the image-row pair among them) on two slots: each
    stream is the JAX engine's up to a near-tie of the logits JAX sampled
    it from; the two prompts ending in the same token serve the same
    stream in both packages."""
    cfg_j, cfg_t, raw_j, raw_np, _ = raw
    eng_j = JEngine(JEngineConfig(model=cfg_j, **ENGINE_KW), params=raw_j)
    eng_t = Engine(EngineConfig(model=cfg_t, device="cpu", **ENGINE_KW),
                   params=params_from_jax(raw_np, cfg_t, device="cpu"))
    eng_t._extra = {k: _t(v) for k, v in eng_j._extra.items()}
    log_j, log_t = [], []
    eng_j.model = _record(eng_j.model, log_j, lambda l, log: jax.debug
                          .callback(lambda v: log.append(np.asarray(
                              v, np.float32)), l, ordered=True))
    eng_t.model = _record(eng_t.model, log_t, lambda l, log: log.append(
        l.float().numpy()))
    prompts = PROMPTS + np.random.default_rng(4).integers(
        1, cfg_t.vocab, (2, 12)).tolist()
    got_j = _serve(eng_j, JSamplingParams, prompts, log_j)
    got_t = _serve(eng_t, SamplingParams, prompts, log_t)
    same = 0
    for (sj, rows_j), (st, _) in zip(got_j, got_t):
        assert len(st) == len(sj) == 6
        if st == sj:
            same += 1
            continue
        i = next(i for i, (a, b) in enumerate(zip(sj, st)) if a != b)
        lg = rows_j[i]
        assert lg.argmax() == sj[i]
        assert lg[sj[i]] - lg[st[i]] <= TOL * np.abs(lg).max(), i
    assert same >= 3
    for got in (got_j, got_t):
        assert got[0][0] == got[1][0]


@pytest.mark.parametrize("policy", ["w4a16kv8", "w4a8kv4"])
def test_image_rows_decode_like_the_reference(policy):
    """The port alone, seeded weights: two prompts with the same last
    token serve the same stream (the reference's image-row decode); a
    prompt ending in another token serves another."""
    eng = Engine(EngineConfig(model=get_reduced(ARCH), device="cpu",
                              **dict(ENGINE_KW, policy=policy)))
    outs = eng.generate(PROMPTS + [PROMPTS[0][:-1] + [43]],
                        SamplingParams(max_new_tokens=6))
    streams = [o.output_token_ids for o in outs]
    assert streams[0] == streams[1] != streams[2]


def test_paged_is_refused():
    with pytest.raises(EngineError, match="modality-stub"):
        EngineConfig(model=get_reduced(ARCH), device="cpu",
                     cache_kind="paged", max_seq=48, block_size=8)


def test_prompt_past_max_seq_is_refused():
    """REDUCED's 16 image rows + 33 prompt tokens (the prompt minus its
    last) do not fit max_seq 48; 32 do."""
    eng = Engine(EngineConfig(model=get_reduced(ARCH), device="cpu",
                              **ENGINE_KW))
    with pytest.raises(EngineError, match="max_seq=48"):
        eng.submit(list(range(1, 35)))
    eng.submit(list(range(1, 34)))


def test_engine_passes_the_tile_to_one_shot_decode(monkeypatch):
    """A vlm engine on the slab decodes at ``attn_block_s ==
    block_size`` through the kernel route, as the reference's engine
    passes its tile to every family with kernels (no ``valid``: the
    one-shot path feeds no padding)."""
    eng = Engine(EngineConfig(model=get_reduced(ARCH), device="cpu",
                              **ENGINE_KW))
    seen = []
    step = eng.model.decode_step

    def spy(*a, **kw):
        seen.append(kw)
        return step(*a, **kw)

    monkeypatch.setattr(eng.model, "decode_step", spy)
    eng.generate([[3, 4, 5]], SamplingParams(max_new_tokens=2))
    assert seen and all(kw["attn_block_s"] == BS and
                        kw["attn_impl"] == "kernel" and "valid" not in kw
                        for kw in seen)


def test_extra_inputs_and_params():
    cfg = get_reduced(ARCH)
    model = build(cfg)
    ex = model.extra_inputs(2, 3, "cpu")
    assert tuple(ex["img_embeds"].shape) == (3, cfg.n_img_tokens, VIT_WIDTH)
    assert ex["img_embeds"].dtype == torch.bfloat16
    params = t_quantize(model.init_params(0, "cpu"), t_policy("w4a16kv8"))
    assert params["img_proj"].shape == (VIT_WIDTH, cfg.d_model)
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab, full.n_img_tokens, full.hd) == \
        (24, 2048, 16, 8, 8192, 92553, 256, 128)
