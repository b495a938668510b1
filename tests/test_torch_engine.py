"""The port's serving engine on the CPU (plain kernel versions).

* Greedy streams equal the argmax of the port's own teacher-forced
  ``decode_step``, run with the engine's step shapes (two prompts in
  lockstep: two 4-token chunks, then single-token steps) — exact equality,
  since both run the same ops on the same shapes.
* Dense ≡ paged: for every KV format, the dense-slab and paged engines
  serve byte-identical greedy streams (ragged prompts crossing chunk and
  block boundaries, slot churn, eos) — the JAX suite's
  ``TestPagedDenseEquivalence``, inside the port.
* ``EngineConfig`` rules: invalid values (the JAX package's dense/paged
  rules among them) and every feature not yet ported raise
  ``EngineError``; so does the default device when CUDA is missing.
  Every ``WxAyKVz`` policy builds an engine that serves.
* Lifecycle: abort returns blocks, stream() reassembles generate().
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.serving import (Engine, EngineConfig, EngineError,
                                 FinishReason, SamplingParams)

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

SMOLLM = get_reduced("smollm-360m")
KW = dict(model=SMOLLM, n_slots=2, max_seq=32, max_prompt=16, block_size=8,
          prefill_chunk=4, device="cpu", cache_kind="paged")


@pytest.fixture(scope="module")
def engine():
    return Engine(EngineConfig(**KW))


def _teacher_forced_greedy(eng, prompts, n_new):
    """Greedy continuation of equal-length prompts through decode_step
    directly, on a fresh cache, with the engine's chunking."""
    cfg, bs = eng.model_cfg, eng.block_size
    cache = eng.model.init_paged_cache(eng.policy, eng.n_slots, eng.n_blocks,
                                       bs, eng.blocks_per_slot, "cpu")
    tbl = torch.arange(eng.n_slots * eng.blocks_per_slot, dtype=torch.int32)
    cache.block_table.copy_(tbl.reshape(eng.n_slots, -1).flip(0))
    B, n = len(prompts), len(prompts[0])
    seq = torch.tensor(prompts, dtype=torch.int64)
    out = [[] for _ in range(B)]
    p, last = 0, None

    def step(toks, p):
        nb = -(-(p + 1) // bs)
        ml = min(1 << (nb - 1).bit_length(), eng.blocks_per_slot) * bs
        T = toks.shape[1]
        logits, _ = eng.model.decode_step(
            eng.params, eng.policy, toks, cache,
            torch.full((B,), p, dtype=torch.int32), max_live=ml,
            valid=torch.full((B,), T, dtype=torch.int32))
        return logits.float().argmax(-1)

    while p < n:
        last = step(seq[:, p:p + eng.prefill_chunk], p)
        p += eng.prefill_chunk
    for i in range(n_new):
        for b in range(B):
            out[b].append(int(last[b]))
        if i + 1 < n_new:
            last = step(last[:, None], p)
            p += 1
    return out


def test_greedy_streams_equal_teacher_forced_argmax(engine):
    rng = np.random.default_rng(1)
    prompts = rng.integers(1, SMOLLM.vocab, (2, 8)).tolist()
    outs = engine.generate(prompts, SamplingParams(max_new_tokens=6))
    assert [o.finish_reason for o in outs] == [FinishReason.LENGTH] * 2
    assert engine.allocator.live_count == 0
    want = _teacher_forced_greedy(engine, prompts, 6)
    assert [o.output_token_ids for o in outs] == want


def test_more_requests_than_slots_drain(engine):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, SMOLLM.vocab, n).tolist() for n in (5, 9, 3)]
    outs = engine.generate(prompts, SamplingParams(max_new_tokens=4))
    assert [len(o.output_token_ids) for o in outs] == [4, 4, 4]
    assert engine.allocator.live_count == 0
    assert engine.scheduler.idle


def test_stream_reassembles_generate(engine):
    prompt = [7, 3, 9, 11, 2]
    full = engine.generate([prompt], SamplingParams(max_new_tokens=5))[0]
    toks = [t for o in engine.stream(prompt, SamplingParams(max_new_tokens=5))
            for t in o.new_token_ids]
    assert toks == full.output_token_ids


def test_abort_running_returns_blocks(engine):
    rid = engine.submit([1, 2, 3, 4, 5, 6], SamplingParams(max_new_tokens=8))
    engine.step()
    assert engine.allocator.live_count > 0
    out = engine.abort(rid)
    assert out.finish_reason == FinishReason.ABORT
    assert engine.allocator.live_count == 0
    assert engine.abort(rid) is None


def test_seeded_sampling_reproducible(engine):
    sp = SamplingParams(max_new_tokens=5, temperature=0.9, top_k=20, seed=7)
    a = engine.generate([[4, 5, 6]], sp)[0].output_token_ids
    b = engine.generate([[4, 5, 6], [8, 8, 8, 8, 8]], [sp, sp])[0]
    assert a == b.output_token_ids


@pytest.mark.parametrize("kw", [
    dict(n_slots=0), dict(max_seq=-4), dict(prefill_chunk=0),
    dict(max_prompt=0), dict(max_prompt=128, max_seq=64),
    dict(max_seq=60, block_size=16),                    # misaligned pool
    dict(n_blocks=0), dict(cache_kind="ring"), dict(attn_impl="triton"),
    dict(prefill_chunk=6, block_size=4),                # straddles blocks
    dict(policy="w4a16kv9"), dict(device="tpu"),
    dict(cache_kind="dense", n_blocks=8),               # a slab has no pool
    dict(cache_kind="dense", enable_block_growth=True),
    dict(cache_kind="dense", enable_prefix_caching=True),
    dict(reserve_headroom_blocks=-1),
])
def test_invalid_configs_rejected(kw):
    args = dict(KW)
    args.update(kw)
    with pytest.raises(EngineError):
        EngineConfig(**args)


@pytest.mark.parametrize("kw,item", [
    (dict(enable_prefix_caching=True), "item 3"),
    (dict(enable_block_growth=True), "item 4"),
    (dict(attn_impl="xla"), "item 5"),
])
def test_unported_features_raise(kw, item):
    args = dict(KW)
    args.update(kw)
    with pytest.raises(EngineError, match=f"not yet ported: ROADMAP queue 1 "
                                          f"{item}"):
        EngineConfig(**args)


@pytest.mark.parametrize("kw", [
    dict(cache_kind="dense"), dict(policy="w8a16kv8"),
    dict(policy="w4a16kv4"),
])
def test_formerly_unported_configs_serve(kw):
    """The dense backend and the policies beyond w4a16kv8 build and serve
    (they raised "not yet ported" before the dense family was complete)."""
    args = dict(KW)
    args.update(kw)
    eng = Engine(EngineConfig(**args))
    assert eng.cache_kind == args["cache_kind"]
    assert eng.policy.name == args.get("policy", "w4a16kv8")
    out = eng.generate([[3, 1, 4, 1, 5]], SamplingParams(max_new_tokens=3))
    assert len(out[0].output_token_ids) == 3


def test_dense_is_the_default_backend():
    args = {k: v for k, v in KW.items() if k != "cache_kind"}
    cfg = EngineConfig(**args)
    assert cfg.cache_kind == "dense"
    eng = Engine(cfg)
    L, hkv, hd = SMOLLM.n_layers, SMOLLM.n_kv_heads, SMOLLM.hd
    assert tuple(eng.cache.k.shape) == (L, 2, 32, hkv, hd)
    assert eng.allocator is None and eng.attn_block_s == 8
    # int8 K and V plus two f32 scales per (layer, slot, token, head)
    assert eng.kv_resident_bytes() == L * 2 * 32 * hkv * (2 * hd + 8)
    # block_size not dividing max_seq: one whole-sequence tile
    assert Engine(EngineConfig(**dict(args, max_seq=30))).attn_block_s == 30


ALL_POLICIES = [w + a + kv for w in ("w4", "w8", "wfp8", "w16")
                for a in ("a8", "afp8", "a16")
                for kv in ("kv4", "kv8", "kvfp8", "kv16")]


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_every_policy_serves(policy):
    eng = Engine(EngineConfig(**dict(KW, policy=policy, cache_kind="dense")))
    out = eng.generate([[2, 7, 1, 8, 2, 8]], SamplingParams(max_new_tokens=2))
    assert len(out[0].output_token_ids) == 2
    assert all(0 <= t < SMOLLM.vocab for t in out[0].output_token_ids)


PROMPTS = [
    [5, 6, 7],
    [1],                                  # single token: no prefill at all
    [9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3],    # crosses chunk + block boundaries
    [42, 17],
    [3, 1, 4, 1, 5, 9, 2, 6],
]


def _drain(eng):
    return {o.rid: o for o in eng.run_until_idle()}


class TestPagedDenseEquivalence:
    """Same prompts, same seed, ``block_size`` dividing ``max_seq``: the
    dense and paged engines emit byte-identical greedy streams, for every
    KV format."""

    @pytest.fixture(scope="class", params=["kv8", "kv4", "kvfp8", "kv16"])
    def engines(self, request):
        args = dict(KW, n_slots=3, max_seq=64, policy=f"w4a16{request.param}")
        return (Engine(EngineConfig(**dict(args, cache_kind="dense"))),
                Engine(EngineConfig(**dict(args, cache_kind="paged"))))

    def test_greedy_streams_identical(self, engines):
        outs = []
        for eng in engines:
            rids = [eng.submit(p, SamplingParams(max_new_tokens=6))
                    for p in PROMPTS]
            final = _drain(eng)
            assert all(len(final[r].output_token_ids) == 6 for r in rids)
            outs.append([final[r].output_token_ids for r in rids])
        assert outs[0] == outs[1], "paged engine diverged from dense"

    def test_equivalence_under_slot_churn(self, engines):
        """Slot reuse (stale slab rows, blocks freed and re-allocated to
        new requests) leaves the streams identical."""
        outs = []
        for eng in engines:
            batch1 = [eng.submit(p, SamplingParams(max_new_tokens=4))
                      for p in PROMPTS[:3]]
            f1 = _drain(eng)
            batch2 = [eng.submit(p, SamplingParams(max_new_tokens=4))
                      for p in PROMPTS[2:]]
            f2 = _drain(eng)
            outs.append([f1[r].output_token_ids for r in batch1]
                        + [f2[r].output_token_ids for r in batch2])
        assert outs[0] == outs[1]

    def test_eos_identical(self, engines):
        res = []
        for eng in engines:
            probe = eng.submit([3, 1, 4], SamplingParams(max_new_tokens=2))
            eos = _drain(eng)[probe].output_token_ids[0]
            r = eng.submit([3, 1, 4], SamplingParams(max_new_tokens=8,
                                                     eos_id=eos))
            out = _drain(eng)[r]
            assert out.finish_reason == "eos"
            res.append(out.output_token_ids)
        assert res[0] == res[1] and len(res[0]) == 1


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = {k: v for k, v in KW.items() if k != "device"}
    with pytest.raises(EngineError, match="CUDA is not available"):
        EngineConfig(**args)


def test_submit_rejections(engine):
    with pytest.raises(EngineError):
        engine.submit([])
    with pytest.raises(EngineError):
        engine.submit(list(range(1, 18)))                # > max_prompt
    with pytest.raises(EngineError):
        engine.submit([SMOLLM.vocab])                    # outside vocab
