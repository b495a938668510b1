"""The port's serving engine on the CPU (plain kernel versions).

* Greedy streams equal the argmax of the port's own teacher-forced
  ``decode_step``, run with the engine's step shapes (two prompts in
  lockstep: two 4-token chunks, then single-token steps) — exact equality,
  since both run the same ops on the same shapes.
* ``EngineConfig`` rules: invalid values and every feature not yet ported
  raise ``EngineError``; so does the default device when CUDA is missing.
* Lifecycle: abort returns blocks, stream() reassembles generate().
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.serving import (Engine, EngineConfig, EngineError,
                                 FinishReason, SamplingParams)

SMOLLM = get_reduced("smollm-360m")
KW = dict(model=SMOLLM, n_slots=2, max_seq=32, max_prompt=16, block_size=8,
          prefill_chunk=4, device="cpu")


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
])
def test_invalid_configs_rejected(kw):
    args = dict(KW)
    args.update(kw)
    with pytest.raises(EngineError):
        EngineConfig(**args)


@pytest.mark.parametrize("kw,item", [
    (dict(cache_kind="dense"), "item 2"),
    (dict(enable_prefix_caching=True), "item 3"),
    (dict(enable_block_growth=True), "item 4"),
    (dict(attn_impl="xla"), "item 5"),
    (dict(policy="w8a16kv8"), "item 6"),
    (dict(policy="w4a16kv4"), "item 6"),
])
def test_unported_features_raise(kw, item):
    args = dict(KW)
    args.update(kw)
    with pytest.raises(EngineError, match=f"not yet ported: ROADMAP queue 1 "
                                          f"{item}"):
        EngineConfig(**args)


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
