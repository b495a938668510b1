"""Prefix sharing, block growth and preemption on the port's paged pool.

Against the JAX package, on the same inputs:

* ``PrefixIndex.chain_hashes`` is byte-equal to JAX's for the same salt,
  block size and tokens; match / register / drop_block and the allocator's
  eviction callback give the same answers.
* One seeded script of alloc / share / set_cacheable / free / evict calls
  gives the same free, cached, live and peak counts, the same eviction
  order and the same ``on_evict`` calls in both packages (the JAX suite's
  ``TestRefcounting`` cases and its ``TestAllocatorChurn`` sweep, each also
  held against a shadow model of the refcounts).
* ``copy_block`` copies the same bytes in every KV format.
* A scripted workload of fixed lengths (no EOS) through the JAX engine and
  the port's makes the same host decisions: per request ``cached_tokens``,
  ``num_preemptions``, ``replay_iterations`` and finish reason, and the
  allocator's ``peak_live``.

Inside the port, on REDUCED smollm-360m on the CPU (plain kernel
versions), the JAX suite's engine invariants (``test_prefix_sharing.py``,
``test_preemption.py``): prefix caching on ≡ off and growth ≡ reservation
greedy streams bit for bit, preempted requests included; shared blocks
allocated once, copy-on-write sources left intact, aborts decref,
eviction under pressure correct; replayed tokens not re-streamed,
recovery in O(stream / prefill_chunk) steps, FCFS order kept.
Tolerance: none — every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import paged_kvcache as JPKV
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import get_reduced
from repro_torch.core import paged_kvcache as TPKV
from repro_torch.core.kvcache import store_dim
from repro_torch.core.precision import get_policy
from repro_torch.serving import (Engine, EngineConfig, EngineError,
                                 SamplingParams, Status)
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

SMOLLM = get_reduced("smollm-360m")


# ---------------------------------------------------------------------------
# PrefixIndex
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bs,salt,n", [
    (4, "", 3), (4, "s", 17), (16, "smollm-360m|L32|Hkv5|hd64|kv8", 100),
    (8, "kv4|L4", 64),
])
def test_chain_hashes_equal_jax(bs, salt, n):
    rng = np.random.default_rng(n)
    toks = rng.integers(0, 2 ** 40, n).tolist()
    want = JPKV.PrefixIndex(bs, salt=salt).chain_hashes(toks)
    got = TPKV.PrefixIndex(bs, salt=salt).chain_hashes(toks)
    assert got == want and len(got) == n // bs


def _index_full_blocks_only(P):
    idx = P.PrefixIndex(4, salt="s")
    return [len(idx.chain_hashes(list(range(n)))) for n in (3, 4, 11)]


def _index_chain_binds_prefix(P):
    idx = P.PrefixIndex(2, salt="s")
    a, b = idx.chain_hashes([1, 2, 3, 4]), idx.chain_hashes([9, 9, 3, 4])
    c = P.PrefixIndex(2, salt="kv4|L4").chain_hashes([1, 2, 3, 4])
    return [a[0] != b[0], a[1] != b[1], a != c]


def _index_match_stops_at_miss(P):
    idx = P.PrefixIndex(2, salt="s")
    h = idx.chain_hashes([1, 2, 3, 4, 5, 6])
    out = [idx.register(h[0], 10), idx.register(h[2], 12),
           idx.match([1, 2, 3, 4, 5, 6])]
    out += [idx.register(h[1], 11), idx.match([1, 2, 3, 4, 5, 6]),
            idx.match([1, 2, 9, 9])]
    return out


def _index_first_writer_wins(P):
    idx = P.PrefixIndex(2, salt="s")
    [h] = idx.chain_hashes([1, 2])
    [h2] = idx.chain_hashes([3, 4])
    return [idx.register(h, 5), idx.register(h, 6), idx.match([1, 2]),
            idx.register(h2, 5)]


def _index_drop_block(P):
    idx = P.PrefixIndex(2, salt="s")
    [h] = idx.chain_hashes([1, 2])
    idx.register(h, 5)
    idx.drop_block(5)
    out = [idx.match([1, 2]), len(idx)]
    idx.drop_block(5)                              # idempotent
    return out + [len(idx)]


def _index_eviction_unpublishes(P):
    idx = P.PrefixIndex(2, salt="s")
    a = P.BlockAllocator(2, on_evict=idx.drop_block)
    [b] = a.alloc(1)
    [h] = idx.chain_hashes([1, 2])
    idx.register(h, b)
    a.set_cacheable(b)
    a.free([b])
    out = [idx.match([1, 2])]
    a.alloc(2)                                     # evicts b
    return out + [idx.match([1, 2])]


@pytest.mark.parametrize("scenario,expect", [
    (_index_full_blocks_only, [0, 1, 2]),
    (_index_chain_binds_prefix, [True, True, True]),
    (_index_match_stops_at_miss,
     [True, True, [10], True, [10, 11, 12], [10]]),
    (_index_first_writer_wins, [True, False, [5], False]),
    (_index_drop_block, [[], 0, 0]),
    (_index_eviction_unpublishes, [[0], []]),
])
def test_prefix_index_matches_jax(scenario, expect):
    """match / register / drop_block (test_paged_kvcache.py's
    TestPrefixIndex), the same answers in both packages."""
    assert scenario(JPKV) == scenario(TPKV) == expect


# ---------------------------------------------------------------------------
# BlockAllocator: one script through both packages
# ---------------------------------------------------------------------------


class Recorder:
    """Runs allocator calls on one package's BlockAllocator and records
    every result, raised error and eviction callback, plus the counters
    after each call."""

    def __init__(self, P, n_blocks):
        self.P, self.trace, self.evicted = P, [], []
        self.a = P.BlockAllocator(n_blocks, on_evict=self.evicted.append)

    def __call__(self, op, *args):
        try:
            res = getattr(self.a, op)(*args)
        except (ValueError, self.P.OutOfBlocksError) as e:
            res = type(e).__name__
        a = self.a
        self.trace.append((op, args, res, a.free_count, a.cached_count,
                           a.live_count, a.peak_live, a.available,
                           list(self.evicted)))
        return res


def _script_share_release(rec):
    [b] = rec("alloc", 1)
    for op in ("share", "share", "refcount", "free1", "share", "free2",
               "free1", "free1"):
        if op == "refcount":
            rec("refcount", b)
        elif op.startswith("free"):
            rec("free", [b] * int(op[-1]))
        else:
            rec(op, b)


def _script_share_of_free(rec):
    held = rec("alloc", 1)
    rec("share", 1 - held[0])


def _script_shared_accounting(rec):
    blks = rec("alloc", 3)
    for b in blks:
        rec("share", b)
    rec("alloc", 1)
    rec("alloc", 1)
    rec("free", blks)
    rec("can_alloc", 1)
    rec("free", blks)


def _script_cacheable_revive(rec):
    [b] = rec("alloc", 1)
    rec("set_cacheable", b)
    rec("free", [b])
    rec("refcount", b)
    rec("share", b)
    rec("set_cacheable", 3)                        # not live: refused


def _script_lru_eviction(rec):
    b0, b1, b2 = rec("alloc", 3)
    for b in (b0, b1, b2):
        rec("set_cacheable", b)
    rec("free", [b1])
    rec("free", [b2])
    rec("alloc", 2)                                # evicts b1, then b2
    rec("alloc", 1)                                # only live blocks left


def _script_reset(rec):
    [b] = rec("alloc", 1)
    rec("set_cacheable", b)
    rec("share", b)
    rec("reset")
    rec("refcount", b)


def _script_churn(seed):
    """test_paged_kvcache.py's TestAllocatorChurn: a seeded interleaving
    of prompt-sized admissions, one-block growth, prefix shares,
    cacheable marks, whole-map releases (retire / preemption) and
    allocate-everything pressure, with a shadow model of every refcount
    checked after each call."""
    def script(rec):
        rng = np.random.default_rng(seed)
        ref, cached, cacheable, maps = {}, set(), set(), []

        def release(m):
            rec("free", m)
            for b in m:
                ref[b] -= 1
                if ref[b] == 0:
                    del ref[b]
                    if b in cacheable:
                        cached.add(b)

        def take(blks):
            for b in blks:
                assert ref.get(b, 0) == 0, "double alloc of a live block"
                ref[b] = 1
                cached.discard(b)
                cacheable.discard(b)

        for _ in range(300):
            op = rng.choice(["admit", "grow", "share", "cacheable",
                             "preempt", "pressure"])
            a = rec.a
            if op == "admit" and a.can_alloc(2):
                blks = rec("alloc", 2)
                take(blks)
                maps.append(list(blks))
            elif op == "grow" and maps and a.can_alloc(1):
                m = maps[rng.integers(len(maps))]
                blks = rec("alloc", 1)
                take(blks)
                m.extend(blks)
            elif op == "share" and maps:
                m = maps[rng.integers(len(maps))]
                b = m[rng.integers(len(m))]
                rec("share", b)
                ref[b] += 1
                maps.append([b])
            elif op == "cacheable" and maps:
                m = maps[rng.integers(len(maps))]
                b = m[rng.integers(len(m))]
                rec("set_cacheable", b)
                cacheable.add(b)
            elif op == "preempt" and maps:
                release(maps.pop(rng.integers(len(maps))))
            elif op == "pressure" and a.available:
                before = set(cached)
                blks = rec("alloc", a.available)
                assert before <= set(blks)           # every CACHED evicted
                cacheable -= before
                take(blks)
                maps.append(list(blks))
            assert a.live_count == len(ref)
            assert a.cached_count == len(cached)
            assert all(a.refcount(b) == rc for b, rc in ref.items())
            assert a.peak_live >= len(ref)
        for m in maps:
            release(m)
        assert not ref and a.free_count + a.cached_count == a.n_blocks
        rec("alloc", a.available)                  # evicts every CACHED
    return script


@pytest.mark.parametrize("script,n_blocks", [
    (_script_share_release, 4), (_script_share_of_free, 2),
    (_script_shared_accounting, 4), (_script_cacheable_revive, 4),
    (_script_lru_eviction, 3), (_script_reset, 2),
] + [(_script_churn(seed), 24) for seed in range(5)])
def test_allocator_script_matches_jax(script, n_blocks):
    """The same calls on both allocators: same results and errors, same
    free / cached / live / peak counts after every call, same eviction
    order through ``on_evict``."""
    jax_rec, port_rec = Recorder(JPKV, n_blocks), Recorder(TPKV, n_blocks)
    script(jax_rec)
    script(port_rec)
    assert port_rec.trace == jax_rec.trace
    assert len(port_rec.trace) > 1


# ---------------------------------------------------------------------------
# copy_block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["kv8", "kv4", "kvfp8", "kv16"])
def test_copy_block_matches_jax(fmt):
    """The same pool bytes, the same (src, dst): the same bytes after the
    copy (K, V and both scales; every other block untouched), on a
    stacked two-layer pool."""
    spec = get_policy(f"w4a16{fmt}").kv
    L, nb, bs, H, D = 2, 5, 4, 2, 16
    ds = store_dim(D, spec)
    rng = np.random.default_rng(7)
    port = TPKV.init_paged(2, nb, bs, H, D, spec, 2, n_layers=L,
                           device="cpu")
    for t in (port.k, port.v):
        t.view(torch.uint8).copy_(torch.from_numpy(rng.integers(
            0, 120, (L, nb, bs, H, ds * spec.dtype.itemsize), np.uint8)))
    for t in (port.k_scale, port.v_scale):
        t.copy_(torch.from_numpy(rng.random((L, nb, bs, H), np.float32)))

    def raw(t):
        return t.contiguous().view(torch.uint8).numpy().copy()

    jdt = {"kv8": jnp.int8, "kv4": jnp.int8, "kvfp8": jnp.float8_e5m2,
           "kv16": jnp.bfloat16}[fmt]

    def to_jax(t):
        return jnp.asarray(raw(t)).view(jdt)

    before = {n: raw(getattr(port, n)) for n in ("k", "v")}
    before.update({n: getattr(port, n).numpy().copy()
                   for n in ("k_scale", "v_scale")})
    jcache = JPKV.PagedKVCache(
        k=to_jax(port.k), v=to_jax(port.v),
        k_scale=jnp.asarray(before["k_scale"])[..., None],
        v_scale=jnp.asarray(before["v_scale"])[..., None],
        block_table=jnp.asarray(port.block_table.numpy()),
        length=jnp.zeros((2,), jnp.int32))
    jout = JPKV.copy_block(jcache, jnp.int32(1), jnp.int32(3))
    TPKV.copy_block(port, 1, 3)
    for name in ("k", "v"):
        want = np.asarray(getattr(jout, name)).view(np.uint8)
        got = raw(getattr(port, name))
        np.testing.assert_array_equal(got, want.reshape(got.shape), name)
        np.testing.assert_array_equal(got[:, 3], before[name][:, 1], name)
    for name in ("k_scale", "v_scale"):
        want = np.asarray(getattr(jout, name))[..., 0]
        got = getattr(port, name).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), name)
        keep = [0, 1, 2, 4]
        np.testing.assert_array_equal(got[:, keep], before[name][:, keep])


# ---------------------------------------------------------------------------
# The engine's host decisions against the JAX engine
# ---------------------------------------------------------------------------

SYSP = [7, 7, 7, 7, 3, 1, 4, 1]            # two full 4-token blocks
ALIGNED = [2, 3, 4, 5, 6, 7, 8, 9]         # publishes its first block only
WORKLOAD = [(ALIGNED, 4), (SYSP + [5], 10), (SYSP + [9], 10),
            ([2, 3, 4], 6), (SYSP + [9, 8, 7, 6], 5), (SYSP, 7),
            ([1] * 6, 4), (ALIGNED + [1], 4)]


@pytest.mark.parametrize("features", [
    dict(enable_block_growth=True, enable_prefix_caching=True),
    dict(enable_block_growth=True, reserve_headroom_blocks=1),
])
def test_scripted_workload_decisions_match_jax(features):
    """Fixed lengths, no EOS: what the engines decide depends on lengths,
    prompts and the pool alone, so per request ``cached_tokens``,
    ``num_preemptions``, ``replay_iterations`` and the finish reason, and
    the allocator's ``peak_live``, must be equal (the JAX engine runs its
    XLA attention: the decisions do not read the attention's bits)."""
    kw = dict(policy="w4a16kv8", n_slots=3, max_seq=32, max_prompt=16,
              seed=0, cache_kind="paged", block_size=4, n_blocks=8,
              prefill_chunk=4, **features)
    engines = (JEngine(JEngineConfig(model=jax_reduced("smollm-360m"),
                                     attn_impl="xla", **kw)),
               Engine(EngineConfig(model=SMOLLM, device="cpu", **kw)))
    got = []
    for eng, SP in zip(engines, (JSamplingParams, SamplingParams)):
        rids = [eng.submit(p, SP(max_new_tokens=n)) for p, n in WORKLOAD]
        final = {o.rid: o for o in eng.run_until_idle()}
        got.append(([(final[r].cached_tokens, final[r].num_preemptions,
                      final[r].replay_iterations,
                      str(final[r].finish_reason),
                      len(final[r].output_token_ids)) for r in rids],
                    eng.allocator.peak_live, eng.allocator.live_count))
    assert got[1] == got[0]
    assert sum(c[1] for c in got[1][0]) > 0, "no preemption: proves nothing"
    if features.get("enable_prefix_caching"):
        assert sum(c[0] for c in got[1][0]) > 0


# ---------------------------------------------------------------------------
# Prefix sharing inside the port (test_prefix_sharing.py)
# ---------------------------------------------------------------------------

BS = 8
SYS = list(range(1, 18))        # 17-token "system prompt": 2 full blocks


def _prefix_engine(prefix_caching=True, **kw):
    args = dict(n_slots=3, max_seq=64, max_prompt=32, seed=0,
                cache_kind="paged", block_size=BS, prefill_chunk=4,
                enable_prefix_caching=prefix_caching, device="cpu")
    args.update(kw)
    return Engine(EngineConfig(model=SMOLLM, policy="w4a16kv8", **args))


def _drain(eng):
    return {o.rid: o for o in eng.run_until_idle()}


def _greedy(eng, prompts, max_new=5):
    rids = [eng.submit(p, SamplingParams(max_new_tokens=max_new))
            for p in prompts]
    final = _drain(eng)
    return [final[r] for r in rids]


@pytest.fixture(scope="module")
def prefix_engines():
    return _prefix_engine(False), _prefix_engine(True)


def test_prefix_hit_streams_identical_to_cold(prefix_engines):
    """Donor, hits, a block-aligned copy-on-write prompt and a miss: every
    stream equals the sharing-disabled engine's bit for bit; the engine
    reports the hits."""
    prompts = ([SYS + [100 + i] for i in range(4)] + [SYS[:2 * BS]]
               + [[7, 7] + SYS])
    streams, cached = [], []
    for eng in prefix_engines:
        outs = _greedy(eng, prompts)
        streams.append([o.output_token_ids for o in outs])
        cached.append([o.cached_tokens for o in outs])
    assert streams[0] == streams[1]
    assert cached[0] == [0] * len(prompts)
    # 3 slots: the first 3 admit together before any registration; the
    # 4th hits both blocks, the 5th copies the block holding its last
    # prompt token, the 6th diverges in its first block
    assert cached[1][3:] == [2 * BS, 2 * BS - 1, 0]


@pytest.mark.parametrize("surface", ["generate", "stream"])
def test_hits_across_generations_identical(prefix_engines, surface):
    """Blocks cached by retired requests (CACHED, refcount 0) still serve
    hits, on the batch and on the streaming surface."""
    got = []
    for eng in prefix_engines:
        if surface == "generate":
            got.append([o.output_token_ids for o in
                        _greedy(eng, [SYS + [60], SYS + [61]])])
        else:
            got.append([t for o in eng.stream(
                SYS + [77], SamplingParams(max_new_tokens=6))
                for t in o.new_token_ids])
    assert got[0] == got[1] and len(got[0]) in (2, 6)


@pytest.mark.parametrize("n", [15, 16, 17])
def test_registration_stops_below_decode_frontier(n):
    """A retired prompt publishes its full blocks strictly below position
    ``n - 1`` — the reference's extent: a block-aligned prompt's last
    block is left to copy-on-write — and they park CACHED."""
    eng = _prefix_engine()
    _greedy(eng, [SYS[:n]], max_new=2)
    assert len(eng.prefix_index) == (n - 1) // BS
    assert eng.allocator.cached_count == (n - 1) // BS
    assert eng.allocator.live_count == 0


def test_shared_blocks_allocated_once():
    """Two sharers hold the same two physical blocks at refcount 2, the
    pool pays for them once, and no write lands in them while shared."""
    eng = _prefix_engine()
    _greedy(eng, [SYS], max_new=2)
    a = eng.submit(SYS + [101], SamplingParams(max_new_tokens=4))
    b = eng.submit(SYS + [102], SamplingParams(max_new_tokens=4))
    eng.step()
    shared = eng._block_map[a][:2]
    assert shared == eng._block_map[b][:2]
    assert [eng.allocator.refcount(blk) for blk in shared] == [2, 2]
    need = eng._blocks_for(eng._requests[a])
    assert len(set(eng._block_map[a]) | set(eng._block_map[b])) \
        == 2 * need - 2
    before = [t[:, shared].clone() for t in (eng.cache.k, eng.cache.v,
                                             eng.cache.k_scale)]
    final = _drain(eng)
    assert all(torch.equal(t[:, shared], t0) for t, t0 in zip(
        (eng.cache.k, eng.cache.v, eng.cache.k_scale), before))
    assert final[a].cached_tokens == final[b].cached_tokens == 2 * BS
    assert eng.allocator.live_count == 0
    assert eng.allocator.cached_count >= 2
    assert eng.allocator.free_count + eng.allocator.cached_count \
        == eng.n_blocks


def test_cow_source_keeps_other_sharers_intact():
    """A copy-on-write copies: the source block's bytes keep serving
    later hits, and the copy holds the source's bytes exactly."""
    eng = _prefix_engine()
    donor = SYS[:2 * BS] + [50]
    _greedy(eng, [donor])
    src = eng.prefix_index.match(donor)[1]
    src_bytes = eng.cache.k[:, src].clone()
    rid = eng.submit(SYS[:2 * BS], SamplingParams(max_new_tokens=5))
    eng.step()
    dst = eng._block_map[rid][1]
    assert dst != src and torch.equal(eng.cache.k[:, src], src_bytes)
    # position 15 (the last prompt token) was rewritten into dst only
    assert torch.equal(eng.cache.k[:, dst, :BS - 1], src_bytes[:, :BS - 1])
    assert _drain(eng)[rid].cached_tokens == 2 * BS - 1
    hit = _greedy(eng, [donor])[0]
    assert hit.cached_tokens == 2 * BS
    cold = _greedy(_prefix_engine(False), [donor])[0]
    assert hit.output_token_ids == cold.output_token_ids


def test_abort_decrefs_shared_blocks():
    eng = _prefix_engine()
    _greedy(eng, [SYS])
    a = eng.submit(SYS + [101], SamplingParams(max_new_tokens=6))
    b = eng.submit(SYS + [102], SamplingParams(max_new_tokens=6))
    eng.step()
    shared = eng._block_map[a][:2]
    eng.abort(a)
    assert [eng.allocator.refcount(blk) for blk in shared] == [1, 1]
    out = _drain(eng)[b]
    assert len(out.output_token_ids) == 6
    assert eng.allocator.live_count == 0
    cold = _greedy(_prefix_engine(False), [SYS + [102]], max_new=6)[0]
    assert out.output_token_ids == cold.output_token_ids


def test_eviction_under_pressure_stays_correct():
    kw = dict(n_slots=2, n_blocks=6, max_seq=32)
    warm, cold = _prefix_engine(True, **kw), _prefix_engine(False, **kw)
    prompts = [[i + 1] * 9 + [i + 2] * 8 for i in range(5)]
    w = [_greedy(warm, [p], max_new=3)[0].output_token_ids for p in prompts]
    c = [_greedy(cold, [p], max_new=3)[0].output_token_ids for p in prompts]
    assert w == c
    assert warm.allocator.live_count == 0
    assert warm.allocator.free_count + warm.allocator.cached_count == 6


def test_cow_pin_degrades_instead_of_livelock():
    """In a pool sized exactly to the request's worst case the COW pin's
    transient extra block never fits: the gate degrades the tail to a
    recomputed miss and admits at once."""
    streams = []
    for prefix in (True, False):
        eng = _prefix_engine(prefix, n_slots=2, n_blocks=3, max_seq=32)
        _greedy(eng, [SYS], max_new=2)
        a = eng.submit(SYS[:16], SamplingParams(max_new_tokens=9))
        eng.step()
        assert len(eng.scheduler.running()) == 1
        out = _drain(eng)[a]
        streams.append(out.output_token_ids)
        if prefix:
            assert out.cached_tokens == BS
    assert streams[0] == streams[1]


def test_full_hit_keeps_frontier_covered():
    """A full hit feeds only the last prompt token: the feed starts at
    ``n - 1`` and the paged walk's live bound covers that frontier (the
    port keeps no advisory ``length``; ``max_live`` is the bound the JAX
    suite's length invariant protects)."""
    eng = _prefix_engine(n_slots=1)
    _greedy(eng, [SYS], max_new=2)
    _greedy(eng, [[5, 6]], max_new=2)
    a = eng.submit(SYS, SamplingParams(max_new_tokens=2))
    req = eng._requests[a]
    eng.scheduler.admit()
    eng._admit(req)
    assert req.pos == req.prefix_skip == len(SYS) - 1
    assert eng._live_bucket([req]) >= len(SYS)
    out = _drain(eng)[a]
    cold = _greedy(_prefix_engine(False, n_slots=1), [SYS], max_new=2)[0]
    assert out.output_token_ids == cold.output_token_ids


def test_admission_with_hits_beats_cold_capacity():
    ps = SamplingParams(max_new_tokens=4)
    cold = _prefix_engine(False, n_slots=3, n_blocks=5, max_seq=32)
    cold.submit(SYS + [9], ps)
    cold.submit(SYS + [8], ps)
    cold.step()
    assert len(cold.scheduler.running()) == 1
    eng = _prefix_engine(True, n_slots=3, n_blocks=5, max_seq=32)
    _greedy(eng, [SYS], max_new=2)
    a, b = eng.submit(SYS + [9], ps), eng.submit(SYS + [8], ps)
    eng.step()
    assert len(eng.scheduler.running()) == 2
    assert eng.allocator.live_count == 4
    final = _drain(eng)
    assert final[a].cached_tokens == final[b].cached_tokens == 16


# ---------------------------------------------------------------------------
# Growth and preemption inside the port (test_preemption.py)
# ---------------------------------------------------------------------------

PROMPTS = [[5, 6, 7], [9, 8, 7, 6, 5], [3, 1, 4, 1, 5, 9, 2, 6], [42, 17]]


def _grow_engine(**kw):
    args = dict(n_slots=3, max_seq=32, max_prompt=16, seed=0,
                cache_kind="paged", block_size=4, prefill_chunk=4,
                device="cpu")
    args.update(kw)
    return Engine(EngineConfig(model=SMOLLM, policy="w4a16kv8", **args))


def _contended(**kw):
    """Two requests that each need 4 blocks in a 4-block pool: the
    younger is preempted at least once."""
    eng = _grow_engine(enable_block_growth=True, n_slots=2, n_blocks=4,
                       **kw)
    sp = SamplingParams(max_new_tokens=12)
    return eng, sp, eng.submit(PROMPTS[0], sp), eng.submit(PROMPTS[1], sp)


def test_uncontended_growth_identical_and_no_preemption():
    outs = []
    for kw in (dict(), dict(enable_block_growth=True),
               dict(enable_block_growth=True, reserve_headroom_blocks=2)):
        eng = _grow_engine(**kw)
        rids = [eng.submit(p, SamplingParams(max_new_tokens=8))
                for p in PROMPTS]
        final = _drain(eng)
        assert all(final[r].num_preemptions == 0 for r in rids)
        outs.append([final[r].output_token_ids for r in rids])
    assert outs[0] == outs[1] == outs[2]


def test_growth_admits_prompt_blocks_and_grows_at_boundaries():
    eng = _grow_engine(enable_block_growth=True, n_slots=1)
    eng.submit([1, 2, 3, 4, 5], SamplingParams(max_new_tokens=20))
    eng.step()
    assert eng.allocator.live_count == 2           # reservation: 6
    _drain(eng)
    eng = _grow_engine(enable_block_growth=True, n_slots=1)
    eng.submit([1, 2, 3], SamplingParams(max_new_tokens=12))
    held = []
    while not eng.scheduler.idle:
        eng.step()
        held.append(eng.allocator.live_count)
        row = eng.cache.block_table[0]
        mapped = int((row < eng.n_blocks).sum())
        assert mapped == held[-1]                  # device table follows
    assert held[0] == 1 and held[-1] == 0 and max(held) == 4
    assert sorted(set(held[:-1])) == [1, 2, 3, 4]


def test_infeasible_worst_case_still_rejected_at_submit():
    eng = _grow_engine(enable_block_growth=True, n_slots=2, n_blocks=2)
    with pytest.raises(EngineError, match="KV blocks"):
        eng.submit([1, 2, 3], SamplingParams(max_new_tokens=32))


@pytest.mark.parametrize("sampled", [False, True])
def test_preempted_stream_identical_to_uncontended(sampled):
    """The victim recovers with exactly the uncontended stream — greedy,
    and seeded sampling, whose draws are keyed by the number of tokens
    produced, not by engine iterations."""
    sp = SamplingParams(max_new_tokens=12, temperature=0.8 if sampled
                        else 0.0, top_k=50, seed=3)
    eng = _grow_engine(enable_block_growth=True, n_slots=2, n_blocks=4)
    r0, r1 = eng.submit(PROMPTS[0], sp), eng.submit(PROMPTS[1], sp)
    final = _drain(eng)
    assert final[r1].num_preemptions >= 1
    assert final[r0].num_preemptions == 0
    ref = _grow_engine(enable_block_growth=True, n_slots=2)
    a0, a1 = ref.submit(PROMPTS[0], sp), ref.submit(PROMPTS[1], sp)
    want = _drain(ref)
    assert final[r0].output_token_ids == want[a0].output_token_ids
    assert final[r1].output_token_ids == want[a1].output_token_ids
    assert eng.allocator.free_count == 4 and not eng._block_map


def test_replayed_tokens_not_restreamed():
    eng, sp, r0, r1 = _contended()
    per_rid = {r0: [], r1: []}
    preempted_iters = 0
    for _ in range(500):
        if eng.scheduler.idle:
            break
        for out in eng.step():
            assert len(out.new_token_ids) == 1
            per_rid[out.rid].extend(out.new_token_ids)
            assert out.output_token_ids == per_rid[out.rid]
        if any(r.status == Status.PREEMPTED for r in eng._requests.values()):
            preempted_iters += 1
    assert eng.scheduler.idle and preempted_iters > 0
    assert len(per_rid[r0]) == len(per_rid[r1]) == 12


def test_recovery_is_chunked_not_per_token():
    eng, sp, r0, r1 = _contended()
    final = _drain(eng)
    vic = final[r1]
    assert vic.num_preemptions >= 1 and vic.replay_iterations >= 1
    cap = -(-(len(PROMPTS[1]) + sp.max_new_tokens) // eng.prefill_chunk)
    assert vic.replay_iterations <= vic.num_preemptions * cap
    assert vic.recovery_time > 0
    assert final[r0].replay_iterations == 0
    assert final[r0].recovery_time == 0


def test_higher_admitted_concurrency_than_reservation():
    def peak_running(**kw):
        eng = _grow_engine(n_slots=6, n_blocks=6, block_size=8, max_seq=64,
                           **kw)
        for p in PROMPTS + PROMPTS[:2]:
            eng.submit(list(p), SamplingParams(max_new_tokens=8))
        peak = 0
        while not eng.scheduler.idle:
            eng.step()
            peak = max(peak, len(eng.scheduler.running()))
        assert eng.allocator.free_count == 6
        return peak
    assert peak_running() == 3
    assert peak_running(enable_block_growth=True) == 6


def test_fcfs_order_survives_preemption():
    eng = _grow_engine(enable_block_growth=True, n_slots=2, n_blocks=4)
    sp = SamplingParams(max_new_tokens=10)
    rids = [eng.submit([i + 1, 2, 3], sp) for i in range(4)]
    finished = []
    while not eng.scheduler.idle:
        finished.extend(o.rid for o in eng.step() if o.finished)
    assert finished == rids
    assert eng.allocator.free_count == 4


def test_abort_preempted_request():
    eng, sp, r0, r1 = _contended()
    victim = None
    for _ in range(200):
        eng.step()
        req = eng._requests.get(r1)
        if req is not None and req.status == Status.PREEMPTED:
            victim = req
            break
    assert victim is not None, "preemption never fired"
    out = eng.abort(r1)
    assert out.finished and out.finish_reason == "abort"
    assert out.num_preemptions >= 1
    assert len(_drain(eng)[r0].output_token_ids) == 12
    assert eng.allocator.free_count == 4


def test_preempted_stream_iterator_recovers():
    eng = _grow_engine(enable_block_growth=True, n_slots=2, n_blocks=4)
    sp = SamplingParams(max_new_tokens=12)
    r0 = eng.submit(PROMPTS[0], sp)
    toks = [t for o in eng.stream(PROMPTS[1], sp) for t in o.new_token_ids]
    ref = _grow_engine(enable_block_growth=True, n_slots=2).generate(
        [PROMPTS[1]], sp)[0]
    assert toks == ref.output_token_ids
    assert len(_drain(eng)[r0].output_token_ids) == 12


def test_preempted_prefix_hit_still_identical():
    """Growth + prefix caching + preemption: the victim's published prompt
    blocks soften its recompute (cached_tokens > 0 on re-admission) and
    the streams equal a reservation engine's without caching."""
    sysp = [7, 7, 7, 7, 3, 1, 4, 1]
    sp = SamplingParams(max_new_tokens=10)
    eng = _grow_engine(enable_block_growth=True, enable_prefix_caching=True,
                       n_slots=2, n_blocks=6)
    r0, r1 = eng.submit(sysp + [5], sp), eng.submit(sysp + [9], sp)
    final = _drain(eng)
    assert final[r1].num_preemptions >= 1
    assert final[r1].cached_tokens > 0
    ref = _grow_engine(n_slots=2)
    a0, a1 = ref.submit(sysp + [5], sp), ref.submit(sysp + [9], sp)
    want = _drain(ref)
    assert final[r0].output_token_ids == want[a0].output_token_ids
    assert final[r1].output_token_ids == want[a1].output_token_ids
    assert eng.allocator.live_count == 0


# ---------------------------------------------------------------------------
# The serving CLI
# ---------------------------------------------------------------------------


def test_cli_flags_reach_the_engine(capsys):
    """``--enable-prefix-caching``, ``--enable-block-growth`` and
    ``--reserve-headroom-blocks`` build the config the JAX CLI's flags
    build, and `launch/serve.py` serves with them on the CPU."""
    import argparse

    from repro_torch.launch.serve import main
    flags = ["--cache-kind", "paged", "--enable-prefix-caching",
             "--enable-block-growth", "--reserve-headroom-blocks", "1",
             "--device", "cpu"]
    cfg = EngineConfig.from_cli(EngineConfig.add_cli_args(
        argparse.ArgumentParser()).parse_args(flags))
    assert (cfg.enable_prefix_caching, cfg.enable_block_growth,
            cfg.reserve_headroom_blocks) == (True, True, 1)
    assert main(flags + ["--requests", "4", "--rate", "1000", "--max-new",
                         "4", "--prompt-len", "20", "--block-size", "8",
                         "--prefill-chunk", "8", "--n-blocks", "10",
                         "--max-seq", "32"]) == 0
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "prefix-cached tokens" in out
