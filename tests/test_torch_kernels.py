"""The port's kernel wrappers (plain versions, on the CPU) against the JAX
package's kernels.

* GEMM: ``repro_torch.core.gemm.mp_matmul`` against
  ``repro.core.gemm.mp_matmul(impl="xla")`` (the JAX engine's path) and
  against the Pallas kernels ``mpgemm_2d`` / ``mpgemm_int8_2d`` in
  interpret mode, for w4a16, w8a16, wfp8a16 (packed as int8), w4a8 and
  w8a8.  A16: all three multiply the same bf16-rounded dequantized weights
  and accumulate in f32 in different orders; A8: all three take the same
  per-token int8 activations and exact integer group partials, then sum
  the scaled partials in f32 in different orders.  Either way outputs may
  differ by one bf16 ulp: |Δ| ≤ 2^-7 · max|y|.
* Attention: ``repro_torch.kernels.ops.kvattn_decode`` (dense slab) and
  ``kvattn_decode_paged`` against ``repro.kernels.ops``'s (the Pallas
  kernels, interpret mode) over the same slab / pool bytes, for every KV
  format.  Same rounding points and the same tile walk, but the sums
  inside a tile run in other orders, so a softmax weight may round to
  bf16 on the other side of a tie (≤ 2^-9 relative), plus one bf16 ulp of
  the output: |Δ| ≤ 2e-2 on outputs of magnitude ≤ ~3.
* Dense ≡ paged inside the port: the two plain versions give bitwise
  equal outputs on the same logical contents.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gemm as JG
from repro.core import kvcache as JKV
from repro.core import packing as JP
from repro.core import paged_kvcache as JPKV
from repro.core import precision as JPR
from repro.core import quantize as JQ
from repro.kernels import mpgemm as JMG
from repro.kernels import ops as JOPS
from repro_torch.convert import to_tensor
from repro_torch.core import gemm as TG
from repro_torch.core import kvcache as TKV
from repro_torch.core import packing as TP
from repro_torch.core import paged_kvcache as TPKV
from repro_torch.core import precision as TPR
from repro_torch.core import quantize as TQ
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.kvattn import kvattn
from repro_torch.kernels.mpgemm import mpgemm_a16, mpgemm_int8
from repro_torch.kernels.paged_kvattn import paged_kvattn

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

POL_J = JPR.get_policy("w4a16kv8")
POL_T = TPR.get_policy("w4a16kv8")


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


# K, N, bk, bn: the reduced smollm tiles plus the full model's tile shapes
GEMM_SHAPES = [(320, 320, 64, 64), (320, 640, 64, 128), (640, 320, 128, 64),
               (128, 192, 64, 96), (128, 192, 32, 96)]


@pytest.mark.parametrize("M", [3, 12])
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_mp_matmul_matches_jax(shape, M):
    K, N, bk, bn = shape
    rng = np.random.default_rng(K * N + M)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    pj = JP.pack_weight(jnp.asarray(w), bits=4, group=bk, block_k=bk,
                        block_n=bn)
    pt = TP.pack_weight(torch.from_numpy(w), bits=4, group=bk, block_k=bk,
                        block_n=bn)
    yt = TG.mp_matmul(_t(x), pt, POL_T).float().numpy()
    y_xla = np.asarray(JG.mp_matmul(x, pj, POL_J, impl="xla"), np.float32)
    y_pl = np.asarray(JMG.mpgemm_2d(x, pj.data, pj.scales, bits=4, group=bk,
                                    block_m=M, interpret=True), np.float32)
    for ref in (y_xla, y_pl):
        tol = 2 ** -7 * np.abs(ref).max()
        assert np.abs(yt - ref).max() <= tol


# policies whose packed GEMM is not w4a16, and the JAX kernel each takes
OTHER_GEMMS = ["w8a16kv8", "wfp8a16kv8", "w4a8kv8", "w8a8kv8"]


@pytest.mark.parametrize("M", [3, 12])
@pytest.mark.parametrize("shape", GEMM_SHAPES)
@pytest.mark.parametrize("policy", OTHER_GEMMS)
def test_other_policy_gemms_match_jax(policy, shape, M):
    K, N, bk, bn = shape
    pol_j, pol_t = JPR.get_policy(policy), TPR.get_policy(policy)
    assert pol_t.int8_matmul == pol_j.int8_matmul
    bits = 8 if pol_t.weights.is_float else pol_t.weights.bits
    rng = np.random.default_rng(K * N + M + bits)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    pj = JP.pack_weight(jnp.asarray(w), bits=bits, group=bk, block_k=bk,
                        block_n=bn)
    pt = TP.pack_weight(torch.from_numpy(w), bits=bits, group=bk,
                        block_k=bk, block_n=bn)
    yt = TG.mp_matmul(_t(x), pt, pol_t).float().numpy()
    y_xla = np.asarray(JG.mp_matmul(x, pj, pol_j, impl="xla"), np.float32)
    if pol_j.int8_matmul:
        xq, xs = JQ.quantize_act_per_token(x.astype(jnp.float32), bits=8)
        y_pl = JMG.mpgemm_int8_2d(xq, xs, pj.data, pj.scales, bits=bits,
                                  group=bk, block_m=M, interpret=True)
    else:
        y_pl = JMG.mpgemm_2d(x, pj.data, pj.scales, bits=bits, group=bk,
                             block_m=M, interpret=True)
    for ref in (y_xla, np.asarray(y_pl, np.float32)):
        tol = 2 ** -7 * np.abs(ref).max()
        assert np.abs(yt - ref).max() <= tol


def _paged_pair(seed, B, Hkv, D, bs, bps, lengths, fmt="kv8"):
    """A JAX paged cache holding ``lengths[b]`` tokens per slot through a
    shuffled table with a sentinel tail, and the port's view of the same
    pool bytes."""
    rng = np.random.default_rng(seed)
    nb = B * bps + 3
    spec = JPR.get_policy(f"w4a16{fmt}").kv
    cj = JPKV.init_paged(B, nb, bs, Hkv, D, spec, blocks_per_slot=bps)
    order = rng.permutation(nb)
    tbl = np.full((B, bps), nb, np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        need = JPKV.blocks_needed(n, bs)
        tbl[b, :need] = order[nxt:nxt + need]
        nxt += need
    cj = dataclasses.replace(cj, block_table=jnp.asarray(tbl))
    T = max(lengths)
    k = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    cj = JPKV.append_paged(cj, k, v, jnp.zeros((B,), jnp.int32), spec,
                           valid=jnp.asarray(lengths, jnp.int32))
    ct = TPKV.PagedKVCache(k=_t(cj.k), v=_t(cj.v),
                           k_scale=_t(cj.k_scale[..., 0]),
                           v_scale=_t(cj.v_scale[..., 0]),
                           block_table=torch.from_numpy(tbl))
    return cj, ct


ATTN_CASES = [
    # B, Hkv, rep, D, bs, bps, pos, T, window, max_live
    (2, 2, 2, 32, 8, 8, [36, 19], 1, None, None),      # ragged decode
    (2, 2, 2, 32, 8, 8, [33, 11], 4, None, None),      # chunk, partial block
    (2, 2, 2, 32, 8, 8, [44, 20], 4, 16, None),        # window
    (2, 2, 2, 32, 8, 8, [17, 9], 4, None, 18),         # live-bounded walk
    (2, 5, 1, 64, 8, 4, [4, 0], 4, None, 8),           # reduced smollm (rep 1)
    (2, 5, 3, 64, 16, 4, [20, 3], 1, None, 32),        # full smollm heads
    (2, 2, 2, 32, 4, 8, [9, 17], 4, 6, None),          # block_size 4
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_paged_attention_matches_jax(case):
    B, Hkv, rep, D, bs, bps, pos, T, window, max_live = case
    cj, ct = _paged_pair(sum(pos) + T, B, Hkv, D, bs, bps,
                         [p + T for p in pos])
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.standard_normal((B, T, Hkv * rep, D)), jnp.bfloat16)
    out_j = JOPS.kvattn_decode_paged(q, cj, POL_J.kv,
                                     jnp.asarray(pos, jnp.int32),
                                     window=window, max_live=max_live)
    before = paged_kvattn.launches
    out_t = TOPS.kvattn_decode_paged(_t(q), ct, POL_T.kv,
                                     torch.tensor(pos, dtype=torch.int32),
                                     window=window, max_live=max_live)
    assert paged_kvattn.launches == before            # plain version on CPU
    assert out_t.shape == tuple(out_j.shape)
    err = np.abs(out_t.float().numpy() - np.asarray(out_j, np.float32)).max()
    assert err <= 2e-2, err


def _paged_vs_jax(case, fmt):
    B, Hkv, rep, D, bs, bps, pos, T, window, max_live = case
    cj, ct = _paged_pair(sum(pos) + T, B, Hkv, D, bs, bps,
                         [p + T for p in pos], fmt)
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.standard_normal((B, T, Hkv * rep, D)), jnp.bfloat16)
    out_j = JOPS.kvattn_decode_paged(
        q, cj, JPR.get_policy(f"w4a16{fmt}").kv, jnp.asarray(pos, jnp.int32),
        window=window, max_live=max_live)
    out_t = TOPS.kvattn_decode_paged(
        _t(q), ct, TPR.get_policy(f"w4a16{fmt}").kv,
        torch.tensor(pos, dtype=torch.int32), window=window,
        max_live=max_live)
    assert out_t.shape == tuple(out_j.shape)
    return np.abs(out_t.float().numpy() - np.asarray(out_j, np.float32)).max()


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("fmt", ["kv4", "kvfp8", "kv16"])
def test_paged_attention_other_formats_match_jax(fmt, case):
    err = _paged_vs_jax(case, fmt)
    assert err <= 2e-2, err


def _dense_pair(seed, B, S, Hkv, D, lengths, fmt):
    """A JAX dense slab holding ``lengths[b]`` tokens per slot (the rest
    of the slab zero) and the port's view of the same bytes."""
    rng = np.random.default_rng(seed)
    spec = JPR.get_policy(f"w4a16{fmt}").kv
    cj = JKV.init_cache(B, S, Hkv, D, spec)
    T = max(lengths)
    k = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    cj = JKV.append_per_slot(cj, k, v, jnp.zeros((B,), jnp.int32), spec,
                             valid=jnp.asarray(lengths, jnp.int32))
    ct = TKV.KVCache(k=_t(cj.k), v=_t(cj.v), k_scale=_t(cj.k_scale[..., 0]),
                     v_scale=_t(cj.v_scale[..., 0]))
    return cj, ct


DENSE_CASES = [
    # B, Hkv, rep, D, S, block_s, pos, T, window
    (2, 2, 3, 32, 32, 8, [20, 7], 1, None),            # ragged decode
    (2, 2, 3, 64, 32, 16, [13, 0], 4, None),           # 4-token chunk
    (2, 2, 1, 32, 64, 8, [44, 20], 4, 16),             # window, rep 1
    (2, 5, 1, 64, 32, 16, [4, 9], 4, None),            # reduced smollm
    (2, 2, 3, 64, 64, 8, [60, 33], 1, 12),             # window, decode
]


@pytest.mark.parametrize("case", DENSE_CASES)
@pytest.mark.parametrize("fmt", ["kv8", "kv4", "kvfp8", "kv16"])
def test_dense_attention_matches_jax(fmt, case):
    B, Hkv, rep, D, S, block_s, pos, T, window = case
    cj, ct = _dense_pair(sum(pos) + T, B, S, Hkv, D, [p + T for p in pos],
                         fmt)
    rng = np.random.default_rng(6)
    q = jnp.asarray(rng.standard_normal((B, T, Hkv * rep, D)), jnp.bfloat16)
    out_j = JOPS.kvattn_decode(
        q, cj, JPR.get_policy(f"w4a16{fmt}").kv, jnp.asarray(pos, jnp.int32),
        window=window, block_s=block_s)
    before = kvattn.launches
    out_t = TOPS.kvattn_decode(
        _t(q), ct, TPR.get_policy(f"w4a16{fmt}").kv,
        torch.tensor(pos, dtype=torch.int32), window=window, block_s=block_s)
    assert kvattn.launches == before                  # plain version on CPU
    assert out_t.shape == tuple(out_j.shape)
    err = np.abs(out_t.float().numpy() - np.asarray(out_j, np.float32)).max()
    assert err <= 2e-2, err


@pytest.mark.parametrize("fmt", ["kv8", "kv4", "kvfp8", "kv16"])
def test_dense_and_paged_plain_versions_bitwise(fmt):
    """The same logical contents in a slab and, through a shuffled table,
    in a pool with garbage in every other cell: the two plain versions
    agree bit for bit, for a walk bounded below the table's length too."""
    spec = TPR.get_policy(f"w4a16{fmt}").kv
    B, Hkv, rep, D, bs, bps = 3, 2, 3, 32, 8, 4
    rng = np.random.default_rng(9)
    slab = TKV.init_cache(B, bps * bs, Hkv, D, spec, device="cpu").layer(0)
    nb = B * bps + 2
    pool = TPKV.init_paged(B, nb, bs, Hkv, D, spec, bps,
                           device="cpu").layer(0)
    for buf, sc in ((pool.k, pool.k_scale), (pool.v, pool.v_scale)):
        g = torch.from_numpy(rng.standard_normal((nb, bs, Hkv, D),
                                                 np.float32))
        q8, s8 = TQ.quantize_kv(g.to(torch.bfloat16), spec)
        buf.copy_(q8)
        sc.copy_(s8[..., 0])
    pool.block_table.copy_(torch.from_numpy(
        rng.permutation(nb)[:B * bps].reshape(B, bps).astype(np.int32)))
    lengths = torch.tensor([21, 3, 17], dtype=torch.int32)  # 3 live blocks
    k = torch.from_numpy(rng.standard_normal((B, 21, Hkv, D), np.float32))
    v = torch.from_numpy(rng.standard_normal((B, 21, Hkv, D), np.float32))
    zero = torch.zeros(B, dtype=torch.int32)
    TKV.append_per_slot(slab, k.bfloat16(), v.bfloat16(), zero, spec,
                        valid=lengths)
    TPKV.append_paged(pool, k.bfloat16(), v.bfloat16(), zero, spec,
                      valid=lengths)
    q = torch.from_numpy(rng.standard_normal((B, Hkv, 2 * rep, D),
                                             np.float32)).bfloat16()
    pos = lengths - 2
    dense = TREF.kvattn_ref(q, slab.k, slab.k_scale, slab.v, slab.v_scale,
                            pos, TREF.NO_WINDOW, rep, bs)
    for n_live in (bps, 3):
        paged = TREF.paged_kvattn_ref(q, pool.k, pool.k_scale, pool.v,
                                      pool.v_scale, pool.block_table, pos,
                                      TREF.NO_WINDOW, rep, n_live)
        assert torch.equal(dense, paged)


def test_cpu_wrappers_never_count_launches():
    pt = TP.pack_weight(torch.randn(64, 64), bits=4, group=64, block_k=64,
                        block_n=64)
    x = torch.randn(5, 64).to(torch.bfloat16)
    before = (mpgemm_a16.launches, mpgemm_int8.launches)
    mpgemm_a16(x, pt)
    mpgemm_int8(*TQ.quantize_act_per_token(x.float()), pt)
    assert (mpgemm_a16.launches, mpgemm_int8.launches) == before


def test_wrappers_reject_other_devices():
    meta = torch.empty((4, 64), dtype=torch.bfloat16, device="meta")
    pt = TP.pack_weight(torch.randn(64, 64), bits=4, group=64, block_k=64,
                        block_n=64)
    with pytest.raises(RuntimeError, match="unsupported device"):
        mpgemm_a16(meta, pt)
