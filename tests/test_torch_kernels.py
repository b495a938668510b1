"""The port's kernel wrappers (plain versions, on the CPU) against the JAX
package's kernels.

* GEMM: ``repro_torch.core.gemm.mp_matmul`` against
  ``repro.core.gemm.mp_matmul(impl="xla")`` (the JAX engine's path) and
  against the Pallas kernel ``mpgemm_2d`` in interpret mode.  All three
  multiply the same bf16-rounded dequantized weights and accumulate in
  f32 in different orders, so outputs may differ by one bf16 ulp:
  |Δ| ≤ 2^-7 · max|y|.
* Paged attention: ``repro_torch.kernels.ops.kvattn_decode_paged``
  against ``repro.kernels.ops.kvattn_decode_paged`` (the Pallas kernel,
  interpret mode) over the same pool bytes.  Same rounding points, but the
  port's plain version rounds the softmax weights to bf16 relative to the
  global row max and the flash kernel relative to its running max (each
  ≤ 2^-9 relative), plus one bf16 ulp of the output: |Δ| ≤ 2e-2 on
  outputs of magnitude ≤ ~3.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gemm as JG
from repro.core import packing as JP
from repro.core import paged_kvcache as JPKV
from repro.core import precision as JPR
from repro.kernels import mpgemm as JMG
from repro.kernels import ops as JOPS
from repro_torch.convert import to_tensor
from repro_torch.core import gemm as TG
from repro_torch.core import packing as TP
from repro_torch.core import paged_kvcache as TPKV
from repro_torch.core import precision as TPR
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels.mpgemm import mpgemm_w4a16
from repro_torch.kernels.paged_kvattn import paged_kvattn_kv8

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


def _paged_pair(seed, B, Hkv, D, bs, bps, lengths):
    """A JAX paged cache holding ``lengths[b]`` tokens per slot through a
    shuffled table with a sentinel tail, and the port's view of the same
    pool bytes."""
    rng = np.random.default_rng(seed)
    nb = B * bps + 3
    cj = JPKV.init_paged(B, nb, bs, Hkv, D, POL_J.kv, blocks_per_slot=bps)
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
    cj = JPKV.append_paged(cj, k, v, jnp.zeros((B,), jnp.int32), POL_J.kv,
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
    before = paged_kvattn_kv8.launches
    out_t = TOPS.kvattn_decode_paged(_t(q), ct, POL_T.kv,
                                     torch.tensor(pos, dtype=torch.int32),
                                     window=window, max_live=max_live)
    assert paged_kvattn_kv8.launches == before       # plain version on CPU
    assert out_t.shape == tuple(out_j.shape)
    err = np.abs(out_t.float().numpy() - np.asarray(out_j, np.float32)).max()
    assert err <= 2e-2, err


def test_cpu_wrappers_never_count_launches():
    pt = TP.pack_weight(torch.randn(64, 64), bits=4, group=64, block_k=64,
                        block_n=64)
    before = mpgemm_w4a16.launches
    mpgemm_w4a16(torch.randn(5, 64).to(torch.bfloat16), pt)
    assert mpgemm_w4a16.launches == before


def test_wrappers_reject_other_devices():
    meta = torch.empty((4, 64), dtype=torch.bfloat16, device="meta")
    pt = TP.pack_weight(torch.randn(64, 64), bits=4, group=64, block_k=64,
                        block_n=64)
    with pytest.raises(RuntimeError, match="unsupported device"):
        mpgemm_w4a16(meta, pt)
