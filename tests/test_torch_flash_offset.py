"""Flash attention at a query position offset (row t at ``pos_offset + t``),
on the CPU: the plain versions of ``csrc/flash_prefill.cu`` and
``csrc/flash_prefill_bwd.cu``, the backward's plan and the cost counter.

* The port's ``core.attention.flash_attention(pos_offset=o)`` (its plain
  tile walk) against JAX's ``core.attention.flash_attention(pos_offset=o)``
  (its XLA walk) on the same numpy inputs at 2e-2, the bar of
  ``test_torch_attention.py`` (both round p to bf16 before the PV
  product, against running maxima of other tiles): causal Sq < Sk with
  ``o + Sq < Sk`` and ``o + Sq == Sk``, an int window and a window given
  as a 0-d tensor, Sq > Sk, D 64 and D 288.
* ``ref.flash_prefill_bwd_ref`` at an offset, in f64 (no rounding),
  against autograd of the f64 oracle at 1e-9.
* ``bwd_plan`` at an offset covers each kept (row, key) pair exactly once
  in both passes.
* ``cost.kept_pairs`` at an offset equals the mask's count, and
  ``cost.key_range`` (the keys the byte count charges) equals the keys
  some row keeps, the forward kernel's frontier and the backward plan's
  key tiles at every SP rank's offset.
* At offset 0 the walk keeps its bits: the rows of a whole causal walk
  from position o on equal the walk of those rows at offset o, bit for
  bit, when o is a multiple of the row tile (the same tiles in the same
  order), and ``pos_offset=0`` is the default's call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro_torch.convert import to_tensor
from repro_torch.core import attention as TA
from repro_torch.kernels import cost as KC
from repro_torch.kernels.flashprefill import (BWD_KEYS, BWD_ROWS, bwd_plan,
                                             pick_tile)
from repro_torch.kernels.ref import (NO_WINDOW, flash_prefill_bwd_ref,
                                     flash_prefill_walk)
from torch_defaults import package_defaults  # noqa: F401

torch.set_num_threads(1)

#: B, Sq, Sk, H, Hkv, D, offset, window
OFFSET_CASES = [
    (1, 40, 100, 4, 2, 64, 60, None),     # o + Sq == Sk, rep 2
    (2, 48, 130, 4, 4, 64, 30, None),     # o + Sq < Sk, rep 1
    (1, 64, 128, 8, 2, 64, 64, 37),       # window inside a tile, rep 4
    (1, 48, 32, 2, 1, 64, 0, None),       # Sq > Sk at offset 0
    (1, 32, 96, 4, 1, 288, 64, None),     # gemma3's head dim
    (1, 40, 80, 4, 1, 288, 40, 24),       # D 288 with a window
]


def _qkv(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, h, D)).astype(np.float32) * 0.5
            for s, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv))]


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_offset_matches_jax(case):
    B, Sq, Sk, H, Hkv, D, off, window = case
    q, k, v = _qkv(sum(case[:6]), B, Sq, Sk, H, Hkv, D)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (to_tensor(np.asarray(a), "cpu") for a in (jq, jk, jv))
    out_j = JA.flash_attention(jq, jk, jv, causal=True, window=window,
                               pos_offset=off)
    out_t = TA.flash_attention(tq, tk, tv, causal=True, window=window,
                               pos_offset=off)
    assert tuple(out_t.shape) == out_j.shape
    err = np.abs(out_t.float().numpy() -
                 np.asarray(out_j, np.float32)).max()
    assert err <= 2e-2, err
    if window is not None:       # a window as a 0-d tensor: the same call
        again = TA.flash_attention(tq, tk, tv, causal=True,
                                   window=torch.tensor(window),
                                   pos_offset=torch.tensor(off))
        assert torch.equal(again, out_t)


def _oracle(q, k, v, causal, window, off):
    """Full attention in q's dtype, row t at position off + t."""
    B, H, Sq, D = q.shape
    rep = H // k.shape[1]
    kk, vv = (t.repeat_interleave(rep, 1) for t in (k, v))
    s = q @ kk.transpose(-1, -2) / D ** 0.5
    qpos = off + torch.arange(Sq)[:, None]
    kpos = torch.arange(k.shape[2])[None]
    mask = kpos > qpos - window
    if causal:
        mask &= kpos <= qpos
    return torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ vv


@pytest.mark.parametrize("case", [(2, 1, 24, 70, 32, True, NO_WINDOW, 46),
                                  (4, 2, 33, 90, 64, True, 20, 40),
                                  (2, 2, 16, 50, 32, False, 12, 30)])
def test_bwd_ref_at_offset_matches_autograd(case):
    H, Hkv, Sq, Sk, D, causal, window, off = case
    g = torch.Generator().manual_seed(Sq + Sk)
    q, k, v, do = (torch.randn(s, generator=g, dtype=torch.float64)
                   for s in ((1, H, Sq, D), (1, Hkv, Sk, D), (1, Hkv, Sk, D),
                             (1, H, Sq, D)))
    out, lse = flash_prefill_walk(q, k, v, causal, window, Sk, 16, 32,
                                  return_lse=True, pos_offset=off)
    got = flash_prefill_bwd_ref(q, k, v, out, lse, do, causal, window, Sk,
                                pos_offset=off)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_out = _oracle(*leaves, causal, window, off)
    assert (out - ref_out).abs().max().item() < 1e-9
    ref_out.backward(do)
    for a, leaf in zip(got, leaves):
        assert (a - leaf.grad).abs().max().item() < 1e-9


#: B, H, Hkv, Sq, Sk, D, causal, window, offset — the SP ranks' shapes
#: (cut in depth), a window crossing rank boundaries, Sq > Sk
PLAN_CASES = [
    (1, 56, 8, 256, 4096, 128, True, None, 3840),   # arctic's last rank
    (1, 56, 8, 256, 4096, 128, True, None, 1024),
    (2, 4, 1, 512, 2048, 288, True, 1024, 1536),    # gemma3's last rank
    (2, 4, 1, 512, 2048, 288, True, 1024, 512),
    (1, 4, 2, 200, 700, 64, True, 130, 333),
    (1, 6, 6, 96, 64, 32, True, None, 0),
]


@pytest.mark.parametrize("card", [(132, (2, 2)), (16, (3, 3))])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_at_offset_covers_each_kept_pair_once(case, card):
    B, H, Hkv, Sq, Sk, D, causal, window, off = case
    win, rep = NO_WINDOW if window is None else window, H // Hkv
    NR = rep * Sq
    plan = bwd_plan(B, H, Hkv, Sq, Sk, D, causal, win, Sk, sms=card[0],
                    resident=card[1], pos_offset=off)
    pos = off + np.arange(NR) // rep                  # each packed row's
    n_kv = -(-Sk // BWD_KEYS)
    k0 = np.arange(n_kv)[:, None] * BWD_KEYS
    hi = np.minimum(k0 + BWD_KEYS, Sk)
    if causal:
        hi = np.minimum(hi, pos[None] + 1)
    kept = np.maximum(hi - np.maximum(k0, pos[None] - win + 1), 0)
    total = int(kept.sum())
    assert total == H // Hkv * KC.kept_pairs(Sq, Sk, causal, window, off)
    cover = np.zeros((n_kv, NR), np.int32)
    for x, rb, re, _ in plan.kv_items:
        assert 0 <= rb <= re <= NR
        cover[x, rb:re] += 1
    assert (cover[kept > 0] == 1).all() and (cover <= 1).all()
    # dQ: each row tile's items cover every key its rows keep, once
    keys = np.zeros((NR, Sk), np.int32)
    for y, kb, ke, _ in plan.q_items:
        keys[y * BWD_ROWS:(y + 1) * BWD_ROWS, kb:min(ke, Sk)] += 1
    kpos = np.arange(Sk)[None]
    mask = kpos > pos[:, None] - win
    if causal:
        mask &= kpos <= pos[:, None]
    assert (keys[mask] == 1).all() and (keys <= 1).all()


@pytest.mark.parametrize("args", [(40, 100, True, None, 60),
                                  (40, 100, True, 17, 60),
                                  (64, 90, True, 30, 0),
                                  (50, 20, False, 8, 11),
                                  (300, 2000, True, None, 1700)])
def test_kept_pairs_at_offset_counts_the_mask(args):
    Sq, seq, causal, window, off = args
    qpos = off + np.arange(Sq)[:, None]
    kpos = np.arange(seq)[None]
    mask = kpos > qpos - (NO_WINDOW if window is None else window)
    if causal:
        mask &= kpos <= qpos
    assert KC.kept_pairs(Sq, seq, causal, window, off) == int(mask.sum())


#: (B, S, H, Hkv, D, window, ranks): the SP shapes of chip_smoke.py's
#: multidevice phase, every rank's offset
SP_SHAPES = [(1, 4096, 56, 8, 128, None, 16), (2, 2048, 4, 1, 288, 1024, 4)]


def _forward_frontier(B, H, Hkv, Sq, seq, D, causal, window, off):
    """Union of the key ranges the forward kernel's blocks walk: the
    frontier of ``csrc/flash_prefill.cu`` (its row tile from
    ``pick_tile``; packed row r is token r // rep), before rounding to key
    tiles."""
    rep, bq = H // Hkv, pick_tile(B, H, Hkv, Sq, D)[0]
    win, NR = NO_WINDOW if window is None else window, rep * Sq
    los, his = [], []
    for r0 in range(0, NR, bq):
        tq0, tq1 = off + r0 // rep, off + (min(r0 + bq, NR) - 1) // rep
        hi = min(seq, tq1 + 1) if causal else seq
        los.append(max(0, tq0 - win + 1))
        his.append(hi)
    return min(los), max(his)


@pytest.mark.parametrize("shape", SP_SHAPES, ids=["arctic", "gemma3"])
def test_key_range_is_the_kernels_frontier(shape):
    """``cost.key_range`` — the keys the byte count charges — is the set
    of keys some row keeps, the forward kernel's frontier, and the key
    tiles the backward's plan walks rows for, at every SP rank's
    offset."""
    B, S, H, Hkv, D, window, n = shape
    Sq = S // n
    for off in range(0, S, Sq):
        lo, hi = KC.key_range(Sq, S, True, window, off)
        qpos = off + np.arange(Sq)[:, None]
        kpos = np.arange(S)[None]
        mask = (kpos <= qpos) & (kpos > qpos - (
            NO_WINDOW if window is None else window))
        kept = np.flatnonzero(mask.any(0))
        assert (lo, hi) == (kept[0], kept[-1] + 1), off
        assert (lo, hi) == _forward_frontier(B, H, Hkv, Sq, S, D, True,
                                             window, off), off
        plan = bwd_plan(B, H, Hkv, Sq, S, D, True,
                        NO_WINDOW if window is None else window, S,
                        pos_offset=off)
        # key tiles with rows to walk (a dead tile's block only zeroes
        # its dK / dV rows)
        items = plan.kv_items
        tiles = np.unique(items[items[:, 2] > items[:, 1], 0])
        assert tiles.tolist() == list(range(lo // BWD_KEYS,
                                            -(-hi // BWD_KEYS))), off
        # bytes: q, out; k, v over [lo, hi) only
        _, nbytes = KC.flash_forward(B, H, Hkv, Sq, S, D, S, True, window,
                                     False, off)
        assert nbytes == 4 * B * D * (H * Sq + Hkv * (hi - lo))
        _, nbytes = KC.flash_backward(B, H, Hkv, Sq, S, D, S, True, window,
                                      off)
        assert nbytes == 2 * D * (4 * B * H * Sq + 2 * B * Hkv * (
            hi - lo + S)) + 4 * B * H * Sq


@pytest.mark.parametrize("D,window", [(64, NO_WINDOW), (288, 40)])
def test_offset_walk_is_the_whole_walks_rows(D, window):
    """The walk at offset o of rows [o, S) equals rows [o, S) of the whole
    walk, bit for bit (block_q divides o): the offset only moves each
    row tile's frontier, as at offset 0."""
    g = torch.Generator().manual_seed(D)
    S, o, bq, bk = 96, 32, 16, 64
    q, k, v = (torch.randn(s, generator=g).bfloat16()
               for s in ((1, 4, S, D), (1, 1, S, D), (1, 1, S, D)))
    whole, lse = flash_prefill_walk(q, k, v, True, window, S, bq, bk,
                                    return_lse=True)
    part, plse = flash_prefill_walk(q[:, :, o:].contiguous(), k, v, True,
                                    window, S, bq, bk, return_lse=True,
                                    pos_offset=o)
    assert torch.equal(part, whole[:, :, o:]) and \
        torch.equal(plse, lse[:, :, o:])
    assert torch.equal(flash_prefill_walk(q, k, v, True, window, S, bq, bk,
                                          pos_offset=0), whole)
