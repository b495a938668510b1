"""The flash backward's work plan (``kernels.flashprefill.bwd_plan``), on
the CPU: the table the kernels of ``csrc/flash_prefill_bwd.cu`` read.

* Coverage: at every shape of ``FLASH_GRAD_CASES`` (the card tests) and
  ``chip_smoke.FLASH_BWD_SHAPES`` (the training shapes), the dK/dV items
  of each key tile cover every packed row that keeps one of its keys
  exactly once, and the dQ items of each row tile every key one of its
  rows keeps; the kept pairs the items cover add up to the mask's.
* Scratch: a walk of one split has no slot; the partials stay within
  ``BWD_SCRATCH_CAP`` a pass; a plan that splits nothing allocates none.
* The plain backward summed over the plan's splits — each split's f32
  partial of dK, dV or dQ, added in split order, as the split-sum kernel
  does — against ``ref.flash_prefill_bwd_ref`` within
  ``FLASH_BWD_REL_TOL`` per gradient (the same bf16 rounding points of P
  and dS, f32 sums in another order), for a causal, a windowed and a
  cross-attention case whose plans split both passes.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flashprefill as fp
from repro_torch.kernels.flashprefill import (BWD_KEYS, BWD_ROWS,
                                              BWD_SCRATCH_CAP, bwd_plan)
from repro_torch.kernels.ref import NO_WINDOW, flash_prefill_bwd_ref
from test_torch_cuda import FLASH_BWD_REL_TOL, FLASH_GRAD_CASES

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import FLASH_BWD_SHAPES  # noqa: E402

torch.set_num_threads(1)

#: (B, H, Hkv, Sq, Sk, D, causal, window) of both lists
SHAPES = [tuple(c) for c in FLASH_GRAD_CASES] + \
    [tuple(s[1:]) for s in FLASH_BWD_SHAPES]
#: the plan on an H100 (132 SMs) at the resident blocks the card reports
#: (two or more up to D 128, one above), and on a small card
CARDS = [(132, (2, 2)), (132, (1, 1)), (16, (3, 3))]


def _win(window):
    return NO_WINDOW if window is None else window


def _kept_keys(t, k0, k1, causal, window):
    """Keys of [k0, k1) that token t keeps (k1 already cut at seq)."""
    hi = min(k1, t + 1) if causal else k1
    return max(0, hi - max(k0, t - window + 1))


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_each_kept_pair_once(shape, card):
    B, H, Hkv, Sq, Sk, D, causal, window = shape
    win, rep = _win(window), H // Hkv
    NR = rep * Sq
    plan = bwd_plan(B, H, Hkv, Sq, Sk, D, causal, win, Sk, sms=card[0],
                    resident=card[1])
    tok = np.arange(NR) // rep
    # kept[x][r]: keys of key tile x that packed row r keeps
    n_kv = -(-Sk // BWD_KEYS)
    k0 = np.arange(n_kv)[:, None] * BWD_KEYS
    hi = np.minimum(k0 + BWD_KEYS, Sk)
    if causal:
        hi = np.minimum(hi, tok[None] + 1)
    kept = np.maximum(hi - np.maximum(k0, tok[None] - win + 1), 0)
    total = int(kept.sum())
    cover = np.zeros((n_kv, NR), np.int32)
    covered = 0
    for x, rb, re, _ in plan.kv_items:
        assert 0 <= rb <= re <= NR
        cover[x, rb:re] += 1
        covered += int(kept[x, rb:re].sum())
    assert (cover[kept > 0] == 1).all()
    assert (cover <= 1).all()
    assert covered == total
    assert sorted(set(plan.kv_items[:, 0])) == list(range(n_kv))
    # dQ: per row tile, every key its rows keep, once
    covered = 0
    for y, kb, ke, _ in plan.q_items:
        assert 0 <= kb <= ke and kb < max(Sk, 1) + BWD_ROWS
        for t in range(y * BWD_ROWS // rep,
                       (min(NR, (y + 1) * BWD_ROWS) - 1) // rep + 1):
            r0, r1 = max(t * rep, y * BWD_ROWS), \
                min((t + 1) * rep, (y + 1) * BWD_ROWS)
            covered += (r1 - r0) * _kept_keys(t, kb, min(ke, Sk), causal,
                                              win)
    assert covered == total
    n_q = -(-NR // BWD_ROWS)
    assert sorted(set(plan.q_items[:, 0])) == list(range(n_q))
    for y in range(n_q):      # a tile's splits: contiguous
        its = plan.q_items[plan.q_items[:, 0] == y]
        its = its[np.argsort(its[:, 1])]
        assert (its[1:, 1] == its[:-1, 2]).all()


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_scratch(shape, card):
    B, H, Hkv, Sq, Sk, D, causal, window = shape
    plan = bwd_plan(B, H, Hkv, Sq, Sk, D, causal, _win(window), Sk,
                    sms=card[0], resident=card[1])
    kv_bytes, q_bytes = plan.scratch_bytes(B, Hkv, D)
    assert kv_bytes <= BWD_SCRATCH_CAP and q_bytes <= BWD_SCRATCH_CAP
    for items, tiles in ((plan.kv_items, plan.kv_tiles),
                         (plan.q_items, plan.q_tiles)):
        for w, (n, first) in enumerate(tiles):
            slots = items[items[:, 0] == w, 3]
            assert len(slots) == n
            if n == 1:
                assert slots[0] == -1 and first == -1
            else:        # consecutive slots from the tile's first
                assert sorted(slots) == list(range(first, first + n))
    assert (kv_bytes == 0) == (plan.kv_slots == 0)
    assert (q_bytes == 0) == (plan.q_slots == 0)


def test_plan_without_splits_has_no_scratch(monkeypatch):
    # no room for partials: every walk is one block writing bf16 itself
    monkeypatch.setattr(fp, "BWD_SCRATCH_CAP", 0)
    fp.bwd_plan.cache_clear()
    try:
        plan = bwd_plan(8, 15, 5, 2048, 2048, 64, True, NO_WINDOW, 2048)
    finally:
        fp.bwd_plan.cache_clear()
    assert plan.kv_slots == plan.q_slots == 0
    assert plan.scratch_bytes(8, 5, 64) == (0, 0)
    assert len(plan.kv_items) == 32 and len(plan.q_items) == 96
    assert (plan.kv_items[:, 3] == -1).all()
    assert (plan.q_items[:, 3] == -1).all()


def test_plan_balances_the_causal_triangle():
    # gemma3-1b global at B 2: key tile 0 walks 32x the rows of tile 31,
    # so it takes more splits, and no split holds much more than the mean
    plan = bwd_plan(2, 4, 1, 2048, 2048, 288, True, NO_WINDOW, 2048,
                    resident=(1, 1))
    splits = plan.kv_tiles[:, 0]
    assert splits[0] > splits[-1] >= 1
    rows = plan.kv_items[:, 2] - plan.kv_items[:, 1]
    assert rows.max() <= 2.5 * rows.mean()


def test_plan_starts_dq_first_where_its_walks_are_the_long_pass():
    # whisper's 64 x 1500 cross attention: 6 dQ walks of 24 slices against
    # dK/dV walks of one step; smollm S 2048's and gemma3's dK/dV passes
    # hold the longer schedule
    assert bwd_plan(1, 6, 6, 64, 1500, 64, False, NO_WINDOW, 1500,
                    resident=(2, 3)).dq_first
    assert not bwd_plan(8, 15, 5, 2048, 2048, 64, True, NO_WINDOW, 2048,
                        resident=(2, 3)).dq_first
    assert not bwd_plan(2, 4, 1, 2048, 2048, 288, True, NO_WINDOW, 2048,
                        resident=(1, 1)).dq_first


def _packed(t, B, Hkv, rep, Sq):
    """(B, H, Sq, ...) → (B, Hkv, rep·Sq, ...), row t·rep + g."""
    return t.reshape(B, Hkv, rep, Sq, *t.shape[3:]).transpose(2, 3) \
        .reshape(B, Hkv, rep * Sq, *t.shape[3:])


def _planned_bwd(q, k, v, out, lse, do, causal, window, plan):
    """The plain backward by the plan: each item's f32 partial over its
    rows x keys, a walk's partials summed in split order, then scaled and
    rounded as the kernels do."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    rep = H // Hkv
    NR = rep * Sq
    qp, dop, op = (_packed(t.float(), B, Hkv, rep, Sq) for t in (q, do, out))
    lp = _packed(lse.float(), B, Hkv, rep, Sq)
    delta = (dop * op).sum(-1)
    kf, vf = k.float(), v.float()
    inv = D ** -0.5
    tok = torch.arange(NR) // rep
    kpos = torch.arange(Sk)

    def terms(r0, r1, k0, k1):
        t, kp = tok[r0:r1, None], kpos[None, k0:k1]
        mask = kp > t - window
        if causal:
            mask &= kp <= t
        s = qp[:, :, r0:r1] @ kf[:, :, k0:k1].transpose(-1, -2) * inv
        p = torch.where(mask, torch.exp(s - lp[:, :, r0:r1, None]), 0.)
        dp = dop[:, :, r0:r1] @ vf[:, :, k0:k1].transpose(-1, -2)
        ds = p * (dp - delta[:, :, r0:r1, None])
        return p.bfloat16().float(), ds.bfloat16().float()

    def in_split_order(items):
        return items[np.lexsort((items[:, 1], items[:, 0]))]

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for x, rb, re, _ in in_split_order(plan.kv_items):
        k0, k1 = x * BWD_KEYS, min((x + 1) * BWD_KEYS, Sk)
        if re > rb:
            p, ds = terms(rb, re, k0, k1)
            dv[:, :, k0:k1] += p.transpose(-1, -2) @ dop[:, :, rb:re]
            dk[:, :, k0:k1] += ds.transpose(-1, -2) @ qp[:, :, rb:re]
    dqp = torch.zeros_like(qp)
    for y, kb, ke, _ in in_split_order(plan.q_items):
        r0, r1 = y * BWD_ROWS, min((y + 1) * BWD_ROWS, NR)
        ke = min(ke, Sk)
        if ke > kb:
            _, ds = terms(r0, r1, kb, ke)
            dqp[:, :, r0:r1] += ds @ kf[:, :, kb:ke]
    dq = dqp.reshape(B, Hkv, Sq, rep, D).transpose(2, 3).reshape(B, H, Sq, D)
    return ((dq * inv).bfloat16(), (dk * inv).bfloat16(), dv.bfloat16())


#: (B, H, Hkv, Sq, Sk, D, causal, window), each splitting both passes on
#: an H100's 132 SMs at two resident blocks
PLANNED_CASES = [
    (1, 4, 1, 600, 600, 32, True, None),       # causal, rep 4
    (1, 4, 1, 800, 800, 32, True, 320),        # window
    (1, 2, 1, 500, 700, 32, False, None),      # cross attention, Sq < Sk
]


@pytest.mark.parametrize("case", PLANNED_CASES)
def test_planned_plain_backward_matches_ref(case):
    B, H, Hkv, Sq, Sk, D, causal, window = case
    win = _win(window)
    plan = bwd_plan(B, H, Hkv, Sq, Sk, D, causal, win, Sk, sms=132,
                    resident=(2, 2))
    assert plan.kv_slots and plan.q_slots, "the case splits both passes"
    rng = np.random.default_rng(Sq + Sk + D)
    c = (20 / D ** 0.5) ** 0.5
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   for s in ((B, H, Sq, D), (B, Hkv, Sk, D),
                             (B, Hkv, Sk, D), (B, H, Sq, D)))
    q, k, v, do = (t.bfloat16() for t in (4 * q - c, k + c, v / 4, do))
    rep = H // Hkv
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(rep, 1)) * D ** -0.5
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
    mask = kpos > qpos - win
    if causal:
        mask &= kpos <= qpos
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, -1)
    out = (torch.softmax(s, -1) @ v.float().repeat_interleave(rep, 1)) \
        .bfloat16()
    got = _planned_bwd(q, k, v, out, lse, do, causal, win, plan)
    ref = flash_prefill_bwd_ref(q, k, v, out, lse, do, causal, win, Sk)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err = (a.float() - r.float()).abs().max().item()
        assert err <= FLASH_BWD_REL_TOL * r.float().abs().max().item(), \
            (name, err)
