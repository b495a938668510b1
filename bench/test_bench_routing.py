"""The moe check's own routing (``bench.check.Routing``): the engine's
rows, the capacity keep among a row's positions, and what it leaves open
(near-ties, and second choices beside padding rows)."""
import numpy as np
import torch

from bench import check, harness

RANK = harness.arch("decoder").rank


def probs(rows):
    """(n, E) probabilities from per-row log-probabilities."""
    return torch.softmax(torch.tensor(rows, dtype=torch.float64), -1)


def test_engine_rows_follow_the_chunks():
    assert check.engine_rows(70, 72, 32) == [
        (0, 32, (32,)), (32, 64, (32,)), (64, 70, (32,)),
        (70, 71, (1, 32)), (71, 72, (1, 32))]
    assert check.engine_rows(33, 33, 32)[-1] == (32, 33, (1, 32))


def test_clear_choices_are_fixed_and_kept():
    # a chunk of 4 beside a step of 8: 4 padding rows may fill a buffer
    r = check.Routing([check.Served([1] * 4, [1, 1], 2)],
                      dict(topk=2, n_experts=8), 8, 0.1, RANK)
    p = probs([[5.0, 4.0, 0, 0, 0, 0, 0, 0]] * 5)
    [(idx, keep, alt)] = r(0, [p], [[3, 4]])
    assert idx.tolist() == [[0, 1]] * 5
    assert keep.all()
    ids, kept = alt
    # the chunk's last position: its first choice is placed among the
    # chunk's own (kept); the 4 padding rows' first choices come before
    # its second and may fill expert 1's buffer: left open
    assert kept[0].tolist() == [[True, True], [True, False]]
    # so is a decoding position's, beside 7 padding rows
    assert sorted(map(tuple, kept[1].tolist())) == [(True, False),
                                                     (True, True)]
    assert r.open == [2, 2]
    # with 3 padding rows at most, a buffer of 4 cannot fill: kept
    r = check.Routing([check.Served([1] * 4, [1, 1], 2)],
                      dict(topk=2, n_experts=8), 4, 0.1, RANK)
    [(_, _, (_, kept))] = r(0, [p], [[3, 4]])
    assert kept.tolist() == [[[True, True]]] * 2


def test_a_full_row_drops_past_capacity():
    # eight positions of one chunk choose experts 0 then 1; capacity 4
    r = check.Routing([check.Served([1] * 8, [1], 1)],
                      dict(topk=2, n_experts=8), 8, 0.1, RANK)
    p = probs([[5.0, 4.0, 0, 0, 0, 0, 0, 0]] * 8)
    [(idx, keep, alt)] = r(0, [p], [[7]])
    assert keep[:, 0].tolist() == [True] * 4 + [False] * 4
    assert keep[:, 1].tolist() == [True] * 4 + [False] * 4
    assert alt[1][0].tolist() == [[False, False]]


def test_near_tie_opens_both_sets():
    r = check.Routing([check.Served([1], [1], 1)],
                      dict(topk=2, n_experts=8), 4, 0.1, RANK)
    p = probs([[5.0, 4.0, 3.95, 0, 0, 0, 0, 0]])
    [(idx, _, alt)] = r(0, [p], [[0]])
    assert idx.tolist() == [[0, 1]]
    sets = {tuple(s) for s in alt[0][0].tolist()}
    assert sets == {(0, 1), (0, 2)}
    ties = r.ties[0][0]
    assert min(ties) == 0 and np.isclose(max(ties), 0.05, atol=1e-9)
