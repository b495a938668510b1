"""The traffic generator: a seed repeats, every seed the same work."""
from collections import Counter

import numpy as np
import pytest

from bench import harness, traffic

MIXES = ("azure_conv_open", "batch_closed_16")


def mix(name):
    import json
    return json.loads((harness.ROOT / "bench" / "traffic" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a = traffic.generate(mix(name), 2 ** 31 + 7, 45, 32000)
    b = traffic.generate(mix(name), 2 ** 31 + 7, 45, 32000)
    assert [(r.prompt, r.new_tokens, r.due_s, r.client) for r in a] == \
        [(r.prompt, r.new_tokens, r.due_s, r.client) for r in b]
    c = traffic.generate(mix(name), 5, 45, 32000)
    assert [r.prompt for r in a] != [r.prompt for r in c]


def test_open_loop_every_seed_the_same_window():
    m = mix("azure_conv_open")
    seen = set()
    for seed in (1, 2 ** 31 + 11, -4):
        reqs = traffic.generate(m, seed, 45, 32768)
        win = [r for r in reqs if 0 <= r.due_s < 45]
        assert len(win) == round(m["rate_per_s"] * 45)
        seen.add((tuple(sorted(Counter(len(r.prompt) for r in win).items())),
                  tuple(sorted(r.new_tokens for r in win))))
        assert reqs[0].due_s == -m["warmup_s"]
        assert all(a.due_s <= b.due_s for a, b in zip(reqs, reqs[1:]))
    assert len(seen) == 1


@pytest.mark.parametrize("name", MIXES)
def test_lengths_inside_their_range(name):
    m = mix(name)
    reqs = traffic.generate(m, 3, 45, 100)
    p, o = m["prompt_tokens"], m["output_tokens"]
    assert all(p["min"] <= len(r.prompt) <= p["max"] for r in reqs)
    assert all(0 <= t < 100 for r in reqs for t in r.prompt)
    if m["loop"] == "open":
        assert all(o["min"] <= r.new_tokens <= o["max"] for r in reqs)
    lens = traffic.lengths(p, 1001, traffic.rng(0, 0))
    assert np.median(lens) == p["median"]


def test_closed_loop_every_seed_the_same_rounds():
    m = mix("batch_closed_16")
    c = m["clients"]
    seen = set()
    for seed in (9, 2 ** 31 + 1, -2):
        reqs = traffic.generate(m, seed, 45, 32000)
        assert [r.client for r in reqs[:3 * c]] == list(range(c)) * 3
        first = [r.new_tokens for r in reqs[:c]]
        rounds = [tuple(sorted(r.new_tokens for r in reqs[k:k + c]))
                  for k in range(c, len(reqs), c)]
        seen.add((tuple(first), tuple(rounds)))
    assert len(seen) == 1
    uncut = sorted(r.new_tokens for r in traffic._batch(m, c, 9, 3, 0.0))
    assert first == [max(1, u * (k + 1) // c) for k, u in enumerate(uncut)]


def test_unknown_arrivals_refused():
    m = dict(mix("azure_conv_open"), arrivals="gamma")
    with pytest.raises(ValueError):
        traffic.generate(m, 1, 45, 1000)


def test_balanced_order_spreads_each_stratum():
    m = mix("azure_conv_open")
    b = m["balance"]
    reqs = traffic.generate(m, 2 ** 31 + 3, 50, 1000)
    win = [r for r in reqs if 0 <= r.due_s < 50]
    ranks = np.argsort(np.argsort([len(r.prompt) for r in win],
                                  kind="stable"), kind="stable")
    strata = np.array_split(np.arange(len(win)), b)
    which = np.empty(len(win), int)
    for k, s in enumerate(strata):
        which[s] = k
    for j in range(0, len(win) - len(win) % b, b):
        assert sorted(which[ranks[j:j + b]]) == list(range(b))
