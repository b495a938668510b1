"""The one traffic generator: a traffic mix is a JSON file of parameters
(``bench/traffic/<mix>.json``) that this module reads.

Keys of a mix::

    loop            "open" (arrivals on a schedule) or "closed" (clients
                    that each send their next request when the last ends)
    rate_per_s      open loop: mean arrivals a second, Poisson (exponential
                    gaps)
    clients         closed loop: clients, each with one request in flight
    warmup_s        seconds of the same traffic served before the window
    balance         optional: strata of the order (below)
    prompt_tokens   {"dist": "lognormal", "median", "sigma", "min", "max"}
    output_tokens   the same, for the tokens each request is served

Every seed gets the same multiset of lengths and of gaps between
arrivals, in another order: the sizes are the distribution's quantiles
at ``(i + 1/2) / n`` (clipped to [min, max] and rounded), shuffled by the
seed.  So two seeds differ in which request is long and when it comes,
not in how much work there is.  With ``balance`` b, the order is drawn
so that every run of b consecutive requests holds one length (and one
gap) from each of b equal strata of the sorted quantiles: the longest
prompts, or the shortest gaps, are spread through the window rather
than bunched where one seed's shuffle puts them, so the queue a seed
builds, and the tails, differ less from seed to seed.  Prompt token ids are uniform over the
vocabulary.  Each request is served greedily for exactly its drawn
number of output tokens.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Dict, List

import numpy as np

LOOPS = ("open", "closed")


@dataclasses.dataclass
class Request:
    """One generated request: due ``due_s`` seconds after the window's
    start (negative during warm-up; a closed loop's come due when the
    client's last request ends), its prompt ids and output tokens."""
    idx: int
    prompt: List[int]
    new_tokens: int
    due_s: float = 0.0
    client: int = -1


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one of a run's streams for ``seed`` (any
    integer)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def _quantile(spec: Dict, p: np.ndarray) -> np.ndarray:
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    z = np.array([NormalDist().inv_cdf(float(x)) for x in p])
    return float(spec["median"]) * np.exp(float(spec["sigma"]) * z)


def order(x: np.ndarray, g: np.random.Generator, balance: int = 0
          ) -> np.ndarray:
    """``x`` (ascending) in an order drawn from ``g``: any order, or, with
    ``balance`` b, one whose every run of b holds one entry of each of
    the b strata of ``x`` (module docstring)."""
    if balance <= 1:
        return g.permutation(x)
    cols = [g.permutation(s) for s in np.array_split(np.arange(len(x)),
                                                     balance)]
    idx = []
    for j in range(max(len(c) for c in cols)):
        idx += g.permutation([c[j] for c in cols if j < len(c)]).tolist()
    return x[np.array(idx, dtype=np.int64)]


def lengths(spec: Dict, n: int, g: np.random.Generator, balance: int = 0
            ) -> np.ndarray:
    """``n`` lengths of the distribution ``spec``: its stratified
    quantiles, clipped and rounded, in an order drawn from ``g``."""
    p = (np.arange(n) + 0.5) / n
    x = np.clip(np.rint(_quantile(spec, p)), spec["min"], spec["max"])
    return order(x.astype(np.int64), g, balance)


def gaps(mix: Dict, n: int, g: np.random.Generator) -> np.ndarray:
    """``n`` gaps between arrivals (seconds), stratified and shuffled."""
    if mix.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"unknown arrival process {mix['arrivals']!r}")
    p = (np.arange(n) + 0.5) / n
    return order(-np.log1p(-p) / float(mix["rate_per_s"]), g,
                 int(mix.get("balance", 0)))


def _batch(mix: Dict, n: int, seed: int, part: int, span: float
           ) -> List[Request]:
    """``n`` requests whose lengths are stratified over the ``n`` (and
    shuffled), due from 0 at gaps stratified over the ``n`` and scaled to
    sum to ``span`` (open loop; 0 for a closed loop's)."""
    b = int(mix.get("balance", 0))
    plen = lengths(mix["prompt_tokens"], n, rng(seed, 10 * part + 1), b)
    olen = lengths(mix["output_tokens"], n, rng(seed, 10 * part + 2), b)
    reqs = [Request(0, [0] * int(plen[i]), int(olen[i])) for i in range(n)]
    if span:
        g = gaps(mix, n, rng(seed, 10 * part + 4))
        due = np.concatenate([[0.0], np.cumsum(g)[:-1]]) * (span / g.sum())
        for r, t in zip(reqs, due):
            r.due_s = float(t)
    return reqs


def generate(mix: Dict, seed: int, seconds: float, vocab: int
             ) -> List[Request]:
    """The run's requests, with prompt ids uniform over ``vocab``.

    Open loop: ``round(rate * warmup_s)`` requests due over the warm-up
    (from ``-warmup_s``), then ``round(rate * seconds)`` due over the
    window, each group stratified on its own, so every seed has the same
    requests due in the window.  Closed loop: rounds of one request a
    client, each round stratified on its own, so every seed's clients
    work through the same multiset round by round; request ``i`` belongs
    to client ``i % clients`` and is due when that client's previous one
    ends (set as the loop runs)."""
    if mix["loop"] not in LOOPS:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    if mix["loop"] == "open":
        rate, warm = float(mix["rate_per_s"]), float(mix["warmup_s"])
        reqs = _batch(mix, max(1, round(rate * warm)), seed, 1, warm)
        for r in reqs:
            r.due_s -= warm
        reqs += _batch(mix, max(1, round(rate * seconds)), seed, 2, seconds)
    else:
        c = int(mix["clients"])
        reqs = [r for k in range(8 + int(seconds) // 4)
                for r in _batch(mix, c, seed, 3 + k, 0.0)]
        for i, r in enumerate(reqs):
            r.client = i % c
        # the clients' first requests end at staggered times: the first
        # round goes to the clients shortest first and client k's is cut
        # to (k + 1) / clients of its length, so the loop starts near its
        # steady mix, the same on every seed, instead of in one wave
        first = sorted(reqs[:c], key=lambda r: r.new_tokens)
        for k, r in enumerate(first):
            r.new_tokens = max(1, r.new_tokens * (k + 1) // c)
            r.client = k
        reqs[:c] = first
    ids = rng(seed, 3)
    for i, r in enumerate(reqs):
        r.idx = i
        r.prompt = ids.integers(0, vocab, len(r.prompt)).tolist()
    return reqs
