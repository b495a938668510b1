"""How ``correct`` is decided: the served tokens against the plain
reference (``bench.reference``), once the window has closed.

A sample of the requests finished in the window, drawn from the seed
with the one that was served the most tokens in it, until ``served_tokens``
served tokens are in it.  The reference runs each prompt with the tokens
it was served, teacher-forced, and reads at each served position the gap
by which the served token's logit lies below its best: ``max_logit_gap``
is the widest, ``mean_logit_gap`` the mean (compared where the
configuration gives it a limit).  Greedy decoding serves the argmax of
the program's own logits, so a sound program reads only its rounding
there.

The reference, the raw weights' layout and the router's ranking are the
configuration's architecture module's (``bench/archs/<arch>.py``, handed
over in the loaded cell).  For a moe model the reference routes by
itself (``Routing``), from the weights, the tokens and the engine's rows
as its knobs fix them: a prompt is fed in chunks of ``prefill_chunk``
from its start, then one position a step, each with its own per-row
capacity buffers.  Two things
it cannot know it leaves open, and at a served position of the last
layer it takes the alternative that fits the served token best:

* near-ties: an expert set whose members' ranking values (the module's
  ``rank``: for the decoder the log-probabilities) lie within ``tie_eps``
  of those it leaves out, which the program's bf16 router logits may
  order the other way;
* the padding rows the engine feeds beside a row that is narrower than
  the step (the last chunk of a prompt, a decoding position in a step
  that carries a chunk): their choices, which depend on the pool's
  contents, enter the buffers before the row's second choices, so such
  a choice may be kept or dropped.

Everything else, the capacity keep among a row's own positions, the
gates and the combine, is the reference's own.  Earlier layers (a deeper
moe model) follow the reference's own routing, with an open keep kept.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench import traffic

#: candidates an open position is given past its own k (more are rare)
EXTRA_CANDIDATES = 3


@dataclasses.dataclass
class Served:
    """A finished request: its prompt and the tokens it was served."""
    prompt: List[int]
    tokens: List[int]
    wanted: int


def capacity(T: int, topk: int, n_experts: int, factor: float) -> int:
    """A row's per-expert buffer: ``T·k·factor / E`` + 1, rounded up to a
    multiple of 4, at least 4."""
    c = int(T * topk * factor / n_experts) + 1
    return max(4, -(-c // 4) * 4)


def engine_rows(n_prompt: int, n_fed: int, chunk: int
                ) -> List[Tuple[int, int, Tuple[int, ...]]]:
    """The rows one request's ``n_fed`` positions were fed in: (start,
    stop, the step widths the row may have had).  A full chunk fills its
    step; a shorter last chunk is padded to the chunk; a one-position row
    has width 1 or, beside a prefilling slot, the chunk."""
    rows = []
    for a in range(0, n_prompt, chunk):
        b = min(a + chunk, n_prompt)
        rows.append((a, b, (chunk,) if b - a > 1 else (1, chunk)))
    rows += [(p, p + 1, (1, chunk)) for p in range(n_prompt, n_fed)]
    return rows


@dataclasses.dataclass
class _Pos:
    """One position's routing as far as the reference can fix it."""
    cands: np.ndarray               # candidate experts, most likely first
    logp: np.ndarray                # their log-probabilities
    sets: List[Tuple[int, ...]]     # plausible k-sets (indices into cands)
    lo: Dict[int, int]              # candidate → earliest fill pass
    hi: Dict[int, int]              # candidate → latest fill pass
    sure: set                       # candidates in every plausible set


def _position(order: np.ndarray, logp: np.ndarray, K: int, eps: float
              ) -> _Pos:
    lv = logp[order]
    n = int((lv >= lv[K - 1] - eps).sum())
    cands, lv = order[:n], lv[:n]
    sets = [s for s in itertools.combinations(range(n), K)
            if lv[list(s)].min() > max((lv[j] for j in range(n)
                                        if j not in s), default=-np.inf)
            - eps]
    member = set().union(*sets)
    lo = {j: int((lv > lv[j] + eps).sum()) for j in member}
    hi = {j: min(K - 1, int((lv > lv[j] - eps).sum()) - 1) for j in member}
    sure = set.intersection(*(set(s) for s in sets))
    return _Pos(cands, lv, sets, lo, hi, sure)


def _keeps(pos: List[_Pos], rows, K: int, E: int, factor: float
           ) -> List[Dict[int, Optional[bool]]]:
    """Each position's candidate → kept (True / False) or open (None), by
    the program's per-row fill: every row position's first choice, in
    order, then the row's padding rows', then the second choices, and so
    on; a choice past its expert's buffer is dropped.  Counts of what
    may be placed and of what surely is, so an open placement leaves
    later ones open rather than guessed."""
    out: List[Dict[int, Optional[bool]]] = [dict() for _ in pos]
    for a, b, widths in rows:
        caps = [capacity(T, K, E, factor) for T in widths]
        n_pad = max(widths) - (b - a)
        lo: Dict[int, int] = defaultdict(int)
        hi: Dict[int, int] = defaultdict(int)
        pad = 0
        seen: Dict[Tuple[int, int], set] = defaultdict(set)
        for k in range(K):
            for r in range(a, b):
                q = pos[r]
                for j in q.lo:
                    if not q.lo[j] <= k <= q.hi[j]:
                        continue
                    e = int(q.cands[j])
                    st = "drop" if lo[e] >= max(caps) else \
                        "keep" if hi[e] + pad < min(caps) else "open"
                    seen[(r, j)].add(st)
                    if st != "drop":
                        hi[e] += 1
                    if st == "keep" and j in q.sure and q.lo[j] == q.hi[j]:
                        lo[e] += 1
            pad += n_pad
        for (r, j), sts in seen.items():
            out[r][j] = (True if sts == {"keep"} else
                         False if sts == {"drop"} else None)
    return out


class Routing:
    """The reference's moe routing for the sampled requests (module
    docstring): ``__call__(layer, probs, at)`` gives each sequence's own
    expert ids and keep, and with ``at`` the routings left open at those
    positions.  ``rank`` maps the router's outputs to the values top-k
    orders, in ``tie_eps``'s units (the architecture module's)."""

    def __init__(self, served: List[Served], model: Dict, chunk: int,
                 tie_eps: float, rank: Callable[[torch.Tensor],
                                                torch.Tensor]):
        self.K, self.E = model["topk"], model["n_experts"]
        self.factor = model.get("capacity_factor", 1.25)
        self.eps = tie_eps
        self.rank = rank
        self.rows = [engine_rows(len(s.prompt),
                                 len(s.prompt) + len(s.tokens) - 1, chunk)
                     for s in served]
        #: per sequence, per position of ``at``: each alternative's tie
        #: (how far its weakest member lies below the own k-th choice)
        self.ties: List[List[List[float]]] = []
        #: per position of ``at``: how many routings are left open there
        self.open: List[int] = []

    def __call__(self, layer: int, probs: List[torch.Tensor],
                 at: Optional[Sequence[Sequence[int]]]):
        K = self.K
        out = []
        self.ties, self.open = [], []
        for i, p in enumerate(probs):
            logp = self.rank(p).cpu().numpy()
            order = np.argsort(-logp, axis=-1, kind="stable")[
                :, :K + EXTRA_CANDIDATES]
            pos = [_position(order[r], logp[r], K, self.eps)
                   for r in range(p.shape[0])]
            keeps = _keeps(pos, self.rows[i], K, self.E, self.factor)
            idx = np.stack([q.cands[:K] for q in pos])
            keep = np.array([[keeps[r].get(j) is not False for j in range(K)]
                             for r in range(len(pos))])
            alt = None
            if at is not None:
                alt = self._open(pos, keeps, at[i], p.device)
            out.append((torch.as_tensor(idx, device=p.device),
                        torch.as_tensor(keep, device=p.device), alt))
        return out

    def _open(self, pos: List[_Pos], keeps, at: Sequence[int], dev):
        """(ids, kept), each (len(at), A, k), of every routing left open
        at the positions ``at``; the first is the reference's own."""
        per, ties = [], []
        for r in at:
            q, alts, tie = pos[r], [], []
            for s in q.sets:
                opts = [(True, False) if keeps[r].get(j) is None else
                        (keeps[r][j],) for j in s]
                for kp in itertools.product(*opts):
                    alts.append(([int(q.cands[j]) for j in s], list(kp)))
                    tie.append(float(q.logp[self.K - 1] - q.logp[list(s)]
                                     .min()))
            per.append(alts)
            ties.append(tie)
            self.open.append(len(alts))
        A = max(len(a) for a in per)
        per = [a + [a[0]] * (A - len(a)) for a in per]
        self.ties.append([t + [t[0]] * (A - len(t)) for t in ties])
        return (torch.tensor([[x[0] for x in a] for a in per], device=dev),
                torch.tensor([[x[1] for x in a] for a in per], device=dev))


def sample(served: Dict[int, Served], seed: int, tokens: int) -> List[int]:
    """Rids of the sample: the request served the most tokens, then others
    in an order drawn from ``seed``, until ``tokens`` served tokens."""
    rids = sorted(served)
    if not rids:
        return []
    longest = max(rids, key=lambda r: (len(served[r].tokens), -r))
    rest = [r for r in rids if r != longest]
    order = [longest] + [rest[i] for i in
                         traffic.rng(seed, 7).permutation(len(rest))]
    out, n = [], 0
    for r in order:
        out.append(r)
        n += len(served[r].tokens)
        if n >= tokens:
            break
    return out


def _positions(s: Served) -> Tuple[List[int], List[int]]:
    """The sequence fed (prompt and served tokens but the last) and the
    positions whose logits chose the served tokens."""
    seq = s.prompt + s.tokens[:-1]
    return seq, list(range(len(s.prompt) - 1, len(seq)))


#: ties at which a run reports the widest gap it would read, were the
#: check to leave open only routings within that tie (``tie_eps``'s data)
TIE_STEPS = (0.0, 0.05, 0.1, 0.15, 0.2, 0.25)


def gaps(logits: List[torch.Tensor], chosen: List[List[int]]
         ) -> List[torch.Tensor]:
    """Per sequence (positions, A): the best logit minus the chosen
    token's under each routing left open (A 1 for a dense model)."""
    out = []
    for lg, tok in zip(logits, chosen):
        t = torch.as_tensor(tok, device=lg.device)
        out.append((lg.max(-1).values - lg.gather(
            -1, t[:, None, None].expand(-1, lg.shape[1], 1))[..., 0]).cpu())
    return out


class Judge:
    """The reference's logits over one sample, and the numbers that the
    program's served tokens, or another precision's choices, read there.
    ``c`` is the loaded cell (``harness.load_cell``): its configuration
    and its architecture module."""

    def __init__(self, c: Dict, params: Dict, served: Dict[int, Served],
                 rids: List[int], kv_bits: Optional[int] = None,
                 act_bits: Optional[int] = 0):
        cfg, arch = c["config"], c["arch"]
        model = cfg["model"]
        self.cfg, self.rids = cfg, rids
        self.route = None
        if model.get("n_experts"):
            self.route = Routing([served[r] for r in rids], model,
                                 cfg["engine"]["prefill_chunk"],
                                 cfg["check"]["tie_eps"], arch.rank)
        ref = arch.Reference(model, params, cfg["policy"], kv_bits, act_bits)
        seqs, self.at = zip(*(_positions(served[r]) for r in rids)) \
            if rids else ((), ())
        self.logits = ref.logits(seqs, self.at, self.route) if rids else []

    def numbers(self, chosen: List[List[int]]) -> Tuple[Dict, Dict]:
        """The compared numbers, each (value, limit), of the tokens
        ``chosen`` at the sample's positions, and what they covered."""
        chk = self.cfg["check"]
        if not self.rids:
            return {"max_logit_gap": (math.inf, chk["max_logit_gap"])}, {}
        per = gaps(self.logits, chosen)
        # the routing that fits best
        g = [x for p in per for x in p.min(-1).values.tolist()]
        numbers = {"max_logit_gap": (max(g), chk["max_logit_gap"])}
        if "mean_logit_gap" in chk:
            numbers["mean_logit_gap"] = (sum(g) / len(g),
                                         chk["mean_logit_gap"])
        info = {"mean_logit_gap": sum(g) / len(g)}
        if self.route is not None:
            ties = [torch.tensor(t, dtype=p.dtype)
                    for t, p in zip(self.route.ties, per)]
            info["open_positions"] = sum(n > 1 for n in self.route.open)
            info["max_gap_by_tie"] = {
                str(e): max(p.masked_fill(t > e, math.inf).min(-1).values
                            .max().item() for p, t in zip(per, ties))
                for e in TIE_STEPS if e <= self.route.eps}
        return numbers, info

    def own_choices(self) -> List[List[int]]:
        """The tokens this reference puts first (its own routing)."""
        return [lg[:, 0].argmax(-1).tolist() for lg in self.logits]


def compare(c: Dict, params: Dict, served: Dict[int, Served], seed: int
            ) -> Tuple[Dict, Dict]:
    """The numbers ``correct`` compares for the loaded cell ``c``, each as
    (value, limit), and what the comparison covered."""
    chk = c["config"]["check"]
    short = sum(len(s.tokens) != s.wanted for s in served.values())
    rids = sample(served, seed, chk["served_tokens"])
    judge = Judge(c, params, served, rids)
    numbers, info = judge.numbers([served[r].tokens for r in rids])
    info.update(requests=len(rids),
                served_tokens=sum(len(served[r].tokens) for r in rids))
    return {"short_answers": (short, 0), **numbers}, info


def control(c: Dict, params: Dict, served: Dict[int, Served], seed: int,
            judge: Optional[Judge] = None, **lower) -> Tuple[Dict, Dict]:
    """The control's numbers and what they covered, as ``compare`` gives
    the program's: the reference computed at the lower precision
    ``lower`` (``kv_bits=4`` or ``act_bits=8``) in the program's place,
    its first choices at the same sample's positions judged by the
    reference."""
    rids = sample(served, seed, c["config"]["check"]["served_tokens"])
    judge = judge or Judge(c, params, served, rids)
    low = Judge(c, params, served, rids, **lower)
    numbers, info = judge.numbers(low.own_choices())
    return {"short_answers": (0, 0), **numbers}, info


def judged(numbers: Dict) -> bool:
    """Every number within its limit."""
    return all(v <= lim for v, lim in numbers.values())
