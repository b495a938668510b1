"""Data pipeline: deterministic synthetic LM corpus + batching.

Port of ``repro.training.data``.  No external datasets are available
offline; the pipeline synthesizes a Zipf-distributed token stream with
local n-gram structure (so the loss has signal to descend — a
pure-uniform stream would bottom out at ln V) and serves fixed-shape
(tokens, targets) batches.  :class:`SyntheticCorpus` is the reference's
numpy code, so the same seed gives the same tokens bit for bit;
:func:`batches` hands them over as int32 tensors on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticCorpus:
    """Markov-ish synthetic corpus: token t+1 ~ mix(bigram(t), zipf)."""

    vocab: int
    seed: int = 0
    bigram_weight: float = 0.7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse deterministic "bigram" successor table
        self._succ = rng.integers(0, self.vocab, size=(self.vocab, 4))
        ranks = np.arange(1, self.vocab + 1)
        p = 1.0 / ranks ** 1.1
        self._zipf = p / p.sum()
        self._rng = rng

    def stream(self, length: int) -> np.ndarray:
        """The next ``length`` tokens of the stream (int32)."""
        out = np.empty(length, np.int32)
        t = int(self._rng.integers(0, self.vocab))
        draws = self._rng.random(length)
        picks = self._rng.integers(0, 4, size=length)
        zipfs = self._rng.choice(self.vocab, size=length, p=self._zipf)
        for i in range(length):
            out[i] = t
            if draws[i] < self.bigram_weight:
                t = int(self._succ[t, picks[i]])
            else:
                t = int(zipfs[i])
        return out


def batches(vocab: int, batch: int, seq: int, n_steps: int, seed: int = 0,
            device="cuda") -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Yield (tokens, targets) int32 tensors of shape (batch, seq) on
    ``device`` — next-token targets."""
    corpus = SyntheticCorpus(vocab, seed)
    need = batch * (seq + 1)
    for _ in range(n_steps):
        flat = torch.from_numpy(corpus.stream(need).reshape(batch, seq + 1))
        yield flat[:, :-1].to(device), flat[:, 1:].to(device)


def token_specs(batch: int, seq: int):
    """Stand-ins for a step's (batch, seq) int32 tokens and targets with
    no storage (meta tensors): the dry-run's, as the reference's
    ``ShapeDtypeStruct`` pair."""
    s = torch.empty((batch, seq), dtype=torch.int32, device="meta")
    return {"tokens": s, "targets": s}
