"""Batched token sampling: greedy / temperature / top-k, per slot.

Port of ``repro.serving.sampler``.  JAX's threefry keys cannot be
reproduced in PyTorch, so each sampling slot gets its own
``torch.Generator`` seeded from ``(request seed, decode step)``: a
request's sampled stream depends only on its prompt, params and seed,
never on its batch-mates — the JAX engine's guarantee, with other bits.
Greedy (``temperature == 0``) is an argmax and matches the JAX engine
wherever the logits do.
"""
from __future__ import annotations

import numpy as np
import torch


def slot_generator(seed: int, step: int, device) -> torch.Generator:
    """The private generator of one (request seed, decode step) pair."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 32) | (int(step) & 0xFFFFFFFF))
    return g


def sample(logits: torch.Tensor, temperature: np.ndarray, top_k: np.ndarray,
           seeds: np.ndarray, steps: np.ndarray) -> torch.Tensor:
    """logits (B, V); per-slot host vectors temperature/top_k/seeds/steps.
    Returns (B,) int64 on the logits' device.

    ``top_k == 0`` (or >= V) keeps the whole distribution; ties at the
    k-th threshold keep every tied logit (``logits >= k-th largest``).
    """
    logits = logits.float()
    out = logits.argmax(dim=-1)
    V = logits.shape[-1]
    for b in np.flatnonzero(temperature > 0):
        row = logits[b]
        k = int(top_k[b]) if 0 < top_k[b] < V else V
        thresh = torch.topk(row, k).values[-1]
        masked = torch.where(row >= thresh, row,
                             torch.full_like(row, -float("inf")))
        probs = torch.softmax(masked / max(float(temperature[b]), 1e-6), -1)
        out[b] = torch.multinomial(
            probs, 1, generator=slot_generator(seeds[b], steps[b],
                                               logits.device))[0]
    return out
