"""Model registry: one functional API over the ported families.

Port of ``repro.models.registry`` for the dense family.  ``build(cfg)``
returns a :class:`Model` whose members close over the family module:

    model.init_params(seed, device)                       -> params
    model.init_cache(policy, batch, max_seq, device)      -> KVCache
    model.init_paged_cache(policy, n_slots, n_blocks, block_size,
                           blocks_per_slot, device)       -> PagedKVCache
    model.decode_step(params, policy, tokens, cache, pos, **kw)
                                                          -> (logits, cache)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig

from . import transformer as T

#: families whose ``build`` result has a KV cache (dense slab and paged)
KV_FAMILIES = ("dense",)


@dataclasses.dataclass
class Model:
    """A family's functional API bound to one configuration."""
    cfg: ModelConfig
    init_params: Callable[..., Any]
    init_cache: Callable[..., Any]
    init_paged_cache: Callable[..., Any]
    decode_step: Callable[..., Any]


def build(cfg: ModelConfig) -> Model:
    """The :class:`Model` of ``cfg`` (dense family only)."""
    if cfg.family != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1 "
            "items 7-8)")
    return Model(
        cfg=cfg,
        init_params=lambda seed=0, device="cuda": T.init_params(
            cfg, seed, device),
        init_cache=lambda policy, batch, max_seq, device="cuda":
        T.init_cache(cfg, policy, batch, max_seq, device),
        init_paged_cache=lambda policy, n_slots, n_blocks, block_size,
        blocks_per_slot, device="cuda": T.init_paged_cache(
            cfg, policy, n_slots, n_blocks, block_size, blocks_per_slot,
            device),
        decode_step=lambda params, policy, tokens, cache, pos, **kw:
        T.decode_step(params, cfg, policy, tokens, cache, pos, **kw),
    )
