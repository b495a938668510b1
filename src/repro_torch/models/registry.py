"""Model registry: one functional API over the ported families.

Port of ``repro.models.registry`` for the dense, hybrid and audio
families.  ``build(cfg)`` returns a :class:`Model` whose members close over
the family module:

    model.init_params(seed, device)                       -> params
    model.init_cache(policy, batch, max_seq, device)      -> cache / state
    model.init_paged_cache(policy, n_slots, n_blocks, block_size,
                           blocks_per_slot, device)       -> PagedKVCache
                                          (None: no KV cache to page)
    model.prefill(params, policy, tokens, cache, **extra) -> (logits, cache)
                                          (None: prompts go through
                                          decode_step in chunks)
    model.decode_step(params, policy, tokens, cache, pos, **kw)
                                                          -> (logits, cache)
    model.extra_inputs(seed, batch, device)  -> dict of stub modality inputs

``extra`` carries the audio family's ``frames`` (precomputed frontend
embeddings, the one stub).  The hybrid and audio ``decode_step`` take no
attention knobs and swallow them, so the engine passes one keyword set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig

from . import encdec as ED
from . import rglru as G
from . import transformer as T

#: families whose :func:`build` result exposes ``init_paged_cache``
PAGED_FAMILIES = ("dense",)
#: families the port builds; the JAX package's others name their ROADMAP
#: queue 1 item
FAMILIES = ("dense", "hybrid", "audio")
NOT_PORTED = {"ssm": "item 8 (rwkv6.py)", "moe": "item 7", "vlm": "item 7"}


def not_ported(family: str) -> str:
    """The error text for a family the port does not build."""
    return (f"family {family!r} is not yet ported: ROADMAP queue 1 "
            f"{NOT_PORTED.get(family, 'items 7-8')}")


@dataclasses.dataclass
class Model:
    """A family's functional API bound to one configuration."""
    cfg: ModelConfig
    init_params: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]
    extra_inputs: Callable[..., Dict[str, torch.Tensor]]
    prefill: Optional[Callable[..., Any]] = None
    init_paged_cache: Optional[Callable[..., Any]] = None


def _no_extra(*a, **k) -> Dict[str, Any]:
    return {}


def build(cfg: ModelConfig) -> Model:
    """The :class:`Model` of ``cfg``."""
    fam = cfg.family
    if fam == "dense" and not cfg.n_experts and not cfg.n_img_tokens:
        return Model(
            cfg=cfg,
            init_params=lambda seed=0, device="cuda": T.init_params(
                cfg, seed, device),
            init_cache=lambda policy, batch, max_seq, device="cuda":
            T.init_cache(cfg, policy, batch, max_seq, device),
            decode_step=lambda params, policy, tokens, cache, pos, **kw:
            T.decode_step(params, cfg, policy, tokens, cache, pos, **kw),
            extra_inputs=_no_extra,
            init_paged_cache=lambda policy, n_slots, n_blocks, block_size,
            blocks_per_slot, device="cuda": T.init_paged_cache(
                cfg, policy, n_slots, n_blocks, block_size, blocks_per_slot,
                device),
        )
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            init_params=lambda seed=0, device="cuda": G.init_params(
                cfg, seed, device),
            init_cache=lambda policy, batch, max_seq, device="cuda":
            G.init_cache(cfg, policy, batch, max_seq, device),
            prefill=lambda params, policy, tokens, cache, **_ex: G.prefill(
                params, cfg, policy, tokens, cache),
            decode_step=lambda params, policy, tokens, cache, pos, **_kw:
            G.decode_step(params, cfg, policy, tokens, cache, pos),
            extra_inputs=_no_extra,
        )
    if fam == "audio":
        def extra_inputs(seed: int, batch: int, device="cuda"):
            gen = torch.Generator(device=device)
            gen.manual_seed(seed)
            return {"frames": torch.randn(
                (batch, cfg.enc_seq, cfg.d_model), generator=gen,
                device=device).to(torch.bfloat16)}

        return Model(
            cfg=cfg,
            init_params=lambda seed=0, device="cuda": ED.init_params(
                cfg, seed, device),
            init_cache=lambda policy, batch, max_seq, device="cuda":
            ED.init_cache(cfg, policy, batch, max_seq, device),
            prefill=lambda params, policy, tokens, cache, **ex: ED.prefill(
                params, cfg, policy, tokens, cache, **ex),
            decode_step=lambda params, policy, tokens, cache, pos, **_kw:
            ED.decode_step(params, cfg, policy, tokens, cache, pos),
            extra_inputs=extra_inputs,
        )
    raise NotImplementedError(not_ported(
        "moe" if cfg.n_experts else "vlm" if cfg.n_img_tokens else fam))
