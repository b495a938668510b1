"""Model registry: one functional API over the ported families.

Port of ``repro.models.registry`` for all six families: dense, moe,
vlm, ssm, hybrid and audio.  ``build(cfg)`` returns a :class:`Model`
whose members close over the family module:

    model.init_params(seed, device)                       -> params
    model.init_cache(policy, batch, max_seq, device)      -> cache / state
    model.init_paged_cache(policy, n_slots, n_blocks, block_size,
                           blocks_per_slot, device)       -> PagedKVCache
                                          (None: no KV cache to page)
    model.prefill(params, policy, tokens, cache, **extra) -> (logits, cache)
    model.decode_step(params, policy, tokens, cache, pos, **kw)
                                                          -> (logits, cache)
    model.hidden_states(params, tokens, policy=..., remat=..., **extra)
                                          -> final normed hidden states
    model.logits(params, h)               -> logits of hidden states
    model.loss_fn(params, policy, tokens, targets, remat=..., **extra)
                                          -> scalar mean next-token NLL
    model.extra_inputs(seed, batch, device)  -> dict of stub modality inputs
    model.extra_specs(batch)              -> the same with no storage (meta)
    model.cache_spec(policy, batch, max_seq) -> init_cache's cache with no
                                          storage (meta tensors: the
                                          dry-run's stand-ins)
    model.check_prefill(n_tokens)         -> raises ValueError for a prefill
                                          length the family refuses (None:
                                          any length)
    model.empty_stacks()                  -> the reference's zero-length
                                          leaves of layer stacks with no
                                          layers (checkpoints; hybrid only)

``extra`` carries the modality stubs: the vlm family's ``img_embeds``
(precomputed ViT patch embeddings, VIT_WIDTH wide) and the audio
family's ``frames`` (precomputed frontend embeddings).  The hybrid and
audio ``decode_step`` take no attention knobs and swallow them, so the
engine passes one keyword set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from . import encdec as ED
from . import rglru as G
from . import rwkv6 as R
from . import transformer as T

VIT_WIDTH = T.VIT_WIDTH

#: families whose :func:`build` result exposes ``init_paged_cache`` (the
#: transformer families; the engine config refuses a paged vlm, whose
#: prefill consumes extra inputs)
PAGED_FAMILIES = ("dense", "moe", "vlm")
#: families the port builds: every family of the JAX package
FAMILIES = PAGED_FAMILIES + ("ssm", "hybrid", "audio")

#: the next-token NLL of DTensor hidden states (the sharded training
#: step), installed by launch code (``launch/train.py``): ``fn(logits_of,
#: h, targets) -> (B, S) f32 nll``, ``logits_of(h)`` the model's logits
_SHARDED_NLL = None


def set_sharded_nll(fn) -> None:
    """Install (or, with None, remove) the DTensor path of
    :meth:`Model.loss_fn`."""
    global _SHARDED_NLL
    _SHARDED_NLL = fn
#: families the port does not build yet, with the ROADMAP queue 1 item
#: that ports each (none left)
NOT_PORTED: Dict[str, str] = {}


def not_ported(family: str) -> str:
    """The error text for a family the port does not build."""
    if family in NOT_PORTED:
        return (f"family {family!r} is not yet ported: ROADMAP queue 1 "
                f"{NOT_PORTED[family]}")
    return (f"unknown family {family!r} (the port builds: "
            f"{', '.join(FAMILIES)})")


@dataclasses.dataclass
class Model:
    """A family's functional API bound to one configuration."""
    cfg: ModelConfig
    init_params: Callable[..., Any]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]
    extra_inputs: Callable[..., Dict[str, torch.Tensor]]
    hidden_states: Callable[..., torch.Tensor]
    cache_spec: Callable[..., Any]
    prefill: Optional[Callable[..., Any]] = None
    init_paged_cache: Optional[Callable[..., Any]] = None
    check_prefill: Optional[Callable[[int], None]] = None
    empty_stacks: Callable[[], Dict[str, Any]] = dict
    #: ``extra_specs(batch)``: :attr:`extra_inputs`' shapes and dtypes
    #: with no storage (meta tensors)
    extra_specs: Callable[[int], Dict[str, torch.Tensor]] = \
        lambda batch: {}

    def logits(self, params, h: torch.Tensor) -> torch.Tensor:
        """Logits of hidden states (tied embedding unless ``lm_head``)."""
        return T.lm_logits(params, h)

    def loss_fn(self, params, policy, tokens: torch.Tensor,
                targets: torch.Tensor, remat: bool = False,
                **extra) -> torch.Tensor:
        """Causal LM cross-entropy, the mean over tokens, from f32 logits
        (``log_softmax``).  The vlm family prepends image rows: only the
        text positions (the tail) are scored.  DTensor hidden states go to
        the installed :func:`set_sharded_nll`."""
        h = self.hidden_states(params, tokens, policy=policy, remat=remat,
                               **extra)
        if h.shape[1] != tokens.shape[1]:
            h = h[:, h.shape[1] - tokens.shape[1]:]
        if _SHARDED_NLL is not None and type(h) is not torch.Tensor:
            return _SHARDED_NLL(lambda x: self.logits(params, x), h,
                                targets).mean()
        logp = F.log_softmax(self.logits(params, h).float(), dim=-1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        return nll.mean()


def _no_extra(*a, **k) -> Dict[str, Any]:
    return {}


def _meta_specs(**shapes) -> Callable[[int], Dict[str, torch.Tensor]]:
    """``extra_specs``: each named input a bf16 meta tensor of (batch,
    *shape)."""
    return lambda batch: {k: torch.empty((batch,) + s, dtype=torch.bfloat16,
                                         device="meta")
                          for k, s in shapes.items()}


def build(cfg: ModelConfig) -> Model:
    """The :class:`Model` of ``cfg``."""
    fam = cfg.family
    if fam in PAGED_FAMILIES:
        extra_inputs = _no_extra
        extra_specs = _meta_specs()
        if cfg.n_img_tokens:
            extra_specs = _meta_specs(
                img_embeds=(cfg.n_img_tokens, VIT_WIDTH))

            def extra_inputs(seed: int, batch: int, device="cuda"):
                gen = torch.Generator(device=device)
                gen.manual_seed(seed)
                return {"img_embeds": torch.randn(
                    (batch, cfg.n_img_tokens, VIT_WIDTH), generator=gen,
                    device=device).to(torch.bfloat16)}

        return Model(
            cfg=cfg,
            init_params=lambda seed=0, device="cuda": T.init_params(
                cfg, seed, device),
            init_cache=lambda policy, batch, max_seq, device="cuda":
            T.init_cache(cfg, policy, batch, max_seq, device),
            cache_spec=lambda policy, batch, max_seq: T.cache_spec(
                cfg, policy, batch, max_seq),
            prefill=lambda params, policy, tokens, cache, **ex: T.prefill(
                params, cfg, policy, tokens, cache, **ex),
            decode_step=lambda params, policy, tokens, cache, pos, **kw:
            T.decode_step(params, cfg, policy, tokens, cache, pos, **kw),
            extra_inputs=extra_inputs,
            extra_specs=extra_specs,
            init_paged_cache=lambda policy, n_slots, n_blocks, block_size,
            blocks_per_slot, device="cuda": T.init_paged_cache(
                cfg, policy, n_slots, n_blocks, block_size, blocks_per_slot,
                device),
            hidden_states=lambda params, tokens, policy=None, remat=False,
            **ex: T.hidden_states(params, cfg, tokens, policy=policy,
                                  remat=remat, **ex),
        )
    if fam == "ssm":
        return Model(
            cfg=cfg,
            init_params=lambda seed=0, device="cuda": R.init_params(
                cfg, seed, device),
            init_cache=lambda policy, batch, max_seq, device="cuda":
            R.init_state(cfg, batch, device),
            cache_spec=lambda policy, batch, max_seq: R.state_spec(cfg,
                                                                    batch),
            prefill=lambda params, policy, tokens, cache, **_ex: R.prefill(
                params, cfg, policy, tokens, cache),
            decode_step=lambda params, policy, tokens, cache, pos, **_kw:
            R.decode_step(params, cfg, policy, tokens, cache, pos),
            extra_inputs=_no_extra,
            check_prefill=R.check_prefill_len,
            hidden_states=lambda params, tokens, policy=None, remat=False,
            **_ex: R.hidden_states(params, cfg, tokens, policy=policy,
                                   remat=remat),
        )
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            init_params=lambda seed=0, device="cuda": G.init_params(
                cfg, seed, device),
            init_cache=lambda policy, batch, max_seq, device="cuda":
            G.init_cache(cfg, policy, batch, max_seq, device),
            cache_spec=lambda policy, batch, max_seq: G.cache_spec(
                cfg, policy, batch, max_seq),
            prefill=lambda params, policy, tokens, cache, **_ex: G.prefill(
                params, cfg, policy, tokens, cache),
            decode_step=lambda params, policy, tokens, cache, pos, **_kw:
            G.decode_step(params, cfg, policy, tokens, cache, pos),
            extra_inputs=_no_extra,
            hidden_states=lambda params, tokens, policy=None, remat=False,
            **_ex: G.hidden_states(params, cfg, tokens, policy=policy,
                                   remat=remat),
            empty_stacks=lambda: G.empty_stacks(cfg),
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
            cache_spec=lambda policy, batch, max_seq: ED.cache_spec(
                cfg, policy, batch, max_seq),
            prefill=lambda params, policy, tokens, cache, **ex: ED.prefill(
                params, cfg, policy, tokens, cache, **ex),
            decode_step=lambda params, policy, tokens, cache, pos, **_kw:
            ED.decode_step(params, cfg, policy, tokens, cache, pos),
            extra_inputs=extra_inputs,
            extra_specs=_meta_specs(frames=(cfg.enc_seq, cfg.d_model)),
            hidden_states=lambda params, tokens, policy=None, remat=False,
            **ex: ED.hidden_states(params, cfg, tokens, policy=policy,
                                   remat=remat, **ex),
        )
    raise ValueError(not_ported(fam))
