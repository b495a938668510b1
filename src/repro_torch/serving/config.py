"""Engine configuration: one validated dataclass.

Port of ``repro.serving.config`` for the dense-slab and paged engines of
the dense and moe families (reservation or block growth with preemption,
with or without prefix caching; the kernels or the ``attn_impl="xla"``
opt-out) and the one-shot-prefill engines of the vlm, ssm, hybrid and
audio families on the dense slab.  Every knob of the JAX ``EngineConfig``
is here, with its rules; an unknown family raises :class:`EngineError`
instead of silently doing something else.  New knob: ``device``
(``"cuda"`` by default; the CPU only when asked for — a missing card is an
error, never a fallback).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Union

import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import PrecisionPolicy, get_policy
from repro_torch.models.registry import (FAMILIES, PAGED_FAMILIES,
                                          not_ported)


class EngineError(ValueError):
    """Typed rejection from the serving layer: invalid configuration or
    an inadmissible request (a ``ValueError``)."""


@dataclasses.dataclass
class EngineConfig:
    """Validated serving-engine configuration.

    ``policy`` is a :class:`PrecisionPolicy` or any ``WxAyKVz`` name;
    ``None`` is the default ``w4a16kv8``.  Capacity: ``n_slots`` decode
    slots, ``max_seq`` tokens of context per slot, ``max_prompt``
    admissible prompt length (default ``max_seq``), ``prefill_chunk``
    tokens per chunked-prefill step.  ``cache_kind`` is ``"dense"`` (the
    default, as in the JAX package: one ``n_slots × max_seq`` slab) or
    ``"paged"``.  ``block_size`` is the paged pool's tokens per block and
    the dense kernel's tile height when it divides ``max_seq`` (so both
    backends walk the same tiles); ``n_blocks`` (paged only) is the pool
    size (default: ``n_slots * max_seq / block_size``).
    ``enable_prefix_caching`` (paged) shares full prompt-prefix blocks
    between requests; ``enable_block_growth`` (paged) reserves only the
    prompt's blocks (+ ``reserve_headroom_blocks``) at admission, grows a
    block per boundary crossing and preempts the youngest request when the
    pool runs dry.  ``attn_impl`` is ``"kernel"`` (the decode-attention
    kernels) or ``"xla"`` (the reference's opt-out: plain fused attention
    over the slab, or over a dense view gathered from the pool).
    """

    model: ModelConfig
    policy: Union[PrecisionPolicy, str, None] = None
    n_slots: int = 4
    max_seq: int = 256
    max_prompt: Optional[int] = None
    seed: int = 0
    cache_kind: str = "dense"
    block_size: int = 16
    n_blocks: Optional[int] = None
    prefill_chunk: int = 32
    attn_impl: str = "kernel"
    enable_prefix_caching: bool = False
    enable_block_growth: bool = False
    reserve_headroom_blocks: int = 0
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        """Validate and normalise the configuration (raises EngineError)."""
        if not isinstance(self.model, ModelConfig):
            raise EngineError(
                f"model must be a ModelConfig, got {type(self.model)!r}")
        if isinstance(self.policy, str) or self.policy is None:
            try:
                self.policy = get_policy(self.policy)
            except ValueError as e:
                raise EngineError(f"invalid policy: {e}") from e

        for name in ("n_slots", "max_seq", "block_size", "prefill_chunk"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise EngineError(f"{name} must be a positive int, got {v!r}")
        if self.cache_kind not in ("dense", "paged"):
            raise EngineError(
                f"unknown cache_kind {self.cache_kind!r} "
                "(expected 'dense' or 'paged')")
        if self.attn_impl not in ("kernel", "xla"):
            raise EngineError(
                f"unknown attn_impl {self.attn_impl!r} "
                "(expected 'kernel' or 'xla')")
        if self.max_prompt is None:
            self.max_prompt = self.max_seq
        if not isinstance(self.max_prompt, int) or self.max_prompt < 1:
            raise EngineError(
                f"max_prompt must be a positive int, got {self.max_prompt!r}")
        if self.max_prompt > self.max_seq:
            raise EngineError(
                f"max_prompt={self.max_prompt} exceeds max_seq={self.max_seq}")

        if self.model.family not in FAMILIES:
            raise EngineError(not_ported(self.model.family))
        if self.cache_kind == "paged":
            if self.max_seq % self.block_size:
                raise EngineError(
                    f"max_seq={self.max_seq} must be a multiple of "
                    f"block_size={self.block_size} for the paged cache")
            if self.n_blocks is not None and (
                    not isinstance(self.n_blocks, int) or self.n_blocks < 1):
                raise EngineError(
                    f"n_blocks must be a positive int, got {self.n_blocks!r}")
            if self.model.family not in PAGED_FAMILIES:
                raise EngineError(
                    f"family {self.model.family!r} has no KV cache to page")
            if self.model.n_img_tokens:
                raise EngineError(
                    "paged cache does not support modality-stub families "
                    "(their prefill consumes extra encoder inputs)")
            # chunks are quantize-and-written straight into pool blocks: a
            # chunk must tile a block exactly or span whole blocks
            if self.prefill_chunk % self.block_size and \
                    self.block_size % self.prefill_chunk:
                lo = (self.prefill_chunk // self.block_size) * self.block_size
                raise EngineError(
                    f"prefill_chunk={self.prefill_chunk} must divide or be "
                    f"a multiple of block_size={self.block_size} for paged "
                    "kernel prefill (chunks are written straight into pool "
                    f"blocks); try --prefill-chunk "
                    f"{max(lo, self.block_size)} or {lo + self.block_size}")
        else:
            if self.enable_prefix_caching:
                # prefix sharing maps one physical block into several
                # block tables — only the paged backend has blocks
                raise EngineError(
                    "enable_prefix_caching requires cache_kind='paged' "
                    f"(got {self.cache_kind!r})")
            if self.n_blocks is not None:
                # a dense slab has no pool: silently ignoring the knob
                # would hand the caller n_slots*max_seq of KV while they
                # believe they capped it at n_blocks*block_size
                raise EngineError(
                    "n_blocks requires cache_kind='paged' "
                    f"(got {self.cache_kind!r}; the dense slab is sized "
                    "by n_slots * max_seq)")
            if self.enable_block_growth:
                raise EngineError(
                    "enable_block_growth requires cache_kind='paged' "
                    f"(got {self.cache_kind!r})")
        if not isinstance(self.reserve_headroom_blocks, int) \
                or self.reserve_headroom_blocks < 0:
            raise EngineError(
                "reserve_headroom_blocks must be a non-negative int, "
                f"got {self.reserve_headroom_blocks!r}")
        if self.reserve_headroom_blocks and not self.enable_block_growth:
            raise EngineError(
                "reserve_headroom_blocks requires enable_block_growth")

        try:
            self.device = torch.device(self.device)
        except (RuntimeError, TypeError) as e:
            raise EngineError(f"invalid device {self.device!r}: {e}") from e
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise EngineError(
                "device 'cuda' requested but CUDA is not available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        if self.device.type not in ("cpu", "cuda"):
            raise EngineError(f"unsupported device {self.device}")

    # -- derived capacity --------------------------------------------------

    @property
    def blocks_per_slot(self) -> int:
        """Logical blocks each slot's table row maps (paged)."""
        return self.max_seq // self.block_size

    @property
    def pool_blocks(self) -> int:
        """Actual pool size (paged): ``n_blocks`` or dense-capacity
        parity."""
        if self.n_blocks is not None:
            return self.n_blocks
        return self.n_slots * self.blocks_per_slot

    # -- CLI wiring --------------------------------------------------------

    @staticmethod
    def add_cli_args(ap: argparse.ArgumentParser,
                     **defaults) -> argparse.ArgumentParser:
        """Install the engine's knobs on an argparse parser."""
        d = dict(arch="smollm-360m", policy="w4a16kv8", slots=4,
                 max_seq=256, max_prompt=None, seed=0, cache_kind="dense",
                 block_size=16, n_blocks=None, prefill_chunk=32,
                 attn_impl="kernel", enable_prefix_caching=False,
                 enable_block_growth=False, reserve_headroom_blocks=0,
                 device="cuda")
        d.update(defaults)
        ap.add_argument("--arch", default=d["arch"], choices=ARCHS)
        ap.add_argument("--reduced", action="store_true", default=True)
        ap.add_argument("--full", dest="reduced", action="store_false")
        ap.add_argument("--policy", default=d["policy"])
        ap.add_argument("--slots", type=int, default=d["slots"],
                        help="continuous-batching decode slots")
        ap.add_argument("--max-seq", type=int, default=d["max_seq"],
                        help="context tokens per slot")
        ap.add_argument("--max-prompt", type=int, default=d["max_prompt"],
                        help="admissible prompt length (default: max-seq)")
        ap.add_argument("--seed", type=int, default=d["seed"])
        ap.add_argument("--cache-kind", choices=("dense", "paged"),
                        default=d["cache_kind"], help="KV store backend")
        ap.add_argument("--block-size", type=int, default=d["block_size"],
                        help="tokens per KV block")
        ap.add_argument("--n-blocks", type=int, default=d["n_blocks"],
                        help="KV pool blocks, paged only (default: dense "
                             "parity)")
        ap.add_argument("--prefill-chunk", type=int,
                        default=d["prefill_chunk"],
                        help="tokens per chunked-prefill step (must divide "
                             "or be a multiple of --block-size)")
        ap.add_argument("--attn-impl", choices=("kernel", "xla"),
                        default=d["attn_impl"])
        ap.add_argument("--enable-prefix-caching", action="store_true",
                        default=d["enable_prefix_caching"],
                        help="share full prompt-prefix KV blocks across "
                             "requests (paged only; copy-on-write, "
                             "byte-identical streams)")
        ap.add_argument("--enable-block-growth", action="store_true",
                        default=d["enable_block_growth"],
                        help="reserve only prompt blocks at admission and "
                             "grow on demand, preempting the youngest "
                             "request when the pool runs dry (paged only; "
                             "byte-exact recovery)")
        ap.add_argument("--reserve-headroom-blocks", type=int,
                        default=d["reserve_headroom_blocks"],
                        help="extra blocks reserved per request at "
                             "admission under block growth")
        ap.add_argument("--device", default=d["device"],
                        help="cuda (default) or cpu")
        return ap

    @classmethod
    def from_cli(cls, args: argparse.Namespace) -> "EngineConfig":
        """Build a validated config from :meth:`add_cli_args` flags."""
        try:
            model = (get_reduced(args.arch) if args.reduced
                     else get_config(args.arch))
        except KeyError as e:
            raise EngineError(
                f"unknown arch {args.arch!r} (known: {', '.join(ARCHS)})"
            ) from e
        return cls(model=model, policy=args.policy, n_slots=args.slots,
                   max_seq=args.max_seq, max_prompt=args.max_prompt,
                   seed=args.seed, cache_kind=args.cache_kind,
                   block_size=args.block_size, n_blocks=args.n_blocks,
                   prefill_chunk=args.prefill_chunk,
                   attn_impl=args.attn_impl,
                   enable_prefix_caching=args.enable_prefix_caching,
                   enable_block_growth=args.enable_block_growth,
                   reserve_headroom_blocks=args.reserve_headroom_blocks,
                   device=args.device)
