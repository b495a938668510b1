"""Serving engine: continuous batching over the mixed-precision model.

Port of ``repro.serving.engine`` for the dense family on the dense slab
and on the paged backend with reservation admission, and for the hybrid
and audio families with their one-shot prefill, under every ``WxAyKVz``
policy.  The public surface is the JAX engine's:

* :class:`~repro_torch.serving.config.EngineConfig` — validated knobs;
* ``submit(prompt, params) -> rid``, ``step() -> List[RequestOutput]``,
  ``generate``, ``stream``, ``abort(rid)``, ``run_until_idle``.

The engine owns one KV store, stacked over layers.  ``cache_kind="dense"``
(the default) is an ``n_slots × max_seq`` slab: no allocator, no admission
gate, a slot's room bounded by ``max_seq`` alone.  ``cache_kind="paged"``
is a pool of ``n_blocks`` blocks of ``block_size`` tokens with one block
table and a host-side :class:`BlockAllocator`: admission reserves a
request's worst case (``prompt + max_new_tokens`` blocks), so a running
request never stalls, and its blocks return to the pool when it retires.

Every iteration is one mixed prefill/decode step: prompt + produced output
form one token stream per request, ``Scheduler.plan`` picks the step width
(``prefill_chunk`` while any prompt is mid-prefill, else 1), and one
batched :func:`decode_step` feeds each running slot its next ``valid``
tokens — the chunk's KV quantize-and-written straight into the slot's slab
rows or pool blocks, attention by the multi-query slab or paged kernel
for prefill chunks and decode alike, every packed GEMM by the A16 or int8
kernel.  The slab kernel walks ``block_size`` tiles when that divides
``max_seq`` (else one ``max_seq`` tile), so the two backends traverse the
same tiles and serve byte-identical greedy streams.  A slot emits a token only
on the iteration that consumes its last unfed stream token.

The hybrid (recurrent state) and audio (encoder inputs) families keep the
JAX engine's one-shot path instead: at admission the prompt minus its last
token runs through ``model.prefill`` into a B=1 cache (flash-prefill
attention), which is spliced into the slot; every step then feeds one
token per slot through ``decode_step``.

Sampling is per slot (``serving/sampler.py``); feed cursors are host-side,
and the one device→host sync per iteration besides the KV write filter is
the sampled-token fetch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import kvcache as KV
from repro_torch.core import paged_kvcache as PKV
from repro_torch.core.packing import PackedWeight, to_kernel_layout
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.models import common as C
from repro_torch.models.registry import Model, build

from . import sampler as S
from .config import EngineConfig, EngineError
from .request import (FinishReason, Request, RequestOutput, SamplingParams,
                      Status)
from .scheduler import Scheduler

# Weights that are *not* GEMM operands — never quantized (embeddings,
# norms), matching the JAX package's list.
_SKIP_KEYS = ("embed", "dec_pos", "lm_head", "conv_w", "lam", "u", "w0",
              "ln", "mu_", "b1", "b2", "g", "b")


def quantize_params(params, policy: PrecisionPolicy, device=None, _path=()):
    """Offline stage: pack every large 2D bf16 GEMM weight (paper §4.1);
    embeddings and norms stay bf16.  Tensors are moved to ``device`` (when
    given) first.  On a CUDA device the packed weights are put in the
    fragment order of the GEMM kernel the policy routes to
    (``to_kernel_layout``), so the card holds one copy, in the layout that
    kernel reads; the CPU keeps the JAX package's
    tile-major bytes.  Returns a new parameter structure."""
    if isinstance(params, dict):
        return {k: quantize_params(v, policy, device, _path + (k,))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [quantize_params(v, policy, device, _path) for v in params]
    if not isinstance(params, torch.Tensor):
        return params
    t = params if device is None else params.to(device)
    skip = any(str(k).startswith(s) for k in _path for s in _SKIP_KEYS)
    if not skip and t.dim() >= 2 and t.dtype == torch.bfloat16:
        w = C.maybe_quantize(t, policy)
        if isinstance(w, PackedWeight) and t.device.type == "cuda":
            try:
                w = to_kernel_layout(w, "a8" if policy.int8_matmul
                                     else "a16")
            except ValueError as e:
                raise ValueError(f"weight {'/'.join(map(str, _path))}: "
                                 f"{e}") from e
        return w
    return t


def _leaves(cache) -> List[torch.Tensor]:
    """Every tensor of a cache dataclass, nested caches included."""
    if isinstance(cache, torch.Tensor):
        return [cache]
    return [t for f in dataclasses.fields(cache)
            for t in _leaves(getattr(cache, f.name))]


def _slot_insert(batch_cache, slot_cache, slot: int) -> None:
    """Write a B=1 cache into the batched cache at ``slot``, in place.

    Every cache leaf of every family carries batch at axis 1 (leaves are
    stacked ``(L, B, ...)``).  The splice covers only the slot cache's
    extent along the other axes and leaves the rest untouched (causally
    masked).  Used only by the one-shot prefill path."""
    for buf, val in zip(_leaves(batch_cache), _leaves(slot_cache)):
        idx = (slice(None), slice(slot, slot + 1)) + tuple(
            slice(0, n) for n in val.shape[2:])
        buf[idx].copy_(val)


class Engine:
    """Continuous-batching serving engine (see the module docstring).
    Not thread-safe: one engine, one driver."""

    def __init__(self, config: EngineConfig, params: Optional[Any] = None):
        """Build the model (seeded random weights unless ``params`` is
        given), pack its weights and allocate the KV store, all on
        ``config.device``."""
        self.config = config
        cfg = config.model
        self.model_cfg = cfg
        self.device = config.device
        self.policy: PrecisionPolicy = config.policy
        self.model: Model = build(cfg)
        raw = params if params is not None else \
            self.model.init_params(config.seed, self.device)
        self.params = quantize_params(raw, self.policy, self.device)
        #: the stub modality inputs every prefill of this engine consumes
        self._extra = self.model.extra_inputs(config.seed + 2, 1,
                                              self.device)
        self._has_extra = bool(self._extra)
        self.n_slots = config.n_slots
        self.max_seq = config.max_seq
        self.block_size = config.block_size
        self.prefill_chunk = config.prefill_chunk
        self.max_prompt = config.max_prompt
        self.cache_kind = config.cache_kind
        self._paged = config.cache_kind == "paged"
        self.allocator: Optional[PKV.BlockAllocator] = None
        if self._paged:
            self.blocks_per_slot = config.blocks_per_slot
            self.n_blocks = config.pool_blocks
            self.allocator = PKV.BlockAllocator(self.n_blocks)
            self._block_map: Dict[int, List[int]] = {}
            self.cache = self.model.init_paged_cache(
                self.policy, self.n_slots, self.n_blocks, self.block_size,
                self.blocks_per_slot, self.device)
        else:
            self.cache = self.model.init_cache(self.policy, self.n_slots,
                                               self.max_seq, self.device)
        self._kv_family = isinstance(self.cache,
                                     (KV.KVCache, PKV.PagedKVCache))
        #: prompts fed in chunks through decode_step (KV families without
        #: extra inputs); else the one-shot prefill at admission
        self._chunked = self._kv_family and not self._has_extra
        #: the dense kernel's tile height: the paged block size when it
        #: divides the slab, else one whole-sequence tile
        self.attn_block_s = (self.block_size
                             if self.max_seq % self.block_size == 0
                             else self.max_seq)
        self.scheduler = Scheduler(
            self.n_slots, admit_gate=self._admit_gate if self._paged else None)
        self._next_rid = 0
        self._requests: Dict[int, Request] = {}
        self._unclaimed: List[RequestOutput] = []
        self._stream_bufs: Dict[int, List[RequestOutput]] = {}
        self.t0 = time.perf_counter()
        #: batched model steps run (one decode_step call each)
        self.model_steps = 0

    # -- the batched step ---------------------------------------------------

    def _step_fn(self, tokens, pos, valid, temp, top_k, seeds, steps,
                 max_live) -> np.ndarray:
        """One mixed prefill/decode iteration over every slot: tokens
        (B, t_step) host array, slot b's first ``valid[b]`` real.  Returns
        the sampled (B,) tokens on the host."""
        dev = self.device
        kw = {}
        if self._chunked:
            kw = dict(max_live=max_live, attn_block_s=self.attn_block_s,
                      valid=torch.from_numpy(valid).to(dev))
        logits, self.cache = self.model.decode_step(
            self.params, self.policy, torch.from_numpy(tokens).to(dev),
            self.cache, torch.from_numpy(pos).to(dev), **kw)
        self.model_steps += 1
        nxt = S.sample(logits, temp, top_k, seeds, steps)
        return nxt.cpu().numpy()

    # -- public API --------------------------------------------------------

    def now(self) -> float:
        """Monotonic seconds since engine construction (metric clock)."""
        return time.perf_counter() - self.t0

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               arrival_time: Optional[float] = None) -> int:
        """Enqueue a request; returns its rid.  Inadmissible requests are
        rejected here with :class:`EngineError`."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise EngineError("prompt must contain at least one token")
        if len(prompt) > self.max_prompt:
            raise EngineError(
                f"prompt length {len(prompt)} exceeds max_prompt="
                f"{self.max_prompt}")
        if any(t < 0 or t >= self.model_cfg.vocab for t in prompt):
            raise EngineError(
                f"prompt token outside the vocabulary [0, "
                f"{self.model_cfg.vocab})")
        params = params or SamplingParams()
        req = Request(rid=self._next_rid, prompt=prompt, params=params,
                      arrival_time=self.now() if arrival_time is None
                      else arrival_time,
                      seed=self._resolve_seed(params, self._next_rid))
        if self._paged and self._blocks_for(req) > self.n_blocks:
            raise EngineError(
                f"request needs {self._blocks_for(req)} KV blocks "
                f"(prompt {len(req.prompt)} + max_new "
                f"{req.params.max_new_tokens}) but the pool has only "
                f"{self.n_blocks}")
        self._next_rid += 1
        self._requests[req.rid] = req
        self.scheduler.add(req)
        return req.rid

    def abort(self, rid: int) -> Optional[RequestOutput]:
        """Cancel a request (idempotent).  A running request frees its
        slot (and, paged, returns its KV blocks to the pool) immediately.
        Returns the final ``finish_reason="abort"`` output, or None."""
        req = self._requests.get(rid)
        if req is None:
            return None
        if req.status == Status.WAITING:
            self.scheduler.remove_waiting(req)
            req.status = Status.FINISHED
            req.finish_time = self.now()
        else:
            self.scheduler.finish(req, self.now())
            if self._paged:
                self._reclaim(req)
        req.finish_reason = FinishReason.ABORT
        del self._requests[rid]
        return req.make_output([])

    def _resolve_seed(self, params: SamplingParams, rid: int) -> int:
        if params.seed is not None:
            return int(params.seed) & 0x7FFFFFFF
        return ((self.config.seed * 1_000_003) ^ (rid * 0x9E3779B1)) \
            & 0x7FFFFFFF

    # -- paged bookkeeping -------------------------------------------------

    def _blocks_for(self, req: Request) -> int:
        """Worst-case KV blocks: prompt minus the last token plus every
        potential output token, clipped to the context limit."""
        toks = min(len(req.prompt) - 1 + req.params.max_new_tokens,
                   self.max_seq)
        return PKV.blocks_needed(max(toks, 1), self.block_size)

    def _admit_gate(self, req: Request) -> bool:
        """Reservation: admit only if the worst case fits, and allocate it."""
        need = self._blocks_for(req)
        if not self.allocator.can_alloc(need):
            return False
        self._block_map[req.rid] = self.allocator.alloc(need)
        return True

    def _map_slot_blocks(self, slot: int, blocks: List[int]) -> None:
        row = torch.full((self.blocks_per_slot,), self.n_blocks,
                         dtype=torch.int32)
        if blocks:
            row[:len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
        self.cache.block_table[slot].copy_(row)

    def _reclaim(self, req: Request) -> None:
        """Release the request's blocks; its table row goes back to
        sentinels (writes through it are dropped)."""
        self.allocator.free(self._block_map.pop(req.rid))
        self._map_slot_blocks(req.slot, [])

    def _live_bucket(self, running) -> int:
        """Live-context bound for the attention kernel's walk: the batch's
        ``max(pos) + 1`` rounded up to a power-of-two block count, clipped
        to ``max_context`` (the JAX engine's bucketing, kept so both walk
        the same blocks)."""
        hw = max(r.pos for r in running) + 1
        nb = PKV.blocks_needed(hw, self.block_size)
        nb = 1 << (nb - 1).bit_length()
        return min(nb, self.blocks_per_slot) * self.block_size

    def _admit(self, req: Request) -> None:
        """Map the reserved blocks into the slot (paged) and seed its feed
        cursor; a chunked engine's prompt is fed by ``step()``.  A dense
        slot is not cleared: cells past the frontier are masked by
        position.

        One-shot families prefill the prompt minus its last token
        (at least one token, so an audio request always builds its
        encoder cache) into a B=1 cache spliced into the slot; a
        single-token prompt into a recurrent family resets the slot's
        state instead (stale state is masked by no causal mask)."""
        if self._paged:
            self._map_slot_blocks(req.slot, self._block_map[req.rid])
        if self._chunked:
            req.pos = 0
            return
        n = len(req.prompt)
        if n > 1 or self._has_extra:
            P = max(n - 1, 1)
            toks = torch.tensor([req.prompt[:P]], dtype=torch.int64,
                                device=self.device)
            cache1 = self.model.init_cache(self.policy, 1, self.max_seq,
                                           self.device)
            _, cache1 = self.model.prefill(self.params, self.policy, toks,
                                           cache1, **self._extra)
            _slot_insert(self.cache, cache1, req.slot)
        elif not self._kv_family:
            _slot_insert(self.cache, self.model.init_cache(
                self.policy, 1, self.max_seq, self.device), req.slot)
        req.pos = n - 1

    # -- main loop ---------------------------------------------------------

    def _has_room(self, req: Request) -> bool:
        """True while the slot can absorb another decode append: the
        context limit binds both backends; a paged slot's next write must
        also land in its reserved blocks (which never binds before
        ``max_new_tokens`` does, so the backends retire requests on the
        same iterations)."""
        if req.pos >= self.max_seq - 1:
            return False
        if self._paged:
            return req.pos < len(self._block_map[req.rid]) * self.block_size
        return True

    def _finish_reason(self, req: Request, tok: int
                       ) -> Optional[FinishReason]:
        produced = len(req.output)
        reason = None
        if produced >= req.params.min_new_tokens:
            reason = req.params.stops_on(tok)
        if reason is None and produced >= req.params.max_new_tokens:
            reason = FinishReason.LENGTH
        if reason is None and not self._has_room(req):
            reason = FinishReason.CONTEXT
        return reason

    def step(self) -> List[RequestOutput]:
        """One engine iteration: admit waiting requests, feed every running
        slot its next stream tokens through one batched model step, retire
        finished requests.  Returns one :class:`RequestOutput` per emitting
        request."""
        for req in self.scheduler.admit():
            self._admit(req)
        running = self.scheduler.running()
        if not running:
            return []
        t_step, valids = self.scheduler.plan(
            self.prefill_chunk if self._chunked else 1)

        # idle slots feed token 0 at position 0 with valid == 0: their
        # writes are dropped and their logits discarded
        tokens = np.zeros((self.n_slots, t_step), np.int64)
        pos = np.zeros((self.n_slots,), np.int32)
        valid = np.zeros((self.n_slots,), np.int32)
        temp = np.zeros((self.n_slots,), np.float32)
        top_k = np.zeros((self.n_slots,), np.int32)
        seeds = np.zeros((self.n_slots,), np.int64)
        steps = np.zeros((self.n_slots,), np.int64)
        for r in running:
            v = valids[r.rid]
            stream = r.prompt + r.output
            tokens[r.slot, :v] = stream[r.pos:r.pos + v]
            pos[r.slot] = r.pos
            valid[r.slot] = v
            temp[r.slot] = r.params.temperature
            top_k[r.slot] = r.params.top_k
            seeds[r.slot] = r.seed
            steps[r.slot] = len(r.output)

        # paged: bound the kernel's walk by the batch's live context
        max_live = self._live_bucket(running) if self._paged else None
        nxt = self._step_fn(tokens, pos, valid, temp, top_k, seeds, steps,
                            max_live)
        t = self.now()
        outputs: List[RequestOutput] = []
        for r in running:
            r.pos += valids[r.rid]
            if r.pos < len(r.prompt) + len(r.output):
                continue                  # prompt still prefilling
            tok = int(nxt[r.slot])
            if r.first_token_time is None:
                r.first_token_time = t
            r.output.append(tok)
            reason = self._finish_reason(r, tok)
            if reason is not None:
                r.finish_reason = reason
                self.scheduler.finish(r, t)
                if self._paged:
                    self._reclaim(r)
                del self._requests[r.rid]
            out = r.make_output([tok])
            outputs.append(out)
            if r.rid in self._stream_bufs:
                self._stream_bufs[r.rid].append(out)
        return outputs

    def generate(self, prompts: Sequence[Sequence[int]],
                 params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None,
                 max_iters: int = 100_000) -> List[RequestOutput]:
        """Submit every prompt, drive ``step()`` until all finish, return
        their final outputs in prompt order (all-or-nothing admission)."""
        if params is None or isinstance(params, SamplingParams):
            params = [params] * len(prompts)
        if len(params) != len(prompts):
            raise EngineError(
                f"got {len(params)} SamplingParams for "
                f"{len(prompts)} prompts")
        rids: List[int] = []
        try:
            for p, sp in zip(prompts, params):
                rids.append(self.submit(p, sp))
        except EngineError:
            for rid in rids:
                self.abort(rid)
            raise
        pending = set(rids)
        final: Dict[int, RequestOutput] = {}
        for _ in range(max_iters):
            if not pending:
                return [final[rid] for rid in rids]
            for out in self.step():
                if not out.finished:
                    continue
                if out.rid in pending:
                    final[out.rid] = out
                    pending.discard(out.rid)
                elif out.rid not in self._stream_bufs:
                    self._unclaimed.append(out)
        raise RuntimeError("generate() did not drain")

    def stream(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               max_iters: int = 100_000) -> Iterator[RequestOutput]:
        """Submit one prompt and yield its outputs as iterations complete;
        closing the iterator early aborts the request."""
        rid = self.submit(prompt, params)
        buf = self._stream_bufs.setdefault(rid, [])
        try:
            for _ in range(max_iters):
                while buf:
                    out = buf.pop(0)
                    yield out
                    if out.finished:
                        return
                if rid not in self._requests:
                    return
                for out in self.step():
                    if out.finished and out.rid not in self._stream_bufs \
                            and out.rid != rid:
                        self._unclaimed.append(out)
            raise RuntimeError("stream() did not finish")
        except GeneratorExit:
            self.abort(rid)
            raise
        finally:
            self._stream_bufs.pop(rid, None)

    def run_until_idle(self, max_iters: int = 10_000) -> List[RequestOutput]:
        """Drive ``step()`` until nothing is waiting or running; returns
        the finished outputs in completion order."""
        finished, self._unclaimed = self._unclaimed, []
        for _ in range(max_iters):
            if self.scheduler.idle:
                return finished
            finished.extend(o for o in self.step() if o.finished
                            and o.rid not in self._stream_bufs)
        raise RuntimeError("engine did not drain")

    def kv_resident_bytes(self) -> int:
        """Resident bytes of the decode state: slab or pool + scales +
        table, and a hybrid model's recurrent state or an audio model's
        cross-attention slab.  The JAX slab also holds a (L, B) int32
        ``length`` the port does not keep."""
        return sum(t.numel() * t.element_size() for t in _leaves(self.cache))


def percentile_stats(vals: List[float]) -> Dict[str, float]:
    """p50/p90/p95/p99 of a metric list ({} when empty)."""
    if not vals:
        return {}
    a = np.asarray(vals)
    return {f"p{p}": float(np.percentile(a, p)) for p in (50, 90, 95, 99)}
