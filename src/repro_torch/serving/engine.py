"""Serving engine: continuous batching over the mixed-precision model.

Port of ``repro.serving.engine`` for the dense and moe families on the
dense slab and on the paged backend (reservation or block growth with
preemption, prefix caching on or off), and for the vlm, ssm, hybrid and
audio families with their one-shot prefill on the dense slab, under every
``WxAyKVz`` policy.  The public surface
is the JAX engine's:

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

``enable_block_growth`` reserves only the prompt's blocks (+
``reserve_headroom_blocks``); ``step()`` maps one more block whenever a
slot's next append crosses a block boundary, and when the pool runs dry
preempts the youngest running request: its blocks are released, it
requeues at the front (``Status.PREEMPTED``), and on re-admission its
whole stream — prompt and produced tokens — is re-fed in forced
``prefill_chunk`` chunks through the ordinary step, nothing re-emitted,
so it recovers byte-exactly in O(stream / prefill_chunk) iterations.
``enable_prefix_caching`` publishes a prompt's full blocks in a
content-addressed :class:`PrefixIndex` once they are written; a request
whose prompt matches maps the same physical blocks (refcounted) and
starts its feed at the shared extent, reported as ``cached_tokens``.  A
matched block the slot would append into (the one holding the prompt's
last token) is copied to a private block first (copy-on-write).  Released
published blocks park on the allocator's CACHED LRU, which also softens a
preempted request's recompute.

Every iteration is one mixed prefill/decode step: prompt + produced output
form one token stream per request, ``Scheduler.plan`` picks the step width
(``prefill_chunk`` while any prompt is mid-prefill, else 1), and one
batched :func:`decode_step` feeds each running slot its next ``valid``
tokens — the chunk's KV quantize-and-written straight into the slot's slab
rows or pool blocks, attention by the multi-query slab or paged kernel
for prefill chunks and decode alike (or, under ``attn_impl="xla"``, by
plain fused attention over the slab or a view gathered from the pool),
every packed GEMM by the A16 or int8 kernel.  The slab kernel walks
``block_size`` tiles when that divides ``max_seq`` (else one ``max_seq``
tile), so the two backends traverse the same tiles and serve
byte-identical greedy streams.  A slot emits a token only on the
iteration that consumes its last unfed stream token.

The vlm (image inputs), ssm and hybrid (recurrent state) and audio
(encoder inputs) families keep the JAX engine's one-shot path instead: at
admission the prompt minus its last token runs through ``model.prefill``
into a B=1 cache (flash-prefill attention), which is spliced into the
slot; every step then feeds one token per slot through ``decode_step``.
As in the reference, a vlm slot then decodes from position ``n - 1`` of
its n-token prompt although the prefill wrote ``n_img + n - 1`` rows:
each step overwrites and attends to the slab's first rows, the image's
while ``n - 1 < n_img``.

Sampling is per slot (``serving/sampler.py``); feed cursors are host-side.
On a card a chunked step waits for the device at each host → device copy
of its inputs and of a slot's block-table row, at the KV write filter and
at the sampled-token fetch (and, moe, in ``moe_partial``): each is counted
in ``repro_torch.trace.host_syncs``.  Under a recording ``torch.profiler``
the step's phases are spans of :mod:`repro_torch.trace`.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import trace
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
    """Offline stage: pack every large 2D bf16 GEMM weight and every MoE
    expert stack (paper §4.1); embeddings and norms stay bf16.  Tensors
    are moved to ``device`` (when given) first.  On a CUDA device the
    packed 2D weights are put in the fragment order of the GEMM kernel the
    policy routes to (``to_kernel_layout``), so the card holds one copy,
    in the layout that kernel reads; expert stacks are put, member by
    member, in the A16 kernel's order under every policy (the experts
    take bf16 activations, as the reference's einsum does; ``models.moe``
    runs them through it).  A weight that layout cannot hold raises, with
    its path.  The CPU keeps the JAX package's tile-major bytes.  Returns
    a new parameter structure."""
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
                w = to_kernel_layout(w, "a8" if policy.int8_matmul and
                                     not w.stacked else "a16")
            except ValueError as e:
                raise ValueError(f"weight {'/'.join(map(str, _path))}: "
                                 f"{e}") from e
        return w
    return t


def _slot_insert(batch_cache, slot_cache, slot: int) -> None:
    """Write a B=1 cache into the batched cache at ``slot``, in place.

    Every cache leaf of every family carries batch at axis 1 (leaves are
    stacked ``(L, B, ...)``).  The splice covers only the slot cache's
    extent along the other axes and leaves the rest untouched (causally
    masked).  Used only by the one-shot prefill path."""
    for buf, val in zip(PKV.cache_leaves(batch_cache),
                        PKV.cache_leaves(slot_cache)):
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
        #: on-demand growth + preemption (EngineConfig allows it on paged
        #: engines only)
        self._growth = self._paged and config.enable_block_growth
        self.allocator: Optional[PKV.BlockAllocator] = None
        self.prefix_index: Optional[PKV.PrefixIndex] = None
        if self._paged:
            self.blocks_per_slot = config.blocks_per_slot
            self.n_blocks = config.pool_blocks
            self.allocator = PKV.BlockAllocator(self.n_blocks)
            self._block_map: Dict[int, List[int]] = {}
            #: rid → (shared source, private destination) of a pending
            #: copy-on-write (prefix caching)
            self._cow_map: Dict[int, tuple] = {}
            self.cache = self.model.init_paged_cache(
                self.policy, self.n_slots, self.n_blocks, self.block_size,
                self.blocks_per_slot, self.device)
            if config.enable_prefix_caching:
                # the salt binds what besides token ids fixes a block's
                # bytes: the model, the layer set and head geometry a pool
                # block spans, and the KV format
                self.prefix_index = PKV.PrefixIndex(
                    self.block_size,
                    salt=f"{cfg.name}|L{cfg.n_layers}|Hkv{cfg.n_kv_heads}"
                         f"|hd{cfg.hd}|{self.policy.kv.name}")
                self.allocator.on_evict = self.prefix_index.drop_block
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
        #: stream tokens fed through those steps (prompt chunks, replay
        #: and decode rows; a prefix hit's shared extent is not fed)
        self.fed_tokens = 0
        #: rows those steps computed: ``n_slots × t_step`` each, padding
        #: and idle slots included
        self.computed_rows = 0

    # -- the batched step ---------------------------------------------------

    def _step_fn(self, tokens, pos, valid, temp, top_k, seeds, steps,
                 max_live) -> np.ndarray:
        """One mixed prefill/decode iteration over every slot: tokens
        (B, t_step) host array, slot b's first ``valid[b]`` real.  Returns
        the sampled (B,) tokens on the host."""
        dev = self.device
        with trace.span("engine.inputs"):
            kw = {}
            if self._kv_family:
                # every KV family walks the engine's tiles (the one-shot
                # vlm too, as the reference passes them to every family
                # with kernels); only chunked engines feed padding rows
                kw = dict(max_live=max_live, attn_block_s=self.attn_block_s,
                          attn_impl=self.config.attn_impl)
            if self._chunked:
                kw["valid"] = torch.from_numpy(valid).to(dev)
            tokens_d = torch.from_numpy(tokens).to(dev)
            pos_d = torch.from_numpy(pos).to(dev)
            trace.sync(2 + self._chunked)
        with trace.span("model.forward"):
            logits, self.cache = self.model.decode_step(
                self.params, self.policy, tokens_d, self.cache, pos_d, **kw)
        self.model_steps += 1
        self.computed_rows += tokens.size
        with trace.span("engine.sample"):
            nxt = S.sample(logits, temp, top_k, seeds, steps)
        with trace.span("engine.fetch"):
            trace.sync()
            return nxt.cpu().numpy()

    # -- public API --------------------------------------------------------

    def now(self) -> float:
        """Monotonic seconds since engine construction (metric clock)."""
        return time.perf_counter() - self.t0

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None,
               arrival_time: Optional[float] = None) -> int:
        """Enqueue a request; returns its rid.  Inadmissible requests are
        rejected here with :class:`EngineError` (an ssm prompt whose
        one-shot prefill the chunked form refuses among them)."""
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
        n_img = self.model_cfg.n_img_tokens
        if n_img and n_img + max(len(prompt) - 1, 1) > self.max_seq:
            raise EngineError(
                f"the one-shot prefill of {n_img} image rows + "
                f"{max(len(prompt) - 1, 1)} prompt tokens does not fit "
                f"max_seq={self.max_seq}")
        if self.model.check_prefill is not None and not self._chunked:
            # the one-shot prefill runs the prompt minus its last token
            try:
                self.model.check_prefill(max(len(prompt) - 1, 1))
            except ValueError as e:
                raise EngineError(str(e)) from e
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
        slot (and, paged, drops its references on its KV blocks)
        immediately; a waiting or preempted one holds no blocks.  Returns
        the final ``finish_reason="abort"`` output, or None."""
        req = self._requests.get(rid)
        if req is None:
            return None
        if req.status in (Status.WAITING, Status.PREEMPTED):
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
        potential output token, clipped to the context limit.  Reserved
        whole at admission without growth; with growth only the
        feasibility ceiling (``submit``'s rejection, the headroom clip)."""
        toks = min(len(req.prompt) - 1 + req.params.max_new_tokens,
                   self.max_seq)
        return PKV.blocks_needed(max(toks, 1), self.block_size)

    def _admission_blocks(self, req: Request) -> int:
        """Blocks pinned at admission: the worst case without growth;
        with growth the effective stream (prompt plus any tokens produced
        before a preemption, which the replay rewrites) plus headroom,
        never more than the worst case."""
        if not self._growth:
            return self._blocks_for(req)
        eff = min(len(req.prompt) + len(req.output), self.max_seq)
        need = PKV.blocks_needed(max(eff, 1), self.block_size)
        return min(need + self.config.reserve_headroom_blocks,
                   self._blocks_for(req))

    def _match_prefix(self, req: Request):
        """``(shared, cow_src)``: the matched full blocks strictly below
        the decode frontier ``n - 1`` (never written again, so mapped
        shared), and the matched block holding position ``n - 1`` when the
        prompt is block-aligned (the slot would write it: copied, never
        mapped shared), or None."""
        if self.prefix_index is None:
            return [], None
        req.prefix_hashes = self.prefix_index.chain_hashes(req.prompt)
        matched = self.prefix_index.match_chain(req.prefix_hashes)
        ro = (len(req.prompt) - 1) // self.block_size
        return matched[:ro], (matched[ro] if len(matched) > ro else None)

    def _admit_gate(self, req: Request) -> bool:
        """Admission with reservation semantics: True also allocates the
        request's blocks, so one scheduler pass never over-commits.

        Prefix hits are mapped shared (one more reference) and only the
        rest is allocated.  The COW source is pinned until ``_admit`` has
        copied it; when that transient extra block does not fit, the tail
        degrades to a recomputed miss rather than defer a request the
        unshared engine would admit."""
        need = self._admission_blocks(req)
        shared, cow_src = self._match_prefix(req)
        pinned = shared + ([cow_src] if cow_src is not None else [])
        for b in pinned:
            self.allocator.share(b)
        if cow_src is not None and \
                not self.allocator.can_alloc(need - len(shared)):
            self.allocator.free([cow_src])
            cow_src = None
            pinned = shared
        if not self.allocator.can_alloc(need - len(shared)):
            self.allocator.free(pinned)      # unpin: admission deferred
            return False
        fresh = self.allocator.alloc(need - len(shared))
        self._block_map[req.rid] = shared + fresh
        if self.prefix_index is not None:
            bs = self.block_size
            if cow_src is not None:
                # the COW destination is the first fresh block: logical
                # block len(shared), the one holding position n - 1
                self._cow_map[req.rid] = (cow_src, fresh[0])
                req.prefix_skip = len(req.prompt) - 1
                # the re-fed last prompt token is honest recompute
                req.cached_tokens = len(shared) * bs + (bs - 1)
            else:
                req.prefix_skip = req.cached_tokens = len(shared) * bs
        return True

    def _map_slot_blocks(self, slot: int, blocks: List[int]) -> None:
        """Write the slot's whole table row (sentinels past ``blocks``)."""
        row = torch.full((self.blocks_per_slot,), self.n_blocks,
                         dtype=torch.int32)
        if blocks:
            row[:len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
        self.cache.block_table[slot].copy_(row)
        trace.sync()

    def _register_prefix(self, req: Request) -> None:
        """Publish the slot's full prompt blocks below the decode frontier
        ``n - 1``: written by the prompt's feed and never again.  Blocks
        mapped from the index re-register as no-ops; a duplicate of a
        block published first stays private."""
        nb = (len(req.prompt) - 1) // self.block_size
        for h, b in zip(req.prefix_hashes[:nb],
                        self._block_map[req.rid][:nb]):
            if self.prefix_index.register(h, b):
                self.allocator.set_cacheable(b)

    def _reclaim(self, req: Request) -> None:
        """Drop the request's block references (blocks other slots map
        stay live; published ones park CACHED); its table row goes back
        to sentinels (writes through it are dropped)."""
        self.allocator.free(self._block_map.pop(req.rid))
        self._map_slot_blocks(req.slot, [])

    def _preempt(self, req: Request) -> None:
        """Evict a running request (growth): release its blocks, requeue
        it at the front as ``PREEMPTED``, keep its produced tokens for the
        replay, and open its recovery window."""
        req.num_preemptions += 1
        if req.recovery_started is None:
            req.recovery_started = self.now()
        self._reclaim(req)            # while req.slot is still valid
        self.scheduler.preempt(req)

    def _grow_for_step(self, running: List[Request],
                       valids: Dict[int, int]) -> List[Request]:
        """Map a block for every boundary the next appends (positions
        ``pos .. pos + valid - 1``) cross, oldest request first; when the
        pool cannot cover one, preempt the youngest running request
        (possibly the requester) until it fits.  Oldest-first growth and
        youngest-first eviction keep the oldest request progressing.  Each
        new block is one element written into the device table.  Returns
        the surviving running set."""
        bs = self.block_size
        for req in sorted(running, key=lambda r: r.rid):
            end = req.pos + valids[req.rid]   # one past the last write
            while (req.status == Status.RUNNING
                   and end > len(self._block_map[req.rid]) * bs):
                if self.allocator.can_alloc(1):
                    blocks = self._block_map[req.rid]
                    [b] = self.allocator.alloc(1)
                    self.cache.block_table[req.slot, len(blocks)] = b
                    blocks.append(b)
                else:
                    self._preempt(self.scheduler.victim())
        return self.scheduler.running()

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
        """Map the reserved blocks into the slot (paged; a pending
        copy-on-write tail is copied first and its pinned source
        released) and seed its feed cursor at the prefix skip; a chunked
        engine's stream — prompt, and after a preemption the produced
        tokens — is fed by ``step()``.  A dense slot is not cleared:
        cells past the frontier are masked by position.

        One-shot families prefill the prompt minus its last token
        (at least one token, so an audio request always builds its
        encoder cache) into a B=1 cache spliced into the slot; a
        single-token prompt into a recurrent family resets the slot's
        state instead (stale state is masked by no causal mask)."""
        if self._paged:
            self._map_slot_blocks(req.slot, self._block_map[req.rid])
            cow = self._cow_map.pop(req.rid, None)
            if cow is not None:
                src, dst = cow
                PKV.copy_block(self.cache, src, dst)
                self.allocator.free([src])     # unpin the COW source
        if self._chunked:
            req.pos = req.prefix_skip
            req.needs_register = self.prefix_index is not None
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
        context limit binds both backends; a reserving paged slot's next
        write must also land in its reserved blocks (which never binds
        before ``max_new_tokens`` does, so the backends retire requests on
        the same iterations); a growing one maps more on demand."""
        if req.pos >= self.max_seq - 1:
            return False
        if self._paged and not self._growth:
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
        """One engine iteration: admit waiting requests, (growth) map the
        blocks the step's appends need, preempting if the pool runs dry,
        feed every running slot its next stream tokens through one
        batched model step, retire finished requests.  Iterations that
        re-feed already-streamed tokens after a preemption emit nothing
        and count as ``replay_iterations``.  Returns one
        :class:`RequestOutput` per emitting request."""
        trace.begin_step(self)      # opens engine.step while recording
        try:
            return self._iterate()
        finally:
            trace.end_step(self)

    def _iterate(self) -> List[RequestOutput]:
        """The body of :meth:`step`, its phases under their spans."""
        with trace.span("engine.admit"):
            for req in self.scheduler.admit():
                if req.admit_time is None:
                    req.admit_time = self.now()
                    trace.admitted(req.rid, req.admit_time - req.arrival_time)
                self._admit(req)
        running = self.scheduler.running()
        if not running:
            return []
        with trace.span("engine.plan"):
            chunk = self.prefill_chunk if self._chunked else 1
            t_step, valids = self.scheduler.plan(chunk)
            if self._growth:
                # before the step, so every surviving slot's appends land
                # in mapped blocks; preemption shrinks the batch: re-plan
                running = self._grow_for_step(running, valids)
                if not running:
                    return []
                t_step, valids = self.scheduler.plan(chunk)

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
                self.fed_tokens += v
                temp[r.slot] = r.params.temperature
                top_k[r.slot] = r.params.top_k
                seeds[r.slot] = r.seed
                steps[r.slot] = len(r.output)
            trace.note_plan(t_step, pos, valid)

            # paged: bound the kernel's walk by the batch's live context
            max_live = self._live_bucket(running) if self._paged else None
        nxt = self._step_fn(tokens, pos, valid, temp, top_k, seeds, steps,
                            max_live)
        with trace.span("engine.retire"):
            return self._retire(running, valids, nxt)

    def _retire(self, running: List[Request], valids: Dict[int, int],
                nxt: np.ndarray) -> List[RequestOutput]:
        """Advance every fed slot's cursor; a slot that consumed its last
        unfed token emits its sampled token and retires when finished."""
        t = self.now()
        outputs: List[RequestOutput] = []
        for r in running:
            r.pos += valids[r.rid]
            if r.pos < len(r.prompt) + len(r.output):
                # the prompt is still prefilling, or a preempted request
                # re-feeds tokens it already streamed (forced, not sampled)
                if r.pos > len(r.prompt):
                    r.replay_iterations += 1
                continue
            tok = int(nxt[r.slot])
            if r.first_token_time is None:
                r.first_token_time = t
            if r.recovery_started is not None:
                # eviction → this emission: the stream has caught up
                r.recovery_time += t - r.recovery_started
                r.recovery_started = None
            if r.needs_register:
                # every block below the frontier is written now
                self._register_prefix(r)
                r.needs_register = False
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
        table, an ssm or hybrid model's recurrent state, or an audio
        model's cross-attention slab (``core.paged_kvcache.kv_bytes``, which
        says where it differs from the JAX engine's count)."""
        return PKV.kv_bytes(self.cache)


def percentile_stats(vals: List[float]) -> Dict[str, float]:
    """p50/p90/p95/p99 of a metric list ({} when empty)."""
    if not vals:
        return {}
    a = np.asarray(vals)
    return {f"p{p}": float(np.percentile(a, p)) for p in (50, 90, 95, 99)}
