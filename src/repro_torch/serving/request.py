"""Request objects, sampling parameters, and streamed outputs.

Port of ``repro.serving.request``.  The public output type is
:class:`RequestOutput`, an immutable per-iteration snapshot carrying the
JAX package's prefix-cache and preemption counters.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

from .config import EngineError


class Status(enum.Enum):
    """Request lifecycle state (engine-internal)."""

    WAITING = "waiting"
    RUNNING = "running"
    #: evicted by the block-growth engine (pool exhausted): at the front
    #: of the waiting queue, holding no blocks, its stream re-fed on
    #: re-admission
    PREEMPTED = "preempted"
    FINISHED = "finished"


class FinishReason(str, enum.Enum):
    """Why a request retired (``str``-valued)."""
    EOS = "eos"
    LENGTH = "length"
    STOP = "stop"
    ABORT = "abort"
    CONTEXT = "context"


@dataclasses.dataclass
class SamplingParams:
    """Per-request decode controls.

    ``temperature == 0`` → greedy; ``top_k == 0`` → no truncation.
    ``eos_id``/``stop_token_ids`` finish a request only after
    ``min_new_tokens`` tokens; ``seed`` pins the request's private RNG
    stream (``None`` draws a fresh one per submission).
    """
    temperature: float = 0.0
    top_k: int = 0
    max_new_tokens: int = 32
    min_new_tokens: int = 0
    eos_id: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature < 0:
            raise EngineError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise EngineError(f"top_k must be >= 0, got {self.top_k}")
        if self.max_new_tokens < 1:
            raise EngineError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}")
        if not 0 <= self.min_new_tokens <= self.max_new_tokens:
            raise EngineError(
                f"min_new_tokens={self.min_new_tokens} must lie in "
                f"[0, max_new_tokens={self.max_new_tokens}]")
        if isinstance(self.stop_token_ids, (str, bytes)) or \
                not isinstance(self.stop_token_ids, Sequence):
            raise EngineError("stop_token_ids must be a sequence of ints")
        try:
            self.stop_token_ids = tuple(int(t) for t in self.stop_token_ids)
        except (TypeError, ValueError) as e:
            raise EngineError(
                f"stop_token_ids must be a sequence of ints: {e}") from e

    def stops_on(self, token: int) -> Optional[FinishReason]:
        """Finish reason the token triggers (eos/stop), or None."""
        if self.eos_id is not None and token == self.eos_id:
            return FinishReason.EOS
        if token in self.stop_token_ids:
            return FinishReason.STOP
        return None


@dataclasses.dataclass
class RequestOutput:
    """One streamed increment of a request's output: ``new_token_ids``
    produced this iteration, ``output_token_ids`` so far; the finished
    output carries ``finish_reason`` and the timing metrics.

    ``cached_tokens``: prompt tokens served from the prefix cache instead
    of recomputed (0 unless ``enable_prefix_caching``).
    ``num_preemptions``: times the block-growth engine evicted and
    recovered the request (the stream is unaffected).
    ``replay_iterations``: non-emitting iterations spent re-feeding
    already-produced tokens after preemptions, O(produced /
    prefill_chunk) per preemption.  ``recovery_time``: total seconds
    from each eviction to the request's next emission."""

    rid: int
    prompt_len: int
    new_token_ids: List[int]
    output_token_ids: List[int]
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
    cached_tokens: int = 0
    num_preemptions: int = 0
    replay_iterations: int = 0
    recovery_time: float = 0.0
    ttft: Optional[float] = None        # first-token latency (s)
    latency: Optional[float] = None     # end-to-end latency (s)


@dataclasses.dataclass
class Request:
    """Engine-internal lifecycle record."""
    rid: int
    prompt: List[int]
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    arrival_time: float = 0.0
    seed: int = 0

    status: Status = Status.WAITING
    slot: int = -1
    #: tokens of the stream prompt + output fed through the model so far;
    #: at the k-th emission ``pos == prompt_len - 1 + k``
    pos: int = 0
    output: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[FinishReason] = None
    #: engine time of the first admission (its queue wait ends there)
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    #: prompt tokens served from the prefix cache (reported on outputs)
    cached_tokens: int = 0
    #: where the feed starts on admission: the block-aligned shared
    #: extent of a prefix hit, or ``prompt_len - 1`` after a copy-on-write
    #: tail (engine-internal)
    prefix_skip: int = 0
    #: chain hashes of the prompt's full blocks, computed once at the
    #: admission gate and reused for registration (engine-internal)
    prefix_hashes: List[bytes] = dataclasses.field(default_factory=list)
    #: times this request was preempted by the block-growth engine
    num_preemptions: int = 0
    #: non-emitting iterations spent re-feeding produced tokens
    replay_iterations: int = 0
    #: cumulative eviction → next-emission seconds
    recovery_time: float = 0.0
    #: set at eviction, closed at the next emission (engine-internal)
    recovery_started: Optional[float] = None
    #: the prompt's full blocks are still to be published in the prefix
    #: index, at the first emission, once they are written (engine-internal)
    needs_register: bool = False

    @property
    def ttft(self) -> Optional[float]:
        """First-token latency in seconds (None until measured)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def latency(self) -> Optional[float]:
        """End-to-end latency in seconds (None until finished)."""
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def done(self) -> bool:
        """True once the request has finished (any reason)."""
        return self.status == Status.FINISHED

    def make_output(self, new_tokens: List[int]) -> RequestOutput:
        """Snapshot this request's state as a public RequestOutput."""
        done = self.done
        return RequestOutput(
            rid=self.rid, prompt_len=len(self.prompt),
            new_token_ids=list(new_tokens),
            output_token_ids=list(self.output),
            finished=done, finish_reason=self.finish_reason if done else None,
            cached_tokens=self.cached_tokens,
            num_preemptions=self.num_preemptions,
            replay_iterations=self.replay_iterations,
            recovery_time=self.recovery_time,
            ttft=self.ttft if done else None,
            latency=self.latency if done else None)
