"""Request objects, sampling parameters, and streamed outputs.

Port of ``repro.serving.request`` for the reservation engine.  The public
output type is :class:`RequestOutput`, an immutable per-iteration snapshot;
the prefix-cache and preemption counters of the JAX ``RequestOutput`` come
with those features.
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
    output carries ``finish_reason`` and the timing metrics."""

    rid: int
    prompt_len: int
    new_token_ids: List[int]
    output_token_ids: List[int]
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
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
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

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
            ttft=self.ttft if done else None,
            latency=self.latency if done else None)
