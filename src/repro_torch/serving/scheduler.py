"""Continuous-batching scheduler (Orca-style iteration-level scheduling).

Port of ``repro.serving.scheduler`` without preemption (it comes with block
growth).  FCFS admission into a fixed pool of decode slots, additionally
gated on KV blocks by the engine's ``admit_gate``; if the queue head does
not fit, younger requests wait behind it (no starvation).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional

from .request import Request, Status


@dataclasses.dataclass
class Scheduler:
    """FCFS continuous-batching scheduler over ``n_slots`` decode slots."""

    n_slots: int
    #: block-aware admission gate with reservation semantics: returning
    #: True may allocate resources for the request as a side effect
    admit_gate: Optional[Callable[[Request], bool]] = None

    def __post_init__(self):
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * self.n_slots

    def add(self, req: Request) -> None:
        """Enqueue an already-validated request."""
        self.waiting.append(req)

    def remove_waiting(self, req: Request) -> bool:
        """Drop a not-yet-admitted request from the queue (abort path)."""
        try:
            self.waiting.remove(req)
            return True
        except ValueError:
            return False

    def free_slots(self) -> List[int]:
        """Indices of unoccupied decode slots."""
        return [i for i, r in enumerate(self.slots) if r is None]

    def admit(self) -> List[Request]:
        """Move waiting requests into free slots (FCFS, head-of-line
        blocking); returns the newly admitted."""
        admitted = []
        for i in self.free_slots():
            if not self.waiting:
                break
            req = self.waiting[0]
            if self.admit_gate is not None and not self.admit_gate(req):
                break
            self.waiting.popleft()
            req.slot, req.status = i, Status.RUNNING
            self.slots[i] = req
            admitted.append(req)
        return admitted

    def running(self) -> List[Request]:
        """Requests currently occupying slots, in slot order."""
        return [r for r in self.slots if r is not None]

    def plan(self, chunk: int):
        """One iteration's feed width and per-request token counts:
        ``t_step`` is ``chunk`` when any running request needs more than
        one token (a prompt still prefilling), else 1.  Returns
        ``(t_step, {rid: min(t_step, need)})``."""
        need = {r.rid: len(r.prompt) + len(r.output) - r.pos
                for r in self.running()}
        t_step = chunk if any(n > 1 for n in need.values()) else 1
        return t_step, {rid: min(t_step, n) for rid, n in need.items()}

    def finish(self, req: Request, t: float) -> None:
        """Retire a running request at time ``t`` and free its slot."""
        req.status = Status.FINISHED
        req.finish_time = t
        self.slots[req.slot] = None

    @property
    def idle(self) -> bool:
        """True when nothing is waiting or running."""
        return not self.waiting and all(r is None for r in self.slots)
