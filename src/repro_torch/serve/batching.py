"""Continuous batching (Orca-style iteration-level scheduling).

A copy of the part of ``repro.serve.batching`` that the serve driver runs:
requests join and leave the running decode batch at token boundaries over
a fixed slot array, FIFO with an admission check. The whole prompt counts
as prefilled at admission; chunked prefill (``prefill_chunk_tokens``,
``prefill_pack``, ``apply_prefill``) is not ported yet.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class RequestTimeline:
    """Step indices of a request's lifecycle events, maintained by
    :class:`ContinuousBatcher`. An index refers to the decode step *about
    to run* when the event happened (0-based count of completed steps);
    ``-1`` means the event has not happened yet."""

    submitted_step: int = -1     # entered the wait queue
    admitted_step: int = -1      # first step it occupies a slot in
    prefill_done_step: int = -1  # == admitted_step: prefill at admission
    first_token_step: int = -1   # step that produced its first token
    completed_step: int = -1     # step that produced its last token

    @property
    def decode_steps(self) -> int:
        """Steps spent decoding (== tokens produced) once completed."""
        if self.completed_step < 0 or self.admitted_step < 0:
            return 0
        return self.completed_step - self.admitted_step + 1


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    out_tokens: list = field(default_factory=list)
    slot: int = -1
    done: bool = False
    timeline: RequestTimeline = field(default_factory=RequestTimeline)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


class ContinuousBatcher:
    """Iteration-level scheduler over a fixed number of batch slots."""

    def __init__(self, n_slots: int, admit: Optional[Callable] = None):
        self.n_slots = n_slots
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * n_slots
        self.admit = admit or (lambda req: True)
        self.completed: list[Request] = []
        self.steps = 0
        self.slot_steps = 0
        self.busy_slot_steps = 0

    def submit(self, req: Request) -> None:
        req.timeline.submitted_step = self.steps
        self.queue.append(req)

    def schedule(self) -> list[tuple[int, Request]]:
        """Fill free slots from the queue (FIFO + admission check); returns
        newly admitted (slot, request) pairs."""
        admitted = []
        for slot in range(self.n_slots):
            if self.active[slot] is not None or not self.queue:
                continue
            if not self.admit(self.queue[0]):
                break                        # pool full: preserve FIFO order
            req = self.queue.popleft()
            req.slot = slot
            req.timeline.admitted_step = self.steps
            req.timeline.prefill_done_step = self.steps
            self.active[slot] = req
            admitted.append((slot, req))
        return admitted

    def record_tokens(self, tokens: np.ndarray) -> list[Request]:
        """Account one step's sampled tokens (n_slots,); retire finished
        requests. Returns the requests that completed this step."""
        step = self.steps
        self.steps += 1
        finished = []
        for slot, req in enumerate(self.active):
            self.slot_steps += 1
            if req is None:
                continue
            self.busy_slot_steps += 1
            req.out_tokens.append(int(tokens[slot]))
            if len(req.out_tokens) == 1:
                req.timeline.first_token_step = step
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                req.slot = -1
                req.timeline.completed_step = step
                self.active[slot] = None
                self.completed.append(req)
                finished.append(req)
        return finished

    @property
    def occupancy(self) -> float:
        """Fraction of slot-steps that carried a live request."""
        return (self.busy_slot_steps / self.slot_steps
                if self.slot_steps else 0.0)

    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.active)
