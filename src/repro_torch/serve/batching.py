"""Continuous batching (Orca-style iteration-level scheduling).

A copy of ``repro.serve.batching``: requests join and leave the running
decode batch at token boundaries over a fixed slot array, FIFO with an
admission check (a KV-pool check keeps the pool from thrashing). The
scheduler is host-side and O(batch) per step.

**Chunked prefill** (Sarathi-style): with ``prefill_chunk_tokens`` set,
an admitted request does not start decoding at once: its prompt is
prefilled in chunks drawn from a per-step token budget
(:meth:`ContinuousBatcher.prefill_pack` /
:meth:`~ContinuousBatcher.apply_prefill`), interleaved with the running
decode batch, and the request joins decode only on the step *after* its
last chunk lands. Without the knob (``None``, the serve driver's use), the
whole prompt counts as prefilled at admission and the request decodes from
its first step. How chunks turn into memory traffic is the caller's
business: the row-paged cache (``serve/kv_cache.py``) emits a chunk's
records with ``append_chunk_stream``.
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
    ``-1`` means the event has not happened yet. The serving replay
    (:mod:`repro.serve.replay`) folds memory-system makespans back onto
    these indices to produce TTFT/TPOT in nanoseconds.
    """

    submitted_step: int = -1     # entered the wait queue
    admitted_step: int = -1      # first step it occupies a slot in
    prefill_done_step: int = -1  # step whose prefill pack finished the prompt
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
    #: prompt tokens whose KV has been prefilled so far; reaches
    #: prompt_len instantly at admission in legacy (unchunked) mode.
    prefilled_tokens: int = 0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prefill_done(self) -> bool:
        return self.prefilled_tokens >= self.prompt_len


class ContinuousBatcher:
    """Iteration-level scheduler over a fixed number of batch slots.

    ``prefill_chunk_tokens`` (None = legacy whole-prompt-at-admission)
    sets the per-step prompt-token budget for chunked prefill: each step,
    :meth:`prefill_pack` proposes up to that many prompt tokens across
    the admitted-but-unprefilled requests (FIFO), the caller turns the
    pack into memory traffic, and :meth:`apply_prefill` commits it after
    the step's tokens are accounted — so a request whose last chunk
    lands during step *i* starts decoding at step *i + 1*.
    """

    def __init__(self, n_slots: int, admit: Optional[Callable] = None,
                 prefill_chunk_tokens: Optional[int] = None):
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1 (or None for legacy "
                f"instant prefill), got {prefill_chunk_tokens}")
        self.n_slots = n_slots
        self.prefill_chunk_tokens = prefill_chunk_tokens
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

    # -- one scheduling iteration ---------------------------------------------

    def schedule(self) -> list[tuple[int, Request]]:
        """Fill free slots from the queue (FIFO + admission check); returns
        newly admitted (slot, request) pairs — callers run prefill for them."""
        admitted = []
        for slot in range(self.n_slots):
            if self.active[slot] is not None or not self.queue:
                continue
            if not self.admit(self.queue[0]):
                break                        # pool full: preserve FIFO order
            req = self.queue.popleft()
            req.slot = slot
            req.timeline.admitted_step = self.steps
            if self.prefill_chunk_tokens is None:
                # Legacy model: the whole prompt is prefilled at
                # admission (the caller emits it analytically or not at
                # all); the request decodes from its first step.
                req.prefilled_tokens = req.prompt_len
                req.timeline.prefill_done_step = self.steps
            self.active[slot] = req
            admitted.append((slot, req))
        return admitted

    def prefill_pack(self) -> list[tuple[int, "Request", int]]:
        """The next step's prefill work: up to ``prefill_chunk_tokens``
        prompt tokens across admitted-but-unprefilled requests, FIFO by
        admission order. Returns (slot, request, n_tokens) triples —
        pure proposal, commits nothing; hand the pack back to
        :meth:`apply_prefill` once the step it rode in has been
        accounted. Empty in legacy mode."""
        if self.prefill_chunk_tokens is None:
            return []
        budget = self.prefill_chunk_tokens
        pack = []
        pending = sorted(
            ((req.timeline.admitted_step, slot, req)
             for slot, req in enumerate(self.active)
             if req is not None and not req.prefill_done))
        for _, slot, req in pending:
            if budget <= 0:
                break
            take = min(budget, req.prompt_len - req.prefilled_tokens)
            pack.append((slot, req, take))
            budget -= take
        return pack

    def apply_prefill(self, pack: list) -> list["Request"]:
        """Commit a :meth:`prefill_pack` after the step that carried it
        (call *after* :meth:`record_tokens`, so a request finishing its
        prompt during step *i* is decode-eligible at step *i + 1*).
        Returns the requests whose prefill just completed."""
        done = []
        for _, req, take in pack:
            req.prefilled_tokens += take
            if req.prefill_done:
                req.timeline.prefill_done_step = self.steps - 1
                done.append(req)
        return done

    def record_tokens(self, tokens: np.ndarray,
                      decode: bool = True) -> list[Request]:
        """Account one step's sampled tokens (n_slots,); retire finished
        requests. Returns the requests that completed this step.
        Requests still mid-prefill occupy (and are billed for) their
        slot but emit no token. ``decode=False`` accounts a
        prefill-only step — the step counter and slot accounting
        advance, but no slot samples (the no-overlap packing-prefetch
        schedule stalls decode while a prefill chunk streams in)."""
        step = self.steps
        self.steps += 1
        finished = []
        for slot, req in enumerate(self.active):
            self.slot_steps += 1
            if req is None:
                continue
            self.busy_slot_steps += 1
            if not decode or not req.prefill_done:
                continue
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
