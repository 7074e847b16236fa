"""Slot-based continuous-batching scheduler (port of
``repro/serve/scheduler.py``).

Requests wait in an arrival queue; a request is admitted when (a) a
decode slot is free and (b) the page pool can reserve EVERY page the
request can ever need (prompt + max_new tokens, rounded up to whole
pages).  Retirement (EOS or max-token) frees the slot and its pages
immediately, so waiting requests fill the hole on the next tick —
admission and retirement never stall the other slots' decodes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional

from repro_torch.serve.pool import PagePool

__all__ = ["Request", "SlotScheduler"]

WAITING, ACTIVE, DONE = "waiting", "active", "done"


@dataclasses.dataclass
class Request:
    """One generation request plus its in-flight state."""

    rid: int
    tokens: List[int]                      # prompt token ids
    max_new: int
    image_embeds: Optional[Any] = None     # (n_img, d_vision) for VLM cfgs
    arrival_time: float = 0.0

    # runtime state (owned by the scheduler/engine)
    state: str = WAITING
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    out: List[int] = dataclasses.field(default_factory=list)
    qpos: int = 0             # position of the NEXT token to decode
    finish_reason: str = ""
    # per-token wall-clock emission times (benchmark latency accounting)
    emit_times: List[float] = dataclasses.field(default_factory=list)
    prefill_time: float = 0.0

    def prompt_len(self, n_image_tokens: int = 0) -> int:
        n_img = n_image_tokens if self.image_embeds is not None else 0
        return len(self.tokens) + n_img

    def target_len(self, n_image_tokens: int = 0) -> int:
        """Max positions this request can ever occupy."""
        return self.prompt_len(n_image_tokens) + self.max_new


class SlotScheduler:
    """Admission + retirement over ``n_slots`` decode slots."""

    def __init__(self, n_slots: int, pool: PagePool, page_size: int, *,
                 n_image_tokens: int = 0):
        self.n_slots = n_slots
        self.pool = pool
        self.page_size = page_size
        self.n_image_tokens = n_image_tokens
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.requests: Dict[int, Request] = {}

    # -- queue ----------------------------------------------------------
    def submit(self, req: Request) -> int:
        if req.rid in self.requests:
            raise ValueError(f"duplicate rid {req.rid}")
        self.requests[req.rid] = req
        self.waiting.append(req)
        return req.rid

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def idle(self) -> bool:
        return not self.waiting and all(s is None for s in self.slots)

    def pages_needed(self, req: Request) -> int:
        t = req.target_len(self.n_image_tokens)
        return -(-t // self.page_size)  # ceil

    # -- admission ------------------------------------------------------
    def admit(self) -> List[Request]:
        """Admit waiting requests into free slots while pages last.

        FIFO head-of-line: if the oldest waiting request cannot reserve
        its pages we stop (no starvation of big requests by later small
        ones).  Returns the newly admitted requests — the engine prefills
        them as one batch, separately from the decode tick.
        """
        admitted: List[Request] = []
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        while self.waiting and free_slots:
            req = self.waiting[0]
            if not self.pool.can_alloc(self.pages_needed(req)):
                break
            self.waiting.popleft()
            req.pages = self.pool.alloc(self.pages_needed(req), req.rid)
            req.slot = free_slots.pop(0)
            req.state = ACTIVE
            req.qpos = req.prompt_len(self.n_image_tokens)
            self.slots[req.slot] = req
            admitted.append(req)
        return admitted

    # -- retirement -----------------------------------------------------
    def retire(self, req: Request, reason: str) -> None:
        """Free the request's slot and pages immediately."""
        assert req.state == ACTIVE and self.slots[req.slot] is req
        self.slots[req.slot] = None
        self.pool.free_owner(req.rid)
        req.pages = []
        req.slot = -1
        req.state = DONE
        req.finish_reason = reason
