"""Slot-level batching policy of the serving engine.

A copy of ``repro.core.scheduler.SlotScheduler``: the port imports nothing of
the JAX package, so it keeps its own copy of this pure-Python policy. The
admission, budget and refill decisions are the same code, so the port's
engine and the JAX engine schedule a request stream identically.

The scheduler owns `n_slots` slots, each either free or holding an opaque
request handle with a remaining token budget. Policies:

  continuous — a finished slot is refilled as soon as a request is waiting
               (vLLM-style continuous batching);
  static     — a new wave is admitted only when every slot has drained, and
               (if more arrivals are expected) only once a full batch of
               requests is waiting.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

POLICIES = ("continuous", "static")


class SlotScheduler:
    """Continuous/static batching over a fixed set of slots."""

    def __init__(self, n_slots: int, policy: str = "continuous") -> None:
        if n_slots < 1:
            raise ValueError("need at least one slot")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; have {POLICIES}")
        self.n_slots = n_slots
        self.policy = policy
        self.slot_req: List[Optional[Any]] = [None] * n_slots
        self.slot_budget: List[int] = [0] * n_slots

    # -- state queries -----------------------------------------------------
    @property
    def idle(self) -> bool:
        return all(r is None for r in self.slot_req)

    def live_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    # -- admission ---------------------------------------------------------
    def plan_wave(self, waiting: Sequence[Any],
                  more_coming: bool = False) -> List[Tuple[int, Any]]:
        """Pair waiting requests with the slots they may occupy NOW.

        `more_coming` tells a static-batching scheduler whether later
        arrivals could still top up a partial batch (it then holds the wave
        until the batch fills); continuous batching admits greedily.
        """
        if not waiting:
            return []
        if self.policy == "static":
            if not self.idle:
                return []
            if more_coming and len(waiting) < self.n_slots:
                return []
        free = self.free_slots()
        return list(zip(free, waiting))

    def admit(self, slot: int, req: Any, budget: int) -> bool:
        """Occupy `slot` with `req` for `budget` further tokens. A request
        whose budget is already exhausted (e.g. it finished at prefill)
        leaves the slot free; returns whether the slot was occupied."""
        if self.slot_req[slot] is not None:
            raise ValueError(f"slot {slot} is occupied")
        if budget <= 0:
            return False
        self.slot_req[slot] = req
        self.slot_budget[slot] = budget
        return True

    # -- per-token bookkeeping --------------------------------------------
    def step(self, slot: int, hit_eos: bool = False) -> bool:
        """Account one emitted token for `slot`; release it when its budget
        is spent or EOS was sampled. Returns whether the slot finished."""
        if self.slot_req[slot] is None:
            raise ValueError(f"slot {slot} is free")
        self.slot_budget[slot] -= 1
        if self.slot_budget[slot] <= 0 or hit_eos:
            self.slot_req[slot] = None
            self.slot_budget[slot] = 0
            return True
        return False

    def release(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.slot_budget[slot] = 0
