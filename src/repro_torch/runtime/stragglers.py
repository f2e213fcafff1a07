"""Straggler mitigation policies: the port of
``repro/runtime/stragglers.py`` (host code, no device).

* ``DeadlineSkip``: a per-step deadline on a host-side dependency (a
  data fetch, a checkpoint barrier).  A miss is skipped and counted; a
  run of ``escalate_after`` misses in a row raises ``TimeoutError`` for
  the fault layer (the node is probably sick, not slow).
* At the scheduling layer, PPCC admission itself is the mitigation:
  conflicting updates from slow replicas do not hold back fast ones
  (``examples/async_training_torch.py``).
"""
from __future__ import annotations

import dataclasses
import queue
from typing import Any, Callable, Optional


@dataclasses.dataclass
class StragglerStats:
    served: int = 0
    skipped: int = 0
    consecutive_misses: int = 0


class DeadlineSkip:
    def __init__(self, deadline_s: float, escalate_after: int = 5):
        self.deadline_s = deadline_s
        self.escalate_after = escalate_after
        self.stats = StragglerStats()

    def fetch(self, get: Callable[[float], Any],
              fallback: Optional[Any] = None) -> Any:
        """``get(timeout)`` raises ``queue.Empty`` on the deadline; a miss
        returns ``fallback``."""
        try:
            item = get(self.deadline_s)
            self.stats.served += 1
            self.stats.consecutive_misses = 0
            return item
        except queue.Empty:
            self.stats.skipped += 1
            self.stats.consecutive_misses += 1
            if self.stats.consecutive_misses >= self.escalate_after:
                raise TimeoutError(
                    f"{self.stats.consecutive_misses} consecutive "
                    f"deadline misses — escalating to fault handling")
            return fallback
