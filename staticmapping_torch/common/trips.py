"""Trip counters of the iterative matchers' while loops: the trips executed
against the trips each alignment needed to converge."""
from __future__ import annotations

from typing import Dict, Optional

import torch


class TripCounter:
    """``run`` counts the trips executed, a host count; ``needed`` adds up
    each alignment's iteration counter on the device, so counting costs no
    host sync until :meth:`counts` reads it."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.run = 0
        self._needed: Optional[torch.Tensor] = None

    def add(self, run: int, needed: torch.Tensor) -> None:
        needed = needed.sum(dtype=torch.int64)
        self.run += run
        self._needed = (needed if self._needed is None
                        else self._needed.to(needed.device) + needed)

    def counts(self) -> Dict[str, int]:
        return {"run": self.run,
                "needed": 0 if self._needed is None else int(self._needed)}
