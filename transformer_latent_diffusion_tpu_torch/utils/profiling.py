"""Step timing of the train loop (host clock)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class StepTimer:
    """Step-time and samples-per-second counter over the last `window`
    steps. `tick()` once per step; on a device, call it after work that
    ends in a synchronise, or it times the enqueue."""

    window: int = 50
    _times: List[float] = field(default_factory=list, repr=False)
    _last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def step_ms(self) -> float:
        if not self._times:
            return float("nan")
        return 1000.0 * sum(self._times) / len(self._times)

    def samples_per_sec(self, batch_size: int) -> float:
        if not self._times:
            return float("nan")
        return batch_size * len(self._times) / sum(self._times)

    def summary(self, batch_size: int) -> Dict[str, float]:
        return {"step_ms": self.step_ms,
                "samples_per_sec": self.samples_per_sec(batch_size)}
