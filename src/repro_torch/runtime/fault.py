"""Step timing with straggler detection (``StepTimer`` of the JAX
package's ``runtime/fault.py``; the heartbeat, watchdog and preemption
pieces belong to the training slice and are not ported yet)."""
from __future__ import annotations

import time
from typing import List, Optional

class StepTimer:
    """Per-step wall times + straggler detection.

    A step counts as a straggler when it exceeds ``threshold`` x the
    trailing-median. On a real pod this catches slow hosts / data stalls;
    mitigation hooks (skip-batch, re-shard) are the caller's policy — the
    timer provides the signal and the log.
    """

    def __init__(self, window: int = 64, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times: List[float] = []
        self.stragglers: List[dict] = []
        self._t0: Optional[float] = None
        self._step = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = sorted(hist)[len(hist) // 2]
        if len(hist) >= 8 and dt > self.threshold * med:
            self.stragglers.append(
                {"step": self._step, "seconds": dt, "median": med})
        self._step += 1
        return False

    @property
    def median(self) -> float:
        if not self.times:
            return 0.0
        hist = self.times[-self.window:]
        return sorted(hist)[len(hist) // 2]
