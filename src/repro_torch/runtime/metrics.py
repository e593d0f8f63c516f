"""JSONL metrics logger (append-only, crash-safe line granularity) and
small reusable measurement primitives: a bounded latency window and a
mergeable log-bucketed histogram for window-free percentiles."""
from __future__ import annotations

import collections
import json
import math
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL sink. Usable as a context manager so the file
    handle is released deterministically::

        with MetricsLogger(path) as m:
            m.log(0, qps=...)
    """

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        else:
            self._f = None

    def log(self, step: int, **values: Any):
        rec: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        if self.echo:
            kv = " ".join(f"{k}={v:.5g}" if isinstance(v, float)
                          else f"{k}={v}" for k, v in rec.items()
                          if k not in ("time",))
            print(kv, flush=True)
        return rec

    def close(self):
        """Close the JSONL file handle (idempotent)."""
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class LatencyWindow:
    """Bounded sliding window of durations with percentile readout.

    O(1) record; percentile sorts the window on demand (the window is
    small — serving stats snapshots are off the hot path). Percentiles
    use the NEAREST-RANK method: the value at rank ``ceil(q/100 * n)``
    (1-indexed). The old implementation rounded ``q/100 * (n-1)`` with
    banker's-rounding ``round()``, which on small windows could resolve
    a rank LOW (e.g. p50 of 4 samples landed on the 3rd, p-anything at
    an exact ``.5`` rank rounded to the even neighbor) — nearest-rank
    never under-reports.
    """

    def __init__(self, maxlen: int = 4096):
        self._buf: collections.deque = collections.deque(maxlen=maxlen)
        self.count = 0

    def record(self, seconds: float):
        self._buf.append(float(seconds))
        self.count += 1

    def percentile(self, q: float) -> float:
        """q in [0, 100]; 0.0 when empty (nearest-rank method)."""
        if not self._buf:
            return 0.0
        data = sorted(self._buf)
        rank = math.ceil(q / 100.0 * len(data))       # 1-indexed
        return data[min(len(data) - 1, max(0, rank - 1))]

    def summary(self, prefix: str = "") -> Dict[str, float]:
        return {
            f"{prefix}p50_ms": self.percentile(50) * 1e3,
            f"{prefix}p99_ms": self.percentile(99) * 1e3,
            f"{prefix}max_ms": (max(self._buf) * 1e3 if self._buf else 0.0),
        }


class Histogram:
    """Mergeable log-bucketed histogram: full-history percentiles with
    bounded relative error and O(1) memory per occupied bucket.

    A :class:`LatencyWindow` truncates to its last ``maxlen`` samples,
    so long-tail percentiles silently forget everything before the
    window. This histogram keeps EVERY sample in geometric buckets:
    bucket *i* covers ``[min_value * growth**i, min_value *
    growth**(i+1))``, so any reported percentile is within a factor of
    ``growth`` of the true nearest-rank value regardless of how many
    samples were recorded. Buckets are a sparse dict, so a latency
    distribution spanning microseconds to seconds occupies a few
    hundred ints.

    Merge (:meth:`merge`) adds another histogram's buckets — the
    cross-worker/cross-window aggregation story counters need and
    windows cannot have. Two histograms merge iff their ``growth`` and
    ``min_value`` agree.
    """

    def __init__(self, growth: float = 1.1, min_value: float = 1e-9):
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        if min_value <= 0.0:
            raise ValueError("min_value must be > 0")
        self.growth = float(growth)
        self.min_value = float(min_value)
        self._log_g = math.log(self.growth)
        self._counts: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf

    def record(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if v <= self.min_value:
            i = 0       # underflow bucket (0.0 and negatives land here)
        else:
            i = int(math.log(v / self.min_value) / self._log_g)
        self._counts[i] = self._counts.get(i, 0) + 1

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s samples into this histogram (in place);
        returns self for chaining."""
        if (other.growth != self.growth
                or other.min_value != self.min_value):
            raise ValueError(
                "histograms only merge with matching growth/min_value: "
                f"({self.growth}, {self.min_value}) vs "
                f"({other.growth}, {other.min_value})")
        for i, n in other._counts.items():
            self._counts[i] = self._counts.get(i, 0) + n
        self.count += other.count
        self.total += other.total
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        return self

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100]; 0.0 when empty. Nearest-rank over buckets:
        returns the geometric midpoint of the bucket holding the ranked
        sample (within a factor of ``growth`` of the true value),
        clamped to the exactly-tracked observed min/max."""
        if not self.count:
            return 0.0
        rank = min(self.count,
                   max(1, math.ceil(q / 100.0 * self.count)))
        seen = 0
        for i in sorted(self._counts):
            seen += self._counts[i]
            if seen >= rank:
                mid = self.min_value * self.growth ** (i + 0.5)
                return min(self._max, max(self._min, mid))
        return self._max          # unreachable; guard for fp drift

    def summary(self, prefix: str = "",
                scale: float = 1.0) -> Dict[str, float]:
        """p50/p99/max readout matching ``LatencyWindow.summary``'s key
        shape (``scale=1e3`` turns seconds into the ``*_ms`` keys)."""
        return {
            f"{prefix}p50_ms": self.percentile(50) * scale,
            f"{prefix}p99_ms": self.percentile(99) * scale,
            f"{prefix}max_ms": self.max * scale,
        }
