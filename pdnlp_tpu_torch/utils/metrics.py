"""Serving observability primitives (``pdnlp_tpu/utils/metrics.py``'s
``Counter`` / ``Gauge`` / ``Histogram``): thread-safe, JSON-snapshot
friendly, aggregated by ``serve.metrics.ServeMetrics``."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np


class Counter:
    """Monotonic event count (thread-safe: batcher worker + submitters)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (e.g. queue depth)."""

    def __init__(self) -> None:
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Streaming histogram with exact percentiles over a bounded window:
    count/sum/min/max are exact over all observations, percentiles over the
    most recent ``window`` of them.  Thread-safe."""

    def __init__(self, window: int = 8192):
        self._lock = threading.Lock()
        self._window = int(window)
        self._recent: List[float] = []
        self._pos = 0  # ring-buffer cursor once the window is full
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._recent) < self._window:
                self._recent.append(v)
            else:
                self._recent[self._pos] = v
                self._pos = (self._pos + 1) % self._window

    def percentiles(self, ps: Sequence[float]) -> Optional[List[float]]:
        """All requested percentiles over one copy of the window."""
        with self._lock:
            if not self._recent:
                return None
            window = np.asarray(self._recent)
        return [float(v) for v in np.percentile(window, list(ps))]

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def snapshot(self) -> Dict[str, Optional[float]]:
        """JSON-ready summary: count/mean/min/max + p50/p95/p99."""
        ps = self.percentiles((50, 95, 99)) or [None, None, None]
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": ps[0],
            "p95": ps[1],
            "p99": ps[2],
        }
