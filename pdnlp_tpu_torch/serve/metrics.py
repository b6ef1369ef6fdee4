"""Serving observability: the one object the engine, batcher and offline
scorer share (``pdnlp_tpu/serve/metrics.py``'s ``ServeMetrics``).

- ``request_latency_ms`` — submit -> result per request (p50/p95/p99);
- ``queue_wait_ms`` — how long requests sat before their batch flushed;
- ``queue_depth`` / ``queue_tokens`` — queued requests / queued real tokens;
- ``batch_occupancy`` — per executed batch: real rows / padded rows on the
  padded path, real tokens / token slots on the packed path;
- ``fill_ratio`` / ``padding_waste`` — real tokens over token slots of each
  executed batch on both paths, and its complement;
- ``cache_hits`` / ``cache_misses`` — first call at a batch shape vs every
  later one (PyTorch runs eagerly, so a miss costs nothing until per-shape
  CUDA graphs give it a price; the JAX retrace counter has no twin yet);
- ``requests_total`` / ``rejected_total`` / ``deadline_expired_total`` /
  ``batches_total`` — admission and dispatch accounting.
"""
from __future__ import annotations

import json
import os
from typing import Dict

from pdnlp_tpu_torch.utils.metrics import Counter, Gauge, Histogram


class ServeMetrics:
    def __init__(self) -> None:
        self.request_latency_ms = Histogram()
        self.queue_wait_ms = Histogram()
        self.batch_occupancy = Histogram()
        self.fill_ratio = Histogram()
        self.padding_waste = Histogram()
        self.queue_depth = Gauge()
        self.queue_tokens = Gauge()
        self.cache_hits = Counter()
        self.cache_misses = Counter()
        self.requests_total = Counter()
        self.rejected_total = Counter()
        self.deadline_expired_total = Counter()
        self.batches_total = Counter()

    def snapshot(self) -> Dict:
        """JSON-ready state of every instrument (plain floats/ints only)."""
        return {
            "requests_total": self.requests_total.value,
            "rejected_total": self.rejected_total.value,
            "deadline_expired_total": self.deadline_expired_total.value,
            "batches_total": self.batches_total.value,
            "queue_depth": self.queue_depth.value,
            "queue_tokens": self.queue_tokens.value,
            "request_latency_ms": self.request_latency_ms.snapshot(),
            "queue_wait_ms": self.queue_wait_ms.snapshot(),
            "batch_occupancy": self.batch_occupancy.snapshot(),
            "fill_ratio": self.fill_ratio.snapshot(),
            "padding_waste": self.padding_waste.snapshot(),
            "shape_cache": {
                "hits": self.cache_hits.value,
                "misses": self.cache_misses.value,
            },
        }

    def save(self, path: str) -> None:
        """Atomic JSON dump."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
        os.replace(tmp, path)
