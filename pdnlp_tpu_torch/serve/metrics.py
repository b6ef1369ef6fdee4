"""Serving observability (``pdnlp_tpu/serve/metrics.py``): the objects the
engine, batcher, router and offline scorer share.  Snapshot keys are the
JAX package's, so its phase tables and the live exporter read the port's
snapshots unchanged.

What each instrument answers:

- ``request_latency_ms`` — submit -> result per request (p50/p95/p99);
- ``queue_wait_ms`` — how long requests sat before their batch flushed;
- ``queue_depth`` / ``queue_tokens`` — queued requests / queued real tokens;
- ``batch_occupancy`` — per executed batch: real rows / padded rows on the
  padded path, real tokens / token slots on the packed path;
- ``fill_ratio`` / ``padding_waste`` — real tokens over token slots of each
  executed batch on both paths, and its complement;
- ``cache_hits`` / ``cache_misses`` — first call at a batch shape vs every
  later one;
- ``retraces`` — CUDA-graph captures on the card (one per batch shape);
  on the CPU, where the forward runs eagerly, each first-seen shape — the
  twin of JAX's trace-time counter.  After warmup it must stay flat;
- ``requests_total`` / ``rejected_total`` / ``deadline_expired_total`` /
  ``batches_total`` — admission and dispatch accounting.

The replica router adds :class:`RouterMetrics` (admission tiers, requeues,
retries, hedges, ejections, swaps, recovery) and :class:`ReplicaMetrics`
(replica-labelled queue depth, occupancy and failure counters).  The
decode and fleet metrics come with generative decoding (ROADMAP A10) and
the fleet (A9b).
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
        self.retraces = Counter()
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
            "compile_cache": {
                "hits": self.cache_hits.value,
                "misses": self.cache_misses.value,
                "retraces": self.retraces.value,
            },
        }

    def save(self, path: str) -> None:
        """Atomic JSON dump."""
        _save_json(self.snapshot(), path)


def _save_json(obj: Dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, path)


class ReplicaMetrics:
    """One replica's share of the router's observability — every instrument
    is replica-labelled in the snapshot so a sick replica is visible as
    ITSELF, not as a pool-average smear:

    - ``queue_depth`` / ``inflight`` — where that replica's backlog stands;
    - ``batch_occupancy`` — slot accounting for batches IT executed (real
      rows / padded rows padded, real tokens / token slots packed — token
      units, so a packed replica can never read >1.0 or permanently low);
    - ``fill_ratio`` — token-level fill of its executed batches (both
      paths: real tokens / rows x width);
    - ``batches_total`` / ``requests_total`` — dispatch volume;
    - ``requeued_out`` — requests moved OFF this replica at ejection (the
      "ejected without dropping its queued requests" receipt);
    - ``requeued_in`` — requests it absorbed from ejected peers;
    - ``retries`` — failed-batch requests it re-dispatched after a replica
      failure;
    - ``ejections`` — times this slot's replica was ejected (dead/stalled).

    Generative decoding adds the slot view (the decode engine's unit of
    capacity is a KV-cache SLOT, not a queue row):

    - ``slot_occupancy`` — per decode step, live slots / usable slots:
      the continuous-batching health number (streams joining freed slots
      between steps is what keeps it near 1.0 under load);
    - ``slot_reuse_ms`` — freed-slot reuse latency: how long a slot a
      finished stream vacated sat idle before a waiting stream claimed it
      (the online analogue of packing's fill ratio — high occupancy with
      slow reuse means admission, not capacity, is the bottleneck).
    """

    def __init__(self) -> None:
        self.queue_depth = Gauge()
        self.inflight = Gauge()
        self.batch_occupancy = Histogram()
        self.fill_ratio = Histogram()
        self.slot_occupancy = Histogram()
        self.slot_reuse_ms = Histogram()
        self.batches_total = Counter()
        self.requests_total = Counter()
        self.requeued_out = Counter()
        self.requeued_in = Counter()
        self.retries = Counter()
        self.ejections = Counter()

    def snapshot(self) -> Dict:
        return {
            "queue_depth": self.queue_depth.value,
            "inflight": self.inflight.value,
            "batches_total": self.batches_total.value,
            "requests_total": self.requests_total.value,
            "requeued_out": self.requeued_out.value,
            "requeued_in": self.requeued_in.value,
            "retries": self.retries.value,
            "ejections": self.ejections.value,
            "batch_occupancy": self.batch_occupancy.snapshot(),
            "fill_ratio": self.fill_ratio.snapshot(),
            "slot_occupancy": self.slot_occupancy.snapshot(),
            "slot_reuse_ms": self.slot_reuse_ms.snapshot(),
        }


class RouterMetrics:
    """Pool-level router observability: admission tiers, failure handling,
    and the recovery loop.  Per-tier shed accounting
    (``admission`` block: backpressure waits / sheds / hard rejects) is
    what the ``bench.py --serve-load`` report gates on — "tiered shedding
    engaged" must be a recorded number, not an inference."""

    def __init__(self) -> None:
        self.requests_total = Counter()
        self.completed_total = Counter()
        self.failed_total = Counter()          # completed with a non-
        #                                        deadline error (lost)
        self.deadline_expired_total = Counter()
        self.backpressure_waits_total = Counter()
        self.shed_total = Counter()
        self.rejected_total = Counter()
        self.requeued_total = Counter()
        self.retries_total = Counter()
        self.hedges_total = Counter()
        self.ejections_total = Counter()
        self.reintegrations_total = Counter()
        self.swaps_total = Counter()
        self.swap_rollbacks_total = Counter()
        self.scale_downs_total = Counter()     # control plane: healthy ->
        self.scale_ups_total = Counter()       # warm standby and back
        self.queue_depth = Gauge()             # pool-wide pending
        self.request_latency_ms = Histogram()
        self.queue_wait_ms = Histogram()
        self.backpressure_wait_ms = Histogram()
        self.recovery_sec = Histogram()        # ejection -> healthy again

    def snapshot(self) -> Dict:
        return {
            "requests_total": self.requests_total.value,
            "completed_total": self.completed_total.value,
            "failed_total": self.failed_total.value,
            "deadline_expired_total": self.deadline_expired_total.value,
            "admission": {
                "backpressure_waits": self.backpressure_waits_total.value,
                "shed": self.shed_total.value,
                "rejected": self.rejected_total.value,
            },
            "requeued_total": self.requeued_total.value,
            "retries_total": self.retries_total.value,
            "hedges_total": self.hedges_total.value,
            "ejections_total": self.ejections_total.value,
            "reintegrations_total": self.reintegrations_total.value,
            "swaps_total": self.swaps_total.value,
            "swap_rollbacks_total": self.swap_rollbacks_total.value,
            "scale_downs_total": self.scale_downs_total.value,
            "scale_ups_total": self.scale_ups_total.value,
            "queue_depth": self.queue_depth.value,
            "request_latency_ms": self.request_latency_ms.snapshot(),
            "queue_wait_ms": self.queue_wait_ms.snapshot(),
            "backpressure_wait_ms": self.backpressure_wait_ms.snapshot(),
            "recovery_sec": self.recovery_sec.snapshot(),
        }

    def save(self, path: str) -> None:
        _save_json(self.snapshot(), path)
