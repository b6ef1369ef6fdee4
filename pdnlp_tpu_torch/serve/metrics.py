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
(replica-labelled queue depth, occupancy and failure counters).
Generative decoding adds :class:`DecodeMetrics` (tokens, TTFT and
inter-token gaps, the KV and page gauges, and the speculation and handoff
counters that ``serve.decode``'s drafter pairs and split pools move).
The multi-model fleet (``serve.fleet.FleetRouter``) adds
:class:`FleetMetrics`: how its traffic policy split the caller stream.
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


class DecodeMetrics:
    """Generative-decoding observability (``serve.decode``), in the units
    that tier actually optimizes — TOKENS and inter-token gaps, not
    request rows:

    - ``streams_total`` / ``rejected_total`` / ``deadline_expired_total``
      — stream admission accounting (rejects include KV-budget refusals);
    - ``prefills_total`` / ``prefill_tokens_total`` — bucketed prompt
      forwards and the prompt tokens they consumed;
    - ``decode_steps_total`` / ``tokens_out_total`` — fixed-shape decode
      dispatches and the tokens they produced (tokens/s/chip = the bench
      headline);
    - ``ttft_ms`` — submit -> first token (the prefill-visible latency);
    - ``intertoken_ms`` — gap between consecutive tokens of one stream
      (p99 is the streaming SLO ``bench.py --decode`` gates);
    - ``waiting`` — streams queued for a free slot;
    - ``kv_bytes_live`` / ``kv_slots_live`` — live KV occupancy (the
      ``--kv_hbm_mb`` budget gauge on ``/metrics``);
    - ``kv_pages_live`` / ``kv_pages_free`` — paged layout only: page
      pool occupancy and free-list depth (allocator/index detail rides
      ``kv_snapshot()``/``control_snapshot()``);
    - ``peak_live_streams`` — high-water concurrent live streams (the
      admitted-concurrency headline the paged-vs-slot bench gates).

    Speculative decoding (draft-k / verify-1) adds its acceptance
    accounting — the live signal the controller's ``draft_k`` law and
    the bench's speedup gate both read:

    - ``draft_tokens_total`` / ``accepted_tokens_total`` — tokens the
      cheap drafter proposed / tokens the primary's verify call kept
      (their ratio is the acceptance rate; every ACCEPTED token skipped
      one full primary decode step);
    - ``verify_calls_total`` / ``spec_rounds_total`` — primary verify
      dispatches and completed draft→verify rounds;
    - ``accept_rate`` — live cumulative acceptance gauge (per-stream
      counts ride the ``verify`` hops);
    - ``drafter_deaths_total`` — drafter engines lost mid-storm (each
      one degraded its pair to primary-only decode, decision-recorded).

    Disaggregated pools (prefill-role vs decode-role engines) add the
    handoff accounting — sender-side, counted when the receiver ACKED:

    - ``handoffs_total`` / ``handoff_pages_total`` /
      ``handoff_bytes_total`` — placed handoffs and the page/byte
      volume they moved between allocators;
    - ``handoff_failures_total`` — dispatches no decode engine took
      (each one re-prefilled at the sender: recovery, not loss);
    - ``handoff_ms`` — export→ack latency per handoff (the
      disaggregation tax ``bench.py --decode`` phase F budgets).
    """

    def __init__(self) -> None:
        self.streams_total = Counter()
        self.rejected_total = Counter()
        self.deadline_expired_total = Counter()
        self.prefills_total = Counter()
        self.prefill_tokens_total = Counter()
        self.decode_steps_total = Counter()
        self.tokens_out_total = Counter()
        self.draft_tokens_total = Counter()
        self.accepted_tokens_total = Counter()
        self.verify_calls_total = Counter()
        self.spec_rounds_total = Counter()
        self.drafter_deaths_total = Counter()
        self.handoffs_total = Counter()
        self.handoff_pages_total = Counter()
        self.handoff_bytes_total = Counter()
        self.handoff_failures_total = Counter()
        self.ttft_ms = Histogram()
        self.intertoken_ms = Histogram()
        self.handoff_ms = Histogram()
        self.waiting = Gauge()
        self.accept_rate = Gauge()
        self.kv_bytes_live = Gauge()
        self.kv_slots_live = Gauge()
        self.kv_pages_live = Gauge()
        self.kv_pages_free = Gauge()
        self.peak_live_streams = Gauge()

    def snapshot(self) -> Dict:
        return {
            "streams_total": self.streams_total.value,
            "rejected_total": self.rejected_total.value,
            "deadline_expired_total": self.deadline_expired_total.value,
            "prefills_total": self.prefills_total.value,
            "prefill_tokens_total": self.prefill_tokens_total.value,
            "decode_steps_total": self.decode_steps_total.value,
            "tokens_out_total": self.tokens_out_total.value,
            "draft_tokens_total": self.draft_tokens_total.value,
            "accepted_tokens_total": self.accepted_tokens_total.value,
            "verify_calls_total": self.verify_calls_total.value,
            "spec_rounds_total": self.spec_rounds_total.value,
            "drafter_deaths_total": self.drafter_deaths_total.value,
            "handoffs_total": self.handoffs_total.value,
            "handoff_pages_total": self.handoff_pages_total.value,
            "handoff_bytes_total": self.handoff_bytes_total.value,
            "handoff_failures_total": self.handoff_failures_total.value,
            "accept_rate": self.accept_rate.value,
            "ttft_ms": self.ttft_ms.snapshot(),
            "intertoken_ms": self.intertoken_ms.snapshot(),
            "handoff_ms": self.handoff_ms.snapshot(),
            "waiting": self.waiting.value,
            "kv_bytes_live": self.kv_bytes_live.value,
            "kv_slots_live": self.kv_slots_live.value,
            "kv_pages_live": self.kv_pages_live.value,
            "kv_pages_free": self.kv_pages_free.value,
            "peak_live_streams": self.peak_live_streams.value,
        }


class FleetMetrics:
    """Fleet-front-door observability (``FleetRouter``): how the traffic
    policy split the caller stream across models.  Per-model serving
    metrics stay on each group's own :class:`RouterMetrics` /
    :class:`ReplicaMetrics` — the fleet snapshot keys those by model id so
    the exporter can label them — and these counters are the policy's own
    receipts:

    - ``requests_total`` — caller submissions through the fleet door;
    - ``canary_routed_total`` — caller requests the canary fraction sent
      to the candidate (their answers are the candidate's);
    - ``shadows_total`` / ``shadow_dropped_total`` — shadow duplicates
      admitted on the candidate / refused at its door (callers unaffected
      either way);
    - ``degraded_total`` — degrade-band arrivals re-routed to the cheap
      model instead of shed;
    - ``degrade_fallthrough_total`` — degrade-band arrivals with no cheap
      model registered (fell through to the shed tier, loudly);
    - ``rollbacks_total`` / ``rolled_back_requests_total`` — canary
      rollback events / requests drained candidate -> primary by them.
    """

    def __init__(self) -> None:
        self.requests_total = Counter()
        self.canary_routed_total = Counter()
        self.shadows_total = Counter()
        self.shadow_dropped_total = Counter()
        self.degraded_total = Counter()
        self.degrade_fallthrough_total = Counter()
        self.rollbacks_total = Counter()
        self.rolled_back_requests_total = Counter()

    def snapshot(self) -> Dict:
        return {
            "requests_total": self.requests_total.value,
            "canary_routed_total": self.canary_routed_total.value,
            "shadows_total": self.shadows_total.value,
            "shadow_dropped_total": self.shadow_dropped_total.value,
            "degraded_total": self.degraded_total.value,
            "degrade_fallthrough_total":
                self.degrade_fallthrough_total.value,
            "rollbacks_total": self.rollbacks_total.value,
            "rolled_back_requests_total":
                self.rolled_back_requests_total.value,
        }
