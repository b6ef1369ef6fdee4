"""Dynamic micro-batching over a bounded queue — the Orca/vLLM idea in its
fixed-shape classifier form (``pdnlp_tpu/serve/batcher.py`` with the
port's engine; its logic copied).

Requests arrive one at a time; the accelerator wants full fixed-shape
batches.  The batcher bridges the two:

- **bucketing**: each request's true token length picks the smallest
  covering bucket (default 32/64/128/...); per-bucket queues keep batches
  shape-homogeneous so the engine's compile cache stays tiny and hot;
- **flush policy**: a bucket flushes when it holds ``max_batch_size``
  requests (throughput bound) or when its oldest request has waited
  ``max_wait_ms`` (latency bound) — the classic size-or-timeout trigger;
- **backpressure**: ``submit`` raises :class:`QueueFullError` once
  ``max_queue`` requests are pending — reject-with-error beats unbounded
  memory growth and tells the caller to shed load.  The multi-replica
  router replaces this single cliff with the tiered
  :class:`AdmissionControl` ladder defined here (healthy -> bounded-wait
  backpressure -> shed-lowest-deadline-slack -> hard reject);
- **deadlines**: a request whose deadline passes while still queued is
  completed with :class:`DeadlineExceeded` and dropped from its batch, so
  one stuck client degrades gracefully instead of stalling the queue;
  expiry is checked when the flush timer is computed AND again at dequeue
  (a batch formed while the worker was busy must not carry corpses), and
  ``result()`` without an explicit timeout bounds its wait by the
  request's own remaining deadline budget;
- **packing** (``--serve_pack``): instead of padding each request to its
  bucket width, admitted requests bin-pack many-per-row into ONE fixed
  ``[rows, pack_width]`` packed batch (``data.packing.pack_id_lists`` —
  the training packer's segment channels, served online), so throughput
  scales with TOKENS, not requests.  The flush trigger becomes a token
  budget (``rows x width`` real tokens queued, or the age bound), the
  queue bound becomes a token bound, and batch formation is deadline-
  aware: requests pack in lowest-remaining-slack order, so the most
  urgent close the earliest rows and anything that does not fit waits.
  ``auto`` (default) packs where the flash kernel serves the packed
  mask in-kernel (on CUDA); ``off`` keeps per-bucket padding (also the
  permanent path for the router's hedged duplicates);
- **chunked prefill** (``long_widths``, ``--serve_long_widths``): a
  request longer than the pack width routes to a per-width LONG packed
  queue and executes as ONE segment of a ``[flush_tokens/w, w]`` packed
  batch — exact whole-request scoring (positions restart per segment,
  attention masked to the request), sized so every long flush costs
  ~the same token budget as a short flush.  Long traffic is consumed in
  those chunks, interleaved BEHIND short flushes (shorts always go
  first; an overdue long — 2x the age bound — takes one chunk slot),
  so one long request never head-of-line-blocks the packed short-query
  traffic; admission is already token-unit, so long requests simply
  cost more of the shared pool.

One worker thread owns the engine (its graphs and staging buffers are
per-engine, and a single dispatcher keeps the device busy without lock
churn); submitters block only on their own result.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from pdnlp_tpu_torch.obs.request import exemplar_ids, mint_request_id, record_hop
from pdnlp_tpu_torch.serve.engine import InferenceEngine
from pdnlp_tpu_torch.serve.metrics import ServeMetrics

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the bounded queue is at capacity."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline passed before its batch executed."""


class LoadShedError(RuntimeError):
    """A request was shed by tiered admission control (router overload tier:
    lowest deadline slack goes first) — the caller should back off; unlike
    :class:`QueueFullError` the queue is not hard-full, the request just
    could not have made its deadline."""


def usable_buckets(buckets: Sequence[int], max_seq_len: int) -> tuple:
    """The bucket list every serve path actually uses: capped at the
    model's padded length (encode truncates there, so a larger bucket could
    never fill) and never empty.  ONE definition — the batcher, the offline
    scorer and the CLI must clamp identically or a request could land in a
    bucket another path would reject."""
    usable = tuple(sorted(b for b in buckets if b <= max_seq_len))
    return usable or (int(max_seq_len),)


def pick_bucket(n_tokens: int, buckets: Sequence[int]) -> int:
    """Smallest bucket covering ``n_tokens`` (largest bucket if none does —
    entry paths truncate rows to the largest bucket, so topping out is the
    matching choice, not an error)."""
    for b in sorted(buckets):
        if n_tokens <= b:
            return b
    return max(buckets)


def resolve_serve_pack(mode: str, device) -> bool:
    """``serve_pack`` ``auto|on|off`` -> packed or padded.  ``auto`` packs
    exactly where attention routes to the flash kernel
    (``ops.attention.routed_impl``): on CUDA, where the block-diagonal mask
    costs nothing extra in-kernel.  On the CPU the plain path would build a
    ``[B, 1, S, S]`` bias per batch, so packing there is an opt-in."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"serve_pack must be 'auto', 'on' or 'off', "
                         f"got {mode!r}")
    if mode != "auto":
        return mode == "on"
    from pdnlp_tpu_torch.ops.attention import routed_impl

    return routed_impl("auto", device) == "pallas"


#: grace added to a deadline-derived ``result()`` timeout: a request can be
#: mid-batch when its deadline passes, and the completion (or the expiry
#: error) needs the batch's execution time to arrive
RESULT_GRACE_SEC = 5.0

#: completion is first-wins (a hedged/requeued request may be completed from
#: two replicas; an ejected replica's hung worker may wake up later) — one
#: tiny shared lock beats a per-request lock for objects this small
_COMPLETE_LOCK = threading.Lock()


class _Request:
    __slots__ = ("ids", "bucket", "submitted", "born", "deadline",
                 "retries", "hedged", "shadow_of", "rid", "_event",
                 "_logits", "_error", "completed_at")

    def __init__(self, ids: List[int], bucket: int,
                 deadline: Optional[float]):
        self.ids = ids
        self.bucket = bucket
        self.submitted = time.monotonic()
        # `submitted` may be re-stamped into a router's INJECTABLE clock
        # domain; `born`/`completed_at` stay time.monotonic so latency
        # deltas computed from them (the fleet's ShadowReport) are always
        # same-domain
        self.born = self.submitted
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.retries = 0          # router: requeues after replica failure
        self.hedged = False       # router: a duplicate dispatch exists
        # fleet: the primary request this is a SHADOW duplicate of (its
        # rid) — a shadow's terminal hop is stamped shadow=True so the
        # chain contract can prove no caller ever saw a candidate answer
        self.shadow_of: Optional[str] = None
        self.completed_at: Optional[float] = None  # fleet: parity/latency
        # the distributed-tracing identity: minted at admission, carried
        # through every hop (queue, pack, dispatch, requeue, completion)
        # so ONE id reconstructs the request's whole life (obs.request)
        self.rid = mint_request_id()
        self._event = threading.Event()
        self._logits: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    # --- the caller-facing future half ---
    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the logits row; raises the request's error if it was
        rejected by deadline or failed in the engine.

        ``timeout=None`` on a request WITH a deadline derives the wait from
        the request's own remaining deadline budget (plus a grace window
        for an in-flight batch) instead of blocking forever — a worker that
        died mid-batch must surface as a bounded ``TimeoutError``, not a
        hung caller.  A deadline-free request keeps the wait-forever
        default."""
        if timeout is None and self.deadline is not None:
            timeout = max(0.0, self.deadline - time.monotonic()) \
                + RESULT_GRACE_SEC
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self._error is not None:
            raise self._error
        return self._logits

    def done(self) -> bool:
        return self._event.is_set()

    def slack(self, now: float) -> float:
        """Remaining deadline budget in seconds (+inf when deadline-free) —
        the shed tier's ordering key."""
        return float("inf") if self.deadline is None else self.deadline - now

    # --- the worker-facing completion half ---
    def _complete(self, logits: Optional[np.ndarray],
                  error: Optional[BaseException] = None) -> bool:
        """First completion wins; returns whether THIS call won (so metrics
        count each request exactly once across hedges/requeues)."""
        with _COMPLETE_LOCK:
            if self._event.is_set():
                return False
            self._logits = logits
            self._error = error
            self.completed_at = time.monotonic()
            self._event.set()
            return True


def pack_order(requests: Sequence["_Request"], now: float,
               age_floor_s: Optional[float] = None) -> List["_Request"]:
    """Deadline-aware packing priority: lowest remaining slack first
    (deadline-free requests last, FIFO among equals) — the most urgent
    requests close the earliest rows of the packed batch, and whatever
    does not fit is exactly the work that could best afford to wait.

    ``age_floor_s`` (the flush policy's ``max_wait_ms``) is the
    anti-starvation valve: a request whose queue wait has reached the
    floor outranks ALL slack ordering (FIFO among the aged), so
    deadline-free or far-deadline work cannot be displaced batch after
    batch by a sustained stream of urgent arrivals — and the aged-flush
    trigger (keyed on the oldest request) always serves the request that
    fired it instead of re-firing forever."""
    def key(r: "_Request"):
        if age_floor_s is not None and now - r.submitted >= age_floor_s:
            return (0, r.submitted, 0.0)
        return (1, r.slack(now), r.submitted)

    return sorted(requests, key=key)


class _PackedBatch:
    """One flushed packed batch: the fixed-shape channel arrays
    (``data.packing.pack_id_lists``) plus each riding request's
    ``(row, slot)`` placement — the scatter map that routes the
    ``[rows, M, C]`` packed logits back to their callers."""

    __slots__ = ("requests", "arrays", "placements", "tokens")

    def __init__(self, requests: List["_Request"], arrays: Dict,
                 placements: List, tokens: int):
        self.requests = requests
        self.arrays = arrays
        self.placements = placements
        self.tokens = int(tokens)      # real tokens riding the batch

    @property
    def slots(self) -> int:
        """Token slots the forward pays for (rows x width)."""
        return int(self.arrays["input_ids"].size)

    @property
    def width(self) -> int:
        """The batch's packed row width (the pack width for short flushes,
        a ``long_widths`` entry for chunked-prefill flushes)."""
        return int(self.arrays["input_ids"].shape[1])

    @property
    def fill(self) -> float:
        return self.tokens / float(self.slots or 1)


def form_packed_batch(requests: Sequence["_Request"], now: float,
                      width: int, rows: int, max_segments: int,
                      pad_id: int, age_floor_s: Optional[float]
                      ) -> tuple:
    """ONE copy of packed batch formation — ``pack_order`` priority ->
    ``pack_id_lists`` -> (batch, leftovers) — shared by
    :class:`DynamicBatcher` and the replica router so ordering, placement
    and leftover semantics can never drift between the two serve paths.
    Returns ``(packed_batch, leftover_requests)``; leftovers are the
    requests that did not fit and must stay queued for the next batch."""
    from pdnlp_tpu_torch.data.packing import pack_id_lists

    ordered = pack_order(requests, now, age_floor_s=age_floor_s)
    arrays, placements = pack_id_lists(
        [r.ids for r in ordered], width, rows, max_segments, pad_id=pad_id)
    taken = [r for r, p in zip(ordered, placements) if p is not None]
    placed = [p for p in placements if p is not None]
    leftover = [r for r, p in zip(ordered, placements) if p is None]
    tokens = sum(len(r.ids) for r in taken)
    return _PackedBatch(taken, arrays, placed, tokens), leftover


class AdmissionControl:
    """Tiered overload policy — the one cliff (:class:`QueueFullError` at
    ``max_queue``) replaced with a ladder the router walks per submit:

    ====================  ==================================================
    tier (queue depth)    policy for the arriving request
    ====================  ==================================================
    healthy               ``< backpressure_at``: accept immediately
    backpressure          ``[backpressure_at, degrade_at)``: bounded wait
                          (at most ``backpressure_wait_ms``, never past the
                          request's own deadline slack) for depth to drop,
                          then accept — converts a burst into latency
                          instead of errors
    degrade               ``[degrade_at, shed_at)`` (only when
                          ``degrade_at`` is set — the multi-model fleet's
                          tier): the arrival should be RE-ROUTED to the
                          designated cheap model instead of queued here —
                          overload degrades answer QUALITY before it drops
                          requests.  The re-route itself lives in the
                          fleet front door (``serve.fleet.FleetRouter``);
                          a pool walking this ladder
                          with no cheap model behind it treats the band as
                          an early shed tier (the pre-fleet behavior,
                          reached ``shed_at - degrade_at`` requests sooner)
    shed                  ``[shed_at, max_queue)``: accept, but any request
                          (the arrival or a queued one — LOWEST deadline
                          slack first) whose remaining slack is under
                          ``shed_slack_ms`` is shed with
                          :class:`LoadShedError`: it could not have made
                          its deadline anyway, and dropping it early frees
                          capacity for requests that still can.  Deadline-
                          free requests are never shed
    reject                ``>= max_queue``: hard :class:`QueueFullError`
                          (the single batcher's cliff, here the LAST
                          resort)
    ====================  ==================================================

    Pure policy (no locks, injectable clock) so tier transitions are
    unit-testable without threads; the queue mechanics stay in the caller.
    The single-replica :class:`DynamicBatcher` keeps its legacy
    reject-on-full contract (equivalent to ``backpressure_at = shed_at =
    max_queue``); the multi-replica router wires the full ladder.
    """

    def __init__(self, max_queue: int, *,
                 backpressure_at: Optional[int] = None,
                 shed_at: Optional[int] = None,
                 degrade_at: Optional[int] = None,
                 backpressure_wait_ms: float = 50.0,
                 shed_slack_ms: float = 0.0,
                 clock=time.monotonic):
        self.max_queue = int(max_queue)
        self.backpressure_at = int(backpressure_at if backpressure_at
                                   is not None else self.max_queue // 2)
        self.shed_at = int(shed_at if shed_at is not None
                           else (self.max_queue * 3) // 4)
        # the degrade band is OPT-IN (None = the pre-fleet 4-tier ladder):
        # only a fleet with a cheap model behind it should route this tier
        self.degrade_at = None if degrade_at is None else int(degrade_at)
        if not (self.backpressure_at <= self.shed_at <= self.max_queue):
            raise ValueError(
                f"tier thresholds must be ordered: backpressure_at "
                f"{self.backpressure_at} <= shed_at {self.shed_at} <= "
                f"max_queue {self.max_queue}")
        if self.degrade_at is not None and not (
                self.backpressure_at <= self.degrade_at <= self.shed_at):
            raise ValueError(
                f"degrade_at {self.degrade_at} must sit between "
                f"backpressure_at {self.backpressure_at} and shed_at "
                f"{self.shed_at}")
        self.backpressure_wait_ms = float(backpressure_wait_ms)
        self.shed_slack_ms = float(shed_slack_ms)
        self.clock = clock

    def tier(self, pending: int) -> str:
        """``healthy`` | ``backpressure`` | ``degrade`` | ``shed`` |
        ``reject`` (``degrade`` only when ``degrade_at`` is set)."""
        if pending >= self.max_queue:
            return "reject"
        if pending >= self.shed_at:
            return "shed"
        if self.degrade_at is not None and pending >= self.degrade_at:
            return "degrade"
        if pending >= self.backpressure_at:
            return "backpressure"
        return "healthy"

    def backpressure_wait_sec(self, req: "_Request") -> float:
        """How long the submitter may be held in the backpressure tier:
        the bounded wait, further capped by the request's own deadline
        slack (waiting past its deadline would just shed it later)."""
        wait = self.backpressure_wait_ms / 1e3
        if req.deadline is not None:
            wait = min(wait, max(0.0, req.slack(self.clock())))
        return wait

    def shed_victims(self, queued: Sequence["_Request"],
                     arriving: Optional["_Request"] = None
                     ) -> List["_Request"]:
        """The requests the shed tier drops right now: lowest deadline
        slack first, only while their slack is under ``shed_slack_ms``.
        ``arriving`` participates like a queued request — the newcomer is
        not privileged over requests already admitted."""
        now = self.clock()
        floor = self.shed_slack_ms / 1e3
        cands = list(queued) + ([arriving] if arriving is not None else [])
        doomed = [r for r in cands if r.slack(now) < floor]
        return sorted(doomed, key=lambda r: r.slack(now))


class DynamicBatcher:
    def __init__(
        self,
        engine: InferenceEngine,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_batch_size: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        default_deadline_ms: Optional[float] = None,
        serve_pack: str = "auto",
        pack_max_segments: int = 16,
        long_widths: Sequence[int] = (),
    ):
        self.engine = engine
        self.buckets = usable_buckets(buckets, engine.args.max_seq_len)
        # flush threshold = the PADDED row count: executed batches pad rows
        # to the mesh's data-axis multiple anyway, so flushing at a smaller
        # size would cap occupancy below 1.0 forever (e.g. data axis 8 with
        # max_batch_size 4 -> every batch half filler even under load)
        self.max_batch_size = engine.pad_rows(int(max_batch_size))
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.default_deadline_ms = default_deadline_ms
        # packed online batching: requests bin-pack many-per-row into one
        # fixed [rows, pack_width] batch; every bound moves to TOKEN units
        # — the flush trigger is "a full batch worth of real tokens" and
        # the queue bound is max_queue rows' worth of token slots, so a
        # storm of short requests is admitted by the work it actually
        # brings, not by how many envelopes it arrives in
        self.packed = resolve_serve_pack(serve_pack, engine.device)
        self.pack_width = self.buckets[-1]
        self.pack_rows = self.max_batch_size
        self.pack_segments = int(pack_max_segments)
        self.flush_tokens = self.pack_rows * self.pack_width
        self.max_queue_tokens = self.max_queue * self.pack_width
        # chunked prefill (``long_widths``): a request longer than the pack
        # width routes to a per-width LONG packed queue and executes as one
        # segment of a [rows_w, w] packed batch — exact whole-request
        # scoring at width w (positions restart per segment, attention
        # masked to the request) — where rows_w sizes every long flush to
        # ~the SAME token budget as a short flush (flush_tokens / w rows).
        # Long traffic is therefore consumed in short-flush-sized chunks
        # that interleave with the packed short-query flushes instead of
        # head-of-line-blocking them; admission already charges tokens, so
        # a long request simply costs more of the shared token pool.
        self.long_widths = tuple(sorted({int(w) for w in long_widths}))
        self.long_rows: Dict[int, int] = {}
        self.long_segments: Dict[int, int] = {}
        if self.long_widths:
            from pdnlp_tpu_torch.data.packing import segment_cap

            if not self.packed:
                raise ValueError(
                    "chunked prefill (long_widths) rides the packed path — "
                    "it needs --serve_pack to resolve on for the pack "
                    "width, got the padded per-bucket path")
            for w in self.long_widths:
                if w <= self.pack_width or w % 128:
                    raise ValueError(
                        f"long width {w} must exceed the {self.pack_width}-"
                        "token pack width and tile the 128-wide kernel "
                        "blocks")
                if w > engine.cfg.max_position:
                    raise ValueError(
                        f"long width {w} exceeds {engine.args.model}'s "
                        f"{engine.cfg.max_position}-position table — a "
                        "long request is ONE segment, so its positions "
                        "span the full width and would gather garbage "
                        "embeddings past the table.  Use a long-position "
                        "model (--model bert-base-long, 2048 positions) "
                        "or drop the width")
                self.long_rows[w] = engine.pad_rows(
                    max(1, self.flush_tokens // w))
                self.long_segments[w] = segment_cap(w, self.pack_segments,
                                                    self.pack_width)
        self.metrics: ServeMetrics = engine.metrics
        self._queues: Dict[int, List[_Request]] = {b: [] for b in self.buckets}
        self._pack_queue: List[_Request] = []
        self._long_queues: Dict[int, List[_Request]] = {
            w: [] for w in self.long_widths}
        # O(1) per-queue token tallies for the flush decision (summing the
        # queue request-by-request under the lock would charge every worker
        # wake O(queued) exactly at saturation); keys: "pack" + each long
        # width.  _pending_tokens stays the ADMISSION total across them.
        self._queue_tokens: Dict = {"pack": 0,
                                    **{w: 0 for w in self.long_widths}}
        self._pending = 0
        self._pending_tokens = 0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._worker: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "DynamicBatcher":
        if self._worker is None:
            self._stop = False  # a stopped batcher restarts cleanly
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="pdnlp-torch-batcher")
            self._worker.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Shut the worker down; ``drain=True`` serves what is queued first."""
        if self._worker is None:
            return
        if drain:
            with self._lock:
                while self._pending and not self._stop:
                    self._wake.wait(timeout=0.05)
        with self._lock:
            self._stop = True
            self._wake.notify_all()
        self._worker.join(timeout=10)
        self._worker = None
        with self._lock:  # fail anything still queued (stop(drain=False))
            leftovers = [r for q in self._all_queues() for r in q]
            for q in self._queues.values():
                q.clear()
            self._pack_queue = []
            self._long_queues = {w: [] for w in self.long_widths}
            self._queue_tokens = {"pack": 0,
                                  **{w: 0 for w in self.long_widths}}
            self._pending = 0
            self._pending_tokens = 0
            self.metrics.queue_depth.set(0)
            self.metrics.queue_tokens.set(0)
        for r in leftovers:
            if r._complete(None, RuntimeError("batcher stopped")):
                record_hop(self.engine.tracer, r.rid, "failed",
                           error="batcher stopped")

    def __enter__(self) -> "DynamicBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- submit
    def _all_queues(self) -> List[List[_Request]]:
        """Every live queue (bucket + packed + long), for sweeps."""
        return (list(self._queues.values()) + [self._pack_queue]
                + [self._long_queues[w] for w in self.long_widths])

    @property
    def max_request_tokens(self) -> int:
        """The truncation bound a submitted request gets: the largest
        long width under chunked prefill, else the largest bucket."""
        return (self.long_widths[-1] if (self.long_widths and self.packed)
                else self.buckets[-1])

    def submit(self, text: str,
               deadline_ms: Optional[float] = None) -> _Request:
        """Enqueue one text; returns a future-like whose ``result()`` is the
        logits row.  Raises :class:`QueueFullError` at capacity (the
        backpressure contract: callers retry or shed).

        Encoding truncates to the LARGEST width this batcher can serve —
        the top long width under chunked prefill, else the largest bucket
        (a row no width covers would otherwise fail its whole batch at
        execute time)."""
        ids = self.engine.tokenizer.encode_ids(text, self.max_request_tokens)
        return self.submit_ids(ids, deadline_ms=deadline_ms)

    def submit_ids(self, ids: List[int],
                   deadline_ms: Optional[float] = None) -> _Request:
        if not ids:
            # an empty row is meaningless on the padded path and would
            # corrupt a packed batch (phantom segment aliasing a
            # neighbor's [CLS] gather) — reject at the door, loudly
            raise ValueError("empty request: submit at least one token id")
        if len(ids) > self.max_request_tokens:
            # pre-encoded rows get a plain tail truncation (only submit()'s
            # text path knows the [CLS]/[SEP] framing to preserve) — a row
            # that cannot fit any served width must never reach a batch,
            # where its shape error would poison every co-batched request
            ids = list(ids)[: self.max_request_tokens]
        deadline_ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = _Request(ids, pick_bucket(len(ids), self.buckets), deadline)
        tr = self.engine.tracer
        long_w = None  # set by the packed branch when the request is long
        with self._lock:
            if self._stop or self._worker is None:
                raise RuntimeError("batcher is not running (call start())")
            if self.packed:
                # token-unit admission: capacity is max_queue rows' worth
                # of token SLOTS — a short-request storm is bounded by the
                # work it brings, not by its request count
                if self._pending_tokens + len(ids) > self.max_queue_tokens:
                    self.metrics.rejected_total.inc()
                    record_hop(tr, req.rid, "rejected")
                    raise QueueFullError(
                        f"queue full ({self._pending_tokens}"
                        f"/{self.max_queue_tokens} tokens)")
                if self.long_widths and len(ids) > self.pack_width:
                    # chunked prefill: smallest long width covering the
                    # request; same shared token pool as the short queue
                    long_w = next(w for w in self.long_widths
                                  if len(ids) <= w)
                    req.bucket = long_w
                    self._long_queues[long_w].append(req)
                else:
                    long_w = None
                    self._pack_queue.append(req)
                self._pending_tokens += len(ids)
                self._queue_tokens[long_w or "pack"] += len(ids)
                self.metrics.queue_tokens.set(self._pending_tokens)
            else:
                if self._pending >= self.max_queue:
                    self.metrics.rejected_total.inc()
                    record_hop(tr, req.rid, "rejected")
                    raise QueueFullError(
                        f"queue full ({self._pending}/{self.max_queue})")
                self._queues[req.bucket].append(req)
            self._pending += 1
            self.metrics.requests_total.inc()
            self.metrics.queue_depth.set(self._pending)
            # ONE hop for admission + initial queue placement (recording
            # two would double the per-submit tracing cost for no extra
            # information — the attrs carry both); tokens + deadline ride
            # along for serve.replay's arrival reconstruction
            record_hop(tr, req.rid, "admit", tier="healthy",
                       tokens=len(ids),
                       **({} if deadline_ms is None
                          else {"deadline_ms": float(deadline_ms)}),
                       **({"packed": True} if self.packed
                          else {"bucket": req.bucket}),
                       **({"long_width": long_w}
                          if self.packed and long_w else {}))
            self._wake.notify()
        return req

    # ------------------------------------------------------------- worker
    def _take_flushable(self):
        """Under the lock: pop a flushable batch or None — a full (or aged)
        bucket on the padded path; on the packed path the priority ladder
        over the short token queue and the chunked-prefill long queues:

        1. OVERDUE long flush (oldest long request waited >= 2x
           ``max_wait_ms``) — the anti-starvation valve: it outranks even
           a full short flush, so sustained short saturation cannot park
           a long request forever, and it costs the short traffic one
           chunk (a long flush is sized to ~one short flush's tokens);
        2. short packed flush: a full token budget queued (throughput) or
           the oldest short aged out (latency) — shorts otherwise always
           go first, which is what holds the short-query p99 under mixed
           long/short storms;
        3. full long chunk (ascending width);
        4. aged long flush (>= ``max_wait_ms``).
        """
        now = time.monotonic()
        # expired-deadline requests leave their queue before batch selection
        # (their slot should not hold a flush back or ride a batch)
        expired: List[_Request] = []
        for key, q in ([(None, b) for b in self._queues.values()]
                       + [("pack", self._pack_queue)]
                       + list(self._long_queues.items())):
            keep = []
            dropped = 0
            for r in q:
                if r.deadline is not None and now >= r.deadline:
                    expired.append(r)
                    dropped += len(r.ids)
                else:
                    keep.append(r)
            q[:] = keep
            if key is not None and dropped:
                self._queue_tokens[key] -= dropped
        if expired:
            self._pending -= len(expired)
            if self.packed:  # tokens are only accounted on the packed path
                self._pending_tokens -= sum(len(r.ids) for r in expired)
                self.metrics.queue_tokens.set(self._pending_tokens)
            self.metrics.deadline_expired_total.inc(len(expired))
            self.metrics.queue_depth.set(self._pending)
            for r in expired:
                if r._complete(None, DeadlineExceeded(
                        "deadline passed while queued")):
                    record_hop(self.engine.tracer, r.rid, "deadline")
        if self.packed:
            oldest_long = [(min(r.submitted for r in q), w)
                           for w, q in self._long_queues.items() if q]
            if oldest_long:  # 1. overdue long outranks full shorts
                oldest, w = min(oldest_long)
                if (now - oldest) * 1e3 >= 2 * self.max_wait_ms:
                    return self._long_pop(w, now)
            # 2. token-budget flush: a full batch worth of REAL tokens
            # queued (throughput), else the oldest request aged (latency)
            q = self._pack_queue
            if q:
                if self._queue_tokens["pack"] >= self.flush_tokens \
                        or (now - min(r.submitted for r in q)) * 1e3 \
                        >= self.max_wait_ms:
                    return self._pack_pop(now)
            for w in self.long_widths:  # 3. full long chunk
                if self._long_queues[w] and self._queue_tokens[w] \
                        >= self.long_rows[w] * w:
                    return self._long_pop(w, now)
            if oldest_long:  # 4. aged long
                oldest, w = min(oldest_long)
                if (now - oldest) * 1e3 >= self.max_wait_ms:
                    return self._long_pop(w, now)
            return None
        # full bucket first (throughput); else the most-overdue aged bucket
        for b, q in self._queues.items():
            if len(q) >= self.max_batch_size:
                return self._pop(b, self.max_batch_size)
        aged = [(q[0].submitted, b) for b, q in self._queues.items() if q]
        if aged:
            oldest, b = min(aged)
            if (now - oldest) * 1e3 >= self.max_wait_ms:
                return self._pop(b, self.max_batch_size)
        return None

    def _pack_pop(self, now: float) -> _PackedBatch:
        """Under the lock: bin-pack the queue (``form_packed_batch``) into
        one fixed-shape batch; whatever does not fit stays queued.
        Holding the lock here is bounded work — the single-replica queue
        is capped at ``max_queue_tokens`` and only submitters contend (the
        router's multi-worker path packs OUTSIDE its pool-global lock)."""
        pb, self._pack_queue = self._form_pop(
            "pack", self._pack_queue, now, self.pack_width, self.pack_rows,
            self.pack_segments)
        return pb

    def _long_pop(self, width: int, now: float) -> _PackedBatch:
        """One chunked-prefill flush: the width's queue bin-packs into a
        ``[long_rows[w], w]`` batch — the same token budget as a short
        flush, so it interleaves instead of blocking."""
        pb, self._long_queues[width] = self._form_pop(
            width, self._long_queues[width], now, width,
            self.long_rows[width], self.long_segments[width])
        return pb

    def _form_pop(self, key, queue: List[_Request], now: float, width: int,
                  rows: int, segments: int):
        """Shared pop core: form, account, return (batch, leftovers)."""
        pb, leftover = form_packed_batch(
            queue, now, width, rows, segments,
            self.engine.tokenizer.pad_id, self.max_wait_ms / 1e3)
        self._pending -= len(pb.requests)
        self._pending_tokens -= pb.tokens
        self._queue_tokens[key] -= pb.tokens
        self.metrics.queue_depth.set(self._pending)
        self.metrics.queue_tokens.set(self._pending_tokens)
        return pb, leftover

    def _pop(self, bucket: int, n: int) -> List[_Request]:
        q = self._queues[bucket]
        batch, q[:] = q[:n], q[n:]
        self._pending -= len(batch)
        self.metrics.queue_depth.set(self._pending)
        return batch

    def _next_wakeup(self) -> Optional[float]:
        """Seconds until the earliest timeout/deadline, or None to sleep."""
        now = time.monotonic()
        ticks = []
        for q in self._all_queues():
            for r in q:
                ticks.append(r.submitted + self.max_wait_ms / 1e3)
                if r.deadline is not None:
                    ticks.append(r.deadline)
        if not ticks:
            return None
        return max(0.0, min(ticks) - now)

    def _run(self) -> None:
        while True:
            with self._lock:
                batch = self._take_flushable()
                if batch is None:
                    if self._stop:
                        return
                    self._wake.wait(timeout=self._next_wakeup())
                    continue
            self._execute(batch)
            with self._lock:
                self._wake.notify_all()  # unblock stop(drain=True) waiters

    #: the single-replica tuning surface (the router has the full set);
    #: ONE setter so controller-side writes stay auditable
    KNOBS = ("max_wait_ms", "max_queue")

    def apply_knob(self, name: str, value) -> None:
        """Thread-safe setter for the batcher's tunable knobs, effective
        at the next flush decision."""
        with self._lock:
            if name == "max_wait_ms":
                self.max_wait_ms = float(value)
            elif name == "max_queue":
                self.max_queue = int(value)
                self.max_queue_tokens = self.max_queue * self.pack_width
            else:
                raise KeyError(f"unknown knob {name!r} (tunable: "
                               f"{self.KNOBS})")
            self._wake.notify_all()

    def knob_values(self) -> Dict[str, float]:
        return {"max_wait_ms": self.max_wait_ms,
                "max_queue": self.max_queue}

    def warmup(self) -> None:
        """Pre-trace every shape live traffic can reach: the fixed packed
        shape plus one fixed ``(w, long_rows[w], "packed")`` shape per
        chunked-prefill width on the packed path, one batch per bucket on
        the padded path — after this, steady-state serving never
        compiles."""
        if self.packed:
            self.engine.warmup_packed(self.pack_width, self.pack_rows,
                                      self.pack_segments)
            for w in self.long_widths:
                self.engine.warmup_packed(w, self.long_rows[w],
                                          self.long_segments[w])
        else:
            self.engine.warmup(self.buckets, self.max_batch_size)

    def _execute(self, batch) -> None:
        if isinstance(batch, _PackedBatch):
            return self._execute_packed(batch)
        bucket = batch[0].bucket
        t0 = time.monotonic()
        # dequeue-time expiry: the flush decision and this execution are
        # separated by however long the worker spent on the PREVIOUS batch
        # — a request whose deadline passed in that window must not ride
        # the batch (its caller already gave up) nor hold a row
        tr = self.engine.tracer
        live = []
        for r in batch:
            if r.deadline is not None and t0 >= r.deadline:
                self.metrics.deadline_expired_total.inc()
                if r._complete(None, DeadlineExceeded(
                        "deadline passed while queued")):
                    record_hop(tr, r.rid, "deadline")
            else:
                live.append(r)
        batch = live
        if not batch:
            return
        for r in batch:
            self.metrics.queue_wait_ms.observe((t0 - r.submitted) * 1e3)
        # one queue_wait span per flushed batch, duration = its OLDEST
        # request's wait (the flush-policy-visible latency); recorded in
        # the tracer's clock domain with explicit timestamps since the
        # wait began before this call
        if tr.enabled:
            now = tr.now()
            oldest = max(t0 - r.submitted for r in batch)
            tr.record("queue_wait", now - oldest, now, bucket=bucket,
                      rows=len(batch), request_ids=exemplar_ids(batch))
            for i, r in enumerate(batch):
                record_hop(tr, r.rid, "dispatch", bucket=bucket, row=i)
        try:
            rows = self.max_batch_size  # already padded to the mesh multiple
            logits = self.engine.infer_ids(
                [r.ids for r in batch], bucket, rows=rows,
                request_ids=[r.rid for r in batch])
            self.metrics.batches_total.inc()
            self.metrics.batch_occupancy.observe(len(batch) / rows)
            done = time.monotonic()
            for i, r in enumerate(batch):
                self.metrics.request_latency_ms.observe(
                    (done - r.submitted) * 1e3)
                if r._complete(logits[i]):
                    record_hop(tr, r.rid, "complete")
        except BaseException as e:  # noqa: BLE001 — a failed batch must
            for r in batch:        # never leave callers blocked forever
                if r._complete(None, e):
                    record_hop(tr, r.rid, "failed",
                               error=type(e).__name__)

    def _execute_packed(self, pb: _PackedBatch) -> None:
        t0 = time.monotonic()
        tr = self.engine.tracer
        # the batch is already packed — a corpse's tokens ride anyway —
        # but its caller gave up, so complete it with the expiry error and
        # skip its scatter rather than hand back a result nobody awaits
        live: List[tuple] = []
        for r, place in zip(pb.requests, pb.placements):
            if r.deadline is not None and t0 >= r.deadline:
                self.metrics.deadline_expired_total.inc()
                if r._complete(None, DeadlineExceeded(
                        "deadline passed while queued")):
                    record_hop(tr, r.rid, "deadline")
            else:
                live.append((r, place))
        if not live:
            return
        for r, _ in live:
            self.metrics.queue_wait_ms.observe((t0 - r.submitted) * 1e3)
        if tr.enabled:
            now = tr.now()
            oldest = max(t0 - r.submitted for r, _ in live)
            tr.record("queue_wait", now - oldest, now,
                      bucket=pb.width, rows=len(live), packed=True,
                      request_ids=exemplar_ids([r for r, _ in live]))
            for r, (row, slot) in live:
                record_hop(tr, r.rid, "pack", row=row, slot=slot)
                record_hop(tr, r.rid, "dispatch", row=row, slot=slot,
                           packed=True)
        try:
            logits = self.engine.infer_packed(
                pb.arrays, segments=len(live),
                request_ids=[r.rid for r, _ in live])
            self.metrics.batches_total.inc()
            # occupancy in TOKEN slots: a packed batch always spends every
            # row, so rows would read 1.0 forever — real tokens over the
            # rows x width slots is the number that stays honest
            self.metrics.batch_occupancy.observe(pb.fill)
            done = time.monotonic()
            for r, (row, slot) in live:
                self.metrics.request_latency_ms.observe(
                    (done - r.submitted) * 1e3)
                if r._complete(logits[row, slot]):
                    record_hop(tr, r.rid, "complete")
        except BaseException as e:  # noqa: BLE001 — a failed batch must
            for r, _ in live:      # never leave callers blocked forever
                if r._complete(None, e):
                    record_hop(tr, r.rid, "failed",
                               error=type(e).__name__)
