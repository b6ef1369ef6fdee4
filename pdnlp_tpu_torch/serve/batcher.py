"""Dynamic micro-batching over a bounded queue
(``pdnlp_tpu/serve/batcher.py`` with the port's engine, single replica).

Requests arrive one at a time; the device wants full fixed-shape batches:

- **bucketing**: each request's true token length picks the smallest
  covering bucket; per-bucket queues keep batches shape-homogeneous;
- **flush policy**: a bucket flushes at ``max_batch_size`` requests or when
  its oldest request has waited ``max_wait_ms``;
- **backpressure**: ``submit`` raises :class:`QueueFullError` once
  ``max_queue`` requests (packed: ``max_queue`` rows of tokens) are pending;
- **deadlines**: a request whose deadline passes while queued completes
  with :class:`DeadlineExceeded` and leaves its batch; expiry is checked
  when batches are chosen and again at dequeue;
- **packing** (``serve_pack``): requests bin-pack many-per-row into one
  fixed ``[rows, pack_width]`` batch (``data.packing.pack_id_lists``), the
  flush trigger becomes a token budget, and requests pack in
  lowest-remaining-slack order.  ``auto`` packs where the flash kernel
  serves the packed mask in-kernel: on CUDA.

One worker thread owns the engine; submitters block only on their own
result.  The router, the tiered admission ladder, request tracing and
chunked prefill of requests longer than the pack width are not ported yet
(ROADMAP A9).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from pdnlp_tpu_torch.serve.engine import InferenceEngine
from pdnlp_tpu_torch.serve.metrics import ServeMetrics

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the bounded queue is at capacity."""


class DeadlineExceeded(RuntimeError):
    """A request's deadline passed before its batch executed."""


def usable_buckets(buckets: Sequence[int], max_seq_len: int) -> tuple:
    """The bucket list every serve path uses: capped at the model's padded
    length and never empty."""
    usable = tuple(sorted(b for b in buckets if b <= max_seq_len))
    return usable or (int(max_seq_len),)


def pick_bucket(n_tokens: int, buckets: Sequence[int]) -> int:
    """Smallest bucket covering ``n_tokens`` (the largest if none does —
    entry paths truncate to it)."""
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


class _Request:
    __slots__ = ("ids", "bucket", "submitted", "deadline", "_event",
                 "_logits", "_error")

    def __init__(self, ids: List[int], bucket: int,
                 deadline: Optional[float]):
        self.ids = ids
        self.bucket = bucket
        self.submitted = time.monotonic()
        self.deadline = deadline  # absolute monotonic seconds, or None
        self._event = threading.Event()
        self._logits: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the logits row; raises the request's error if it was
        rejected by deadline or failed in the engine."""
        if not self._event.wait(timeout):
            raise TimeoutError("request still pending")
        if self._error is not None:
            raise self._error
        return self._logits

    def slack(self, now: float) -> float:
        """Remaining deadline budget in seconds (+inf when deadline-free)."""
        return float("inf") if self.deadline is None else self.deadline - now

    def _complete(self, logits: Optional[np.ndarray],
                  error: Optional[BaseException] = None) -> None:
        self._logits = logits
        self._error = error
        self._event.set()


def pack_order(requests: Sequence[_Request], now: float,
               age_floor_s: Optional[float] = None) -> List[_Request]:
    """Packing priority: lowest remaining slack first (deadline-free last,
    FIFO among equals); a request that has waited ``age_floor_s`` outranks
    all slack ordering, so sustained urgent traffic cannot starve it."""
    def key(r: _Request):
        if age_floor_s is not None and now - r.submitted >= age_floor_s:
            return (0, r.submitted, 0.0)
        return (1, r.slack(now), r.submitted)

    return sorted(requests, key=key)


class _PackedBatch:
    """One flushed packed batch: the channel arrays plus each riding
    request's ``(row, slot)`` placement."""

    __slots__ = ("requests", "arrays", "placements", "tokens")

    def __init__(self, requests: List[_Request], arrays: Dict,
                 placements: List, tokens: int):
        self.requests = requests
        self.arrays = arrays
        self.placements = placements
        self.tokens = int(tokens)

    @property
    def fill(self) -> float:
        return self.tokens / float(self.arrays["input_ids"].size or 1)


def form_packed_batch(requests: Sequence[_Request], now: float,
                      width: int, rows: int, max_segments: int,
                      pad_id: int, age_floor_s: Optional[float]) -> tuple:
    """``pack_order`` -> ``pack_id_lists`` -> ``(batch, leftovers)``;
    leftovers did not fit and stay queued."""
    from pdnlp_tpu_torch.data.packing import pack_id_lists

    ordered = pack_order(requests, now, age_floor_s=age_floor_s)
    arrays, placements = pack_id_lists(
        [r.ids for r in ordered], width, rows, max_segments, pad_id=pad_id)
    taken = [r for r, p in zip(ordered, placements) if p is not None]
    placed = [p for p in placements if p is not None]
    leftover = [r for r, p in zip(ordered, placements) if p is None]
    tokens = sum(len(r.ids) for r in taken)
    return _PackedBatch(taken, arrays, placed, tokens), leftover


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
    ):
        self.engine = engine
        self.buckets = usable_buckets(buckets, engine.args.max_seq_len)
        self.max_batch_size = engine.pad_rows(int(max_batch_size))
        self.max_wait_ms = float(max_wait_ms)
        self.max_queue = int(max_queue)
        self.default_deadline_ms = default_deadline_ms
        self.packed = resolve_serve_pack(serve_pack, engine.device)
        self.pack_width = self.buckets[-1]
        self.pack_rows = self.max_batch_size
        self.pack_segments = int(pack_max_segments)
        self.flush_tokens = self.pack_rows * self.pack_width
        self.max_queue_tokens = self.max_queue * self.pack_width
        self.metrics: ServeMetrics = engine.metrics
        self._queues: Dict[int, List[_Request]] = {b: [] for b in self.buckets}
        self._pack_queue: List[_Request] = []
        self._pending = 0
        self._pending_tokens = 0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._worker: Optional[threading.Thread] = None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "DynamicBatcher":
        if self._worker is None:
            self._stop = False
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
            self._pending = 0
            self._pending_tokens = 0
            self.metrics.queue_depth.set(0)
            self.metrics.queue_tokens.set(0)
        for r in leftovers:
            r._complete(None, RuntimeError("batcher stopped"))

    def __enter__(self) -> "DynamicBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- submit
    def _all_queues(self) -> List[List[_Request]]:
        return list(self._queues.values()) + [self._pack_queue]

    def submit(self, text: str,
               deadline_ms: Optional[float] = None) -> _Request:
        """Enqueue one text; returns a future whose ``result()`` is the
        logits row.  Raises :class:`QueueFullError` at capacity."""
        ids = self.engine.tokenizer.encode_ids(text, self.buckets[-1])
        return self.submit_ids(ids, deadline_ms=deadline_ms)

    def submit_ids(self, ids: List[int],
                   deadline_ms: Optional[float] = None) -> _Request:
        if not ids:
            raise ValueError("empty request: submit at least one token id")
        if len(ids) > self.buckets[-1]:
            ids = list(ids)[: self.buckets[-1]]
        deadline_ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = _Request(ids, pick_bucket(len(ids), self.buckets), deadline)
        with self._lock:
            if self._stop or self._worker is None:
                raise RuntimeError("batcher is not running (call start())")
            if self.packed:
                # token-unit admission: max_queue rows' worth of token slots
                if self._pending_tokens + len(ids) > self.max_queue_tokens:
                    self.metrics.rejected_total.inc()
                    raise QueueFullError(
                        f"queue full ({self._pending_tokens}"
                        f"/{self.max_queue_tokens} tokens)")
                self._pack_queue.append(req)
                self._pending_tokens += len(ids)
                self.metrics.queue_tokens.set(self._pending_tokens)
            else:
                if self._pending >= self.max_queue:
                    self.metrics.rejected_total.inc()
                    raise QueueFullError(
                        f"queue full ({self._pending}/{self.max_queue})")
                self._queues[req.bucket].append(req)
            self._pending += 1
            self.metrics.requests_total.inc()
            self.metrics.queue_depth.set(self._pending)
            self._wake.notify()
        return req

    # ------------------------------------------------------------- worker
    def _take_flushable(self):
        """Under the lock: pop a flushable batch or None.  Padded path: a
        full bucket, else the most overdue aged one.  Packed path: the
        pack queue once its real tokens fill the flush budget or its
        oldest request has waited ``max_wait_ms``."""
        now = time.monotonic()
        expired: List[_Request] = []
        for q in self._all_queues():
            keep = []
            for r in q:
                gone = r.deadline is not None and now >= r.deadline
                (expired if gone else keep).append(r)
            q[:] = keep
        if expired:
            self._pending -= len(expired)
            if self.packed:
                self._pending_tokens -= sum(len(r.ids) for r in expired)
                self.metrics.queue_tokens.set(self._pending_tokens)
            self.metrics.deadline_expired_total.inc(len(expired))
            self.metrics.queue_depth.set(self._pending)
            for r in expired:
                r._complete(None, DeadlineExceeded(
                    "deadline passed while queued"))
        if self.packed:
            q = self._pack_queue
            if q and (self._pending_tokens >= self.flush_tokens
                      or (now - min(r.submitted for r in q)) * 1e3
                      >= self.max_wait_ms):
                return self._form_pop(now)
            return None
        for b, q in self._queues.items():
            if len(q) >= self.max_batch_size:
                return self._pop(b, self.max_batch_size)
        aged = [(q[0].submitted, b) for b, q in self._queues.items() if q]
        if aged:
            oldest, b = min(aged)
            if (now - oldest) * 1e3 >= self.max_wait_ms:
                return self._pop(b, self.max_batch_size)
        return None

    def _form_pop(self, now: float) -> _PackedBatch:
        """Bin-pack the pack queue into one batch; leftovers stay queued."""
        pb, self._pack_queue = form_packed_batch(
            self._pack_queue, now, self.pack_width, self.pack_rows,
            self.pack_segments, self.engine.tokenizer.pad_id,
            self.max_wait_ms / 1e3)
        self._pending -= len(pb.requests)
        self._pending_tokens -= pb.tokens
        self.metrics.queue_depth.set(self._pending)
        self.metrics.queue_tokens.set(self._pending_tokens)
        return pb

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

    def warmup(self) -> None:
        """One batch at every shape live traffic can reach: the packed
        shape, or one per bucket when padded."""
        if self.packed:
            self.engine.warmup_packed(self.pack_width, self.pack_rows,
                                      self.pack_segments)
        else:
            self.engine.warmup(self.buckets, self.max_batch_size)

    def _live(self, requests: Sequence[_Request], t0: float) -> List[bool]:
        """Dequeue-time expiry: a request whose deadline passed while the
        worker ran the previous batch completes with the expiry error."""
        live = []
        for r in requests:
            ok = r.deadline is None or t0 < r.deadline
            if not ok:
                self.metrics.deadline_expired_total.inc()
                r._complete(None, DeadlineExceeded(
                    "deadline passed while queued"))
            else:
                self.metrics.queue_wait_ms.observe((t0 - r.submitted) * 1e3)
            live.append(ok)
        return live

    def _execute(self, batch) -> None:
        t0 = time.monotonic()
        packed = isinstance(batch, _PackedBatch)
        requests = batch.requests if packed else batch
        live = self._live(requests, t0)
        if not any(live):
            return
        try:
            if packed:
                # a corpse's tokens ride the already-packed batch; its
                # result is simply not scattered
                logits = self.engine.infer_packed(batch.arrays)
                outs = [logits[row, slot] for row, slot in batch.placements]
                occupancy = batch.fill
            else:
                requests = [r for r, ok in zip(requests, live) if ok]
                live = [True] * len(requests)
                outs = self.engine.infer_ids(
                    [r.ids for r in requests], requests[0].bucket,
                    rows=self.max_batch_size)
                occupancy = len(requests) / self.max_batch_size
            self.metrics.batches_total.inc()
            self.metrics.batch_occupancy.observe(occupancy)
            done = time.monotonic()
            for r, ok, out in zip(requests, live, outs):
                if ok:
                    self.metrics.request_latency_ms.observe(
                        (done - r.submitted) * 1e3)
                    r._complete(out)
        except Exception as e:  # noqa: BLE001 — a failed batch must never
            for r, ok in zip(requests, live):   # leave callers blocked
                if ok:
                    r._complete(None, e)
