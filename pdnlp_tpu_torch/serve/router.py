"""Multi-replica serving router — the twin of ``pdnlp_tpu/serve/router.py``
with the port's engine swapped in and its logic copied: the tier that
survives overload and replica death.

- **per-replica queues + least-loaded dispatch** — each replica keeps its
  own per-bucket queues and ONE worker thread that owns its engine (the
  single-dispatcher contract of ``serve.batcher.DynamicBatcher``, times
  N); an arriving request lands on the least-loaded replica that can take
  it;
- **tiered admission** (``serve.batcher.AdmissionControl``) — healthy ->
  bounded-wait backpressure -> shed-lowest-deadline-slack -> hard reject,
  replacing the single :class:`QueueFullError` cliff;
- **health via the watchdog machinery** — every replica worker writes a
  beat-payload ``parallel.watchdog.Heartbeat`` (step = batches served) and
  a monitor thread reads them through a ``parallel.watchdog.GangMonitor``
  over per-replica process adapters, so *crashed* (worker died) and
  *stalled* (worker wedged, beats stopped) replicas are classified by one
  verdict logic;
- **ejection without loss** — an ejected replica's queued requests are
  requeued onto survivors within their remaining deadline budget; its
  in-flight batch is re-dispatched with a per-request retry budget
  (``max_retries``); completion is first-wins, so a wedged worker waking up
  later can never double-complete;
- **warmup-gated reintegration** — a relaunched replica serves nothing
  until its worker has re-run the warmup (capturing every batch shape's
  CUDA graph on the card), so reintegration can never introduce
  post-warmup recaptures (each replica's retrace counter is baselined at
  the end of ITS warmup);
- **rolling checkpoint hot-swap** — :meth:`swap_checkpoint` drains and
  swaps one replica at a time (in place: the graphs stay valid); a
  corrupt artifact (``train.checkpoint.CorruptCheckpointError``, or a
  template mismatch) rolls back that replica (a failed load leaves the
  engine's weights untouched) and aborts the rollout instead of poisoning
  the rest of the pool;
- **optional tail hedging** — a request stuck in a queue past ``hedge_ms``
  with deadline budget left is duplicated onto a less-loaded replica;
  first completion wins;
- **packed online batching** (``serve_pack``, default ``auto``) — each
  replica bin-packs its queue many-requests-per-row into ONE fixed
  ``[rows, pack_width]`` packed batch, flush policy and admission move to
  TOKEN units, and ejection re-packs the victim's queued + in-flight
  requests on the survivors' token queues.  Hedged duplicates always stay
  on the padded per-bucket path (both paths are warmed, so neither can
  recapture post-warmup);
- **chunked prefill** (``long_widths``) — the batcher's long-request
  path, per replica: a request longer than the pack width waits in the
  replica's queue for its long width and runs as ONE segment of a
  ``[flush_tokens // w, w]`` packed batch, behind the short flushes (the
  batcher's ladder).  The JAX router has no long widths (``serve_tpu.py``
  refuses ``--serve_long_widths`` with ``--replicas``); here each long
  width is one more captured shape per replica;
- **a mutable tuning surface** (:meth:`apply_knob` + warm-standby scaling)
  — ``hedge_ms``, ``max_wait_ms`` and the admission thresholds are
  thread-safe knobs with ONE setter, and a healthy replica can be drained
  to a **warm standby** (:meth:`deactivate_replica`: its queue moves to
  peers, its engine keeps its graphs and its worker keeps beating) and
  brought back through the same warmup-gated path a relaunch uses
  (:meth:`activate_replica`).  The control plane that drives them is
  ``serve.controller.ServeController``.

On one card, N replicas are N engines on the same device, each with its
own CUDA stream and graph pool.  Single-replica serving is untouched:
``serve.batcher.DynamicBatcher`` stays the default path (``serve.cli``
builds a router only under ``--replicas N`` with N > 1).
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from pdnlp_tpu_torch.obs.request import exemplar_ids, record_hop
from pdnlp_tpu_torch.parallel.watchdog import GangMonitor, Heartbeat
from pdnlp_tpu_torch.serve.batcher import (
    DEFAULT_BUCKETS, AdmissionControl, DeadlineExceeded, LoadShedError,
    QueueFullError, _PackedBatch, _Request, form_packed_batch, pick_bucket,
    resolve_serve_pack, usable_buckets,
)
from pdnlp_tpu_torch.serve.metrics import ReplicaMetrics, RouterMetrics, _save_json
from pdnlp_tpu_torch.train.checkpoint import CorruptCheckpointError


class ReplicaFailedError(RuntimeError):
    """A request's replica died and its retry budget is exhausted (or no
    survivor was available to take it)."""


class _InjectedFault(RuntimeError):
    """Raised inside a replica worker by the chaos hooks — stands in for
    the process death / wedge a SIGKILL'd or hung replica would show."""


class _Replica:
    """One replica incarnation: an engine, its queues, and worker state.

    States: ``warming`` (worker is pre-tracing every bucket; not
    dispatchable) -> ``healthy`` -> ``draining`` (rolling swap: finish
    in-flight, accept queue but execute nothing) -> back to ``healthy``;
    ``standby`` (scaled down by the control plane: queues empty, engine
    warm — compiled caches intact — worker parked but still beating;
    :meth:`ReplicaRouter.activate_replica` sends it back through
    ``warming``, which is all cache hits, so reactivation can never
    retrace); ``ejected`` is terminal for THIS incarnation (a relaunch
    builds a new one in the same slot)."""

    def __init__(self, index: int, engine, buckets: Sequence[int],
                 flush_rows: int, pack_width: int = 0,
                 long_widths: Sequence[int] = ()):
        self.index = index
        self.engine = engine
        self.state = "warming"
        # the flush threshold is the PADDED row count (DynamicBatcher's
        # lesson): executed batches pad to the replica's mesh data-axis
        # multiple anyway, so flushing at a smaller size would cap this
        # replica's occupancy below 1.0 forever
        self.flush_rows = int(flush_rows)
        # packed path: the flush trigger in TOKEN units — a full packed
        # batch worth of real tokens (flush_rows rows x the pack width)
        self.flush_tokens = self.flush_rows * int(pack_width)
        self.queues: Dict[int, List[_Request]] = {b: [] for b in buckets}
        # packed mode's single token-level queue; the per-bucket queues
        # stay alive beside it for hedged duplicates (padded by contract)
        self.pack_queue: List[_Request] = []
        # chunked prefill: one queue per long width (packed path only)
        self.long_queues: Dict[int, List[_Request]] = {
            w: [] for w in long_widths}
        self.inflight: List[_Request] = []
        self.exit_code: Optional[int] = None  # None while the worker lives
        self.batches = 0
        self.retrace_warm: Optional[int] = None  # retraces at end of warmup
        self.fault: Optional[str] = None  # chaos hook: "crash" | "hang"
        self.worker: Optional[threading.Thread] = None
        self.hb: Optional[Heartbeat] = None

    def queued(self) -> int:
        return sum(len(q) for q in self.all_queues())

    def queued_tokens(self) -> int:
        return sum(len(r.ids) for r in self.pack_queue)

    def all_queues(self) -> List[List[_Request]]:
        """Every queue holding requests (bucket queues, the pack queue and
        the long queues) — the sweep/shed/stop paths must see them all."""
        return (list(self.queues.values()) + [self.pack_queue]
                + list(self.long_queues.values()))

    def queue_for(self, req: _Request, packed: bool) -> List[_Request]:
        """The queue ``req`` waits in on this replica: its long width's,
        the pack queue, or its bucket's."""
        if req.bucket in self.long_queues:
            return self.long_queues[req.bucket]
        return self.pack_queue if packed else self.queues[req.bucket]

    def load(self) -> int:
        return self.queued() + len(self.inflight)

    @property
    def retraces_post_warmup(self) -> int:
        if self.retrace_warm is None:
            return 0
        return self.engine.metrics.retraces.value - self.retrace_warm


class _Slot:
    """Stable per-rank holder: the GangMonitor adapter and the replica-
    labelled metrics survive relaunches, so rank i's history is one series
    even as incarnations come and go."""

    def __init__(self, index: int):
        self.index = index
        self.replica: Optional[_Replica] = None
        self.metrics = ReplicaMetrics()
        self.ejected_at: Optional[float] = None


class _PackIntent:
    """A flush decision for the packed path: a SNAPSHOT of the replica's
    pack queue taken under the lock.  The expensive part — slack sort +
    six channel-array builds (``form_packed_batch``) — then runs OUTSIDE
    the pool-global lock (it would otherwise serialize every worker,
    submitter and the monitor against one replica's batch formation).
    The snapshot's requests stay IN the queue meanwhile, so ejection,
    shedding and expiry keep their normal queued semantics; the worker
    reconciles (removes the taken, abandons on ejection) under the lock
    before executing."""

    __slots__ = ("requests", "width")

    def __init__(self, requests: List[_Request], width: int):
        self.requests = requests
        self.width = width  # the pack width, or a chunked-prefill width


class _ReplicaProc:
    """Quacks like a subprocess for :class:`GangMonitor`: ``poll()`` is
    None while the slot's current worker lives, its synthetic exit code
    after a crash, and 0 once the router has processed the ejection (so a
    handled crash stops short-circuiting the monitor's stall checks for
    the OTHER ranks)."""

    def __init__(self, slot: _Slot):
        self._slot = slot

    def poll(self) -> Optional[int]:
        rep = self._slot.replica
        if rep is None or rep.state == "ejected":
            return 0
        return rep.exit_code

    def terminate(self) -> None:  # pragma: no cover - monitor API surface
        pass

    def kill(self) -> None:  # pragma: no cover - monitor API surface
        pass


class ReplicaRouter:
    """N engine replicas behind tiered admission + health-ejecting dispatch
    (module docstring has the full story).

    ``engines`` seeds the pool; ``engine_factory(index)`` (optional) lets
    :meth:`relaunch` build replacement engines after an ejection.  All
    engines must share a tokenizer/bucket view (they are replicas, not a
    heterogeneous fleet).

    ``clock`` (deadlines/latency, default ``time.monotonic``) and
    ``health_clock`` (heartbeat domain, default ``time.time``) are
    injectable so tier transitions and slack ordering are testable without
    sleeping.
    """

    def __init__(
        self,
        engines: Sequence,
        *,
        engine_factory: Optional[Callable[[int], object]] = None,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_batch_size: int = 8,
        max_wait_ms: float = 5.0,
        max_queue: int = 256,
        default_deadline_ms: Optional[float] = None,
        backpressure_at: Optional[int] = None,
        shed_at: Optional[int] = None,
        backpressure_wait_ms: float = 50.0,
        shed_slack_ms: Optional[float] = None,
        degrade_at: Optional[int] = None,
        serve_pack: str = "auto",
        pack_max_segments: int = 16,
        long_widths: Sequence[int] = (),
        max_retries: int = 1,
        model_id: Optional[str] = None,
        hedge_ms: Optional[float] = None,
        stall_timeout: float = 10.0,
        poll_interval: float = 0.1,
        hb_dir: Optional[str] = None,
        telemetry_dir: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        metrics: Optional[RouterMetrics] = None,
        tracer=None,
        clock: Callable[[], float] = time.monotonic,
        health_clock: Callable[[], float] = time.time,
    ):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engine_factory = engine_factory
        self._tokenizer = engines[0].tokenizer
        self.buckets = usable_buckets(buckets, engines[0].args.max_seq_len)
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.default_deadline_ms = default_deadline_ms
        # packed online serving: every admission/flush bound moves from
        # request (row) units to TOKEN units — AdmissionControl itself is
        # unit-agnostic (pending vs thresholds), so packed mode scales the
        # thresholds by the pack width and walks the SAME ladder with
        # pending-token depth.  Hedged duplicates always ride the padded
        # per-bucket path (a hedge exists to dodge a slow replica, not to
        # wait for a pack to fill).
        self.packed = resolve_serve_pack(serve_pack, engines[0].device)
        self.pack_width = self.buckets[-1]
        self.pack_segments = int(pack_max_segments)
        # chunked prefill, sized as the batcher sizes it: a long flush at
        # width w is [max_batch_size * pack_width // w, w], one captured
        # shape per width per replica
        self.long_widths = tuple(sorted({int(w) for w in long_widths}))
        self.long_rows: Dict[int, int] = {}
        self.long_segments: Dict[int, int] = {}
        if self.long_widths:
            from pdnlp_tpu_torch.data.packing import segment_cap

            if not self.packed:
                raise ValueError(
                    "chunked prefill (long_widths) rides the packed path — "
                    "it needs serve_pack to resolve on, got the padded "
                    "per-bucket path")
            cfg = engines[0].cfg
            for w in self.long_widths:
                if w <= self.pack_width or w % 128:
                    raise ValueError(
                        f"long width {w} must exceed the {self.pack_width}-"
                        "token pack width and be a multiple of 128")
                if w > cfg.max_position:
                    raise ValueError(
                        f"long width {w} exceeds the model's "
                        f"{cfg.max_position}-position table — a long "
                        "request is ONE segment, so its positions span "
                        "the full width")
                self.long_rows[w] = engines[0].pad_rows(
                    max(1, self.max_batch_size * self.pack_width // w))
                self.long_segments[w] = segment_cap(
                    w, self.pack_segments, self.pack_width)
        unit = self.pack_width if self.packed else 1
        # a request with less remaining slack than two flush waits cannot
        # make its deadline once the pool is in the shed band — that is the
        # default "doomed" floor the shed tier drops first
        self.admission = AdmissionControl(
            max_queue * unit,
            backpressure_at=(backpressure_at * unit
                             if backpressure_at is not None else None),
            shed_at=shed_at * unit if shed_at is not None else None,
            degrade_at=(degrade_at * unit
                        if degrade_at is not None else None),
            backpressure_wait_ms=backpressure_wait_ms,
            shed_slack_ms=(2 * max_wait_ms if shed_slack_ms is None
                           else shed_slack_ms),
            clock=clock)
        # fleet labelling: a pool serving one model of a multi-model fleet
        # stamps that model id on every hop it records (and the fleet's
        # snapshot keys this pool's metrics under it), so per-request
        # chains and per-model metrics stay joinable
        self.model_id = model_id
        self._hop_attrs: Dict = {"model": model_id} \
            if model_id is not None else {}
        self.max_retries = int(max_retries)
        self.hedge_ms = hedge_ms
        self.stall_timeout = float(stall_timeout)
        self.poll_interval = float(poll_interval)
        self.metrics = metrics or RouterMetrics()
        self.tracer = tracer if tracer is not None else engines[0].tracer
        self.clock = clock
        self.health_clock = health_clock
        self.hb_dir = hb_dir or tempfile.mkdtemp(prefix="pdnlp-serve-hb-")
        # crash-path telemetry: spans + a metrics snapshot land HERE on
        # every ejection and on stop, so a condemned replica's last
        # batches are on disk even when nothing exits cleanly
        self.telemetry_dir = telemetry_dir or self.hb_dir
        self._beat_interval = min(1.0, self.stall_timeout / 5.0)

        self._slots = [_Slot(i) for i in range(len(engines))]
        for slot, engine in zip(self._slots, engines):
            slot.replica = self._make_replica(slot.index, engine)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending = 0          # accepted, not yet completed
        self._pending_tokens = 0   # same, in real tokens (packed admission)
        self._stop = False
        self._started = False
        self._monitor_thread: Optional[threading.Thread] = None
        self._mon: Optional[GangMonitor] = None
        # the checkpoint every incarnation must serve: factory-built
        # relaunch engines load it during their warmup; a successful
        # rolling swap advances it
        self._checkpoint_path = checkpoint_path

    # ------------------------------------------------------------ lifecycle
    def _make_replica(self, index: int, engine) -> _Replica:
        rep = _Replica(index, engine, self.buckets,
                       engine.pad_rows(self.max_batch_size),
                       pack_width=self.pack_width,
                       long_widths=self.long_widths)
        rep.hb = Heartbeat(self.hb_dir, index, interval=self._beat_interval,
                           clock=self.health_clock)
        # forward/compile spans carry the replica rank so the per-replica
        # phase tables (obs.phases) can attribute engine time per replica
        engine.span_attrs = {"replica": index}
        return rep

    def start(self) -> "ReplicaRouter":
        if self._started:
            return self
        self._started = True
        self._stop = False
        for slot in self._slots:
            self._start_worker(slot.replica)
        self._mon = GangMonitor(
            [_ReplicaProc(s) for s in self._slots], self.hb_dir,
            len(self._slots), stall_timeout=self.stall_timeout,
            clock=self.health_clock)
        self._monitor_thread = threading.Thread(
            target=self._monitor, daemon=True, name="pdnlp-serve-monitor")
        self._monitor_thread.start()
        return self

    def _start_worker(self, rep: _Replica) -> None:
        rep.worker = threading.Thread(
            target=self._worker, args=(rep,), daemon=True,
            name=f"pdnlp-serve-replica{rep.index}")
        rep.worker.start()

    def wait_ready(self, timeout: float = 120.0) -> bool:
        """Block until every (non-ejected) replica finished its warmup."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while time.monotonic() < deadline:
                reps = [s.replica for s in self._slots if s.replica]
                if reps and all(r.state in ("healthy", "draining",
                                            "standby", "ejected")
                                for r in reps) \
                        and any(r.state in ("healthy", "draining")
                                for r in reps):
                    return True
                self._cond.wait(timeout=0.05)
        return False

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Shut the pool down; ``drain=True`` serves what is queued first
        (bounded by ``timeout`` and by replica liveness — a dead pool
        cannot drain, it fails what is left loudly instead)."""
        if drain:
            deadline = time.monotonic() + timeout
            with self._lock:
                while self._pending and time.monotonic() < deadline:
                    if not any(s.replica and s.replica.state in
                               ("healthy", "warming", "draining")
                               and s.replica.exit_code is None
                               for s in self._slots):
                        break  # nobody left to serve the backlog
                    self._cond.wait(timeout=0.05)
        with self._lock:
            self._stop = True
            self._cond.notify_all()
            leftovers = []
            for slot in self._slots:
                rep = slot.replica
                if rep is None:
                    continue
                for q in rep.all_queues():
                    leftovers += [r for r in q if not r.done()]
                    q.clear()
                leftovers += [r for r in rep.inflight if not r.done()]
        for t in [s.replica.worker for s in self._slots
                  if s.replica and s.replica.worker] \
                + ([self._monitor_thread] if self._monitor_thread else []):
            t.join(timeout=5)
        self._started = False
        self._monitor_thread = None
        for r in leftovers:
            self._finish(r, error=RuntimeError("router stopped"))
        self.flush_telemetry("stop")

    def __enter__(self) -> "ReplicaRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- metrics
    def _hop(self, rid: str, hop: str, **attrs) -> None:
        """One hop record with this pool's fleet labels (``model``) folded
        in — every hop the router records comes through here so a fleet
        pool can never emit an unlabelled hop."""
        record_hop(self.tracer, rid, hop, **self._hop_attrs, **attrs)

    def _finish(self, r: _Request, logits=None, error=None,
                latency: bool = False,
                replica: Optional[int] = None) -> bool:
        """Complete ``r`` exactly once and keep the pool accounting true
        (first completion decrements pending; hedged losers are no-ops)."""
        with self._lock:
            return self._finish_locked(r, logits, error, latency=latency,
                                       replica=replica)

    def _finish_locked(self, r: _Request, logits=None, error=None,
                       latency: bool = False,
                       replica: Optional[int] = None) -> bool:
        """:meth:`_finish`'s core, for callers already holding the router
        lock — ONE copy of the completion/error taxonomy so the counters,
        the latency histogram the p99 gate reads, and the request's
        TERMINAL hop (exactly one per accepted request — completion is
        first-wins) cannot drift."""
        won = r._complete(logits, error)
        if won:
            self._pending -= 1
            self._pending_tokens -= len(r.ids)
            self.metrics.queue_depth.set(self._pending)
            hop_attrs: Dict = {}
            if replica is not None:
                hop_attrs["replica"] = replica
            if error is None:
                self.metrics.completed_total.inc()
                hop = "complete"
                if latency:
                    self.metrics.request_latency_ms.observe(
                        (self.clock() - r.submitted) * 1e3)
            elif isinstance(error, DeadlineExceeded):
                self.metrics.deadline_expired_total.inc()
                hop = "deadline"
            elif isinstance(error, LoadShedError):
                self.metrics.shed_total.inc()
                hop = "shed"
            else:
                self.metrics.failed_total.inc()
                hop = "failed"
                hop_attrs["error"] = type(error).__name__
            if r.shadow_of is not None:
                # the shadow-side terminal marker: the chain contract
                # (obs.request) proves a shadow duplicate's life ends HERE
                # and never as a caller-visible answer
                hop_attrs["shadow"] = True
            self._hop(r.rid, hop, **hop_attrs)
            self._cond.notify_all()
        return won

    # -------------------------------------------------------------- submit
    @property
    def max_request_tokens(self) -> int:
        """The truncation bound a submitted request gets: the largest long
        width under chunked prefill, else the largest bucket."""
        return self.long_widths[-1] if self.long_widths else self.buckets[-1]

    def submit(self, text: str,
               deadline_ms: Optional[float] = None) -> _Request:
        """Enqueue one text (same truncation contract as the batcher)."""
        ids = self._tokenizer.encode_ids(text, self.max_request_tokens)
        return self.submit_ids(ids, deadline_ms=deadline_ms)

    def make_request(self, ids: List[int],
                     deadline_ms: Optional[float] = None) -> _Request:
        """Build (but do NOT enqueue) a request in this pool's clock
        domain: truncation, bucket pick and deadline stamping — the
        :meth:`submit_ids` front half.  The fleet front door uses this to
        mint the request id and record fleet-level hops (``degrade``,
        ``shadow``) BEFORE a group pool admits the request."""
        if not ids:
            raise ValueError("empty request: submit at least one token id")
        if len(ids) > self.max_request_tokens:
            ids = list(ids)[: self.max_request_tokens]
        deadline_ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        now = self.clock()
        deadline = (now + deadline_ms / 1e3
                    if deadline_ms is not None else None)
        req = _Request(ids, pick_bucket(len(ids), self.buckets), deadline)
        if self.long_widths and len(ids) > self.pack_width:
            # chunked prefill: the smallest long width covering it
            req.bucket = next(w for w in self.long_widths if len(ids) <= w)
        req.submitted = now  # _Request stamps time.monotonic; re-stamp in
        req.deadline = deadline  # the router's (injectable) clock domain
        return req

    def submit_ids(self, ids: List[int],
                   deadline_ms: Optional[float] = None) -> _Request:
        """Tiered admission + least-loaded dispatch; returns the future.

        Raises :class:`QueueFullError` (hard-full, or no replica able to
        take the request) or :class:`LoadShedError` (the shed tier dropped
        the arrival itself: its deadline slack was the pool's lowest and
        under the viability floor)."""
        return self.submit_request(self.make_request(ids, deadline_ms),
                                   deadline_ms=deadline_ms)

    def submit_request(self, req: _Request,
                       deadline_ms: Optional[float] = None) -> _Request:
        """Admission + enqueue for a request :meth:`make_request` built
        (the :meth:`submit_ids` back half, public so the fleet can route
        ONE minted request into whichever model group the traffic policy
        picks)."""
        deadline_ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        shadow = {"shadow": True} if req.shadow_of is not None else {}
        with self._lock:
            if self._stop or not self._started:
                raise RuntimeError("router is not running (call start())")
            tier = self._admit(req)
            slot = self._pick_slot(exclude=None)
            if slot is None:
                self.metrics.rejected_total.inc()
                self._hop(req.rid, "rejected", reason="no-replica",
                          **shadow)
                raise QueueFullError("no replica available (all ejected?)")
            self._enqueue(slot, req)
            # ONE hop for admission + initial queue placement (the attrs
            # carry the tier AND where the request landed); tokens +
            # deadline ride along so serve.replay can reconstruct the
            # arrival process (timestamps, lengths, deadlines) from the
            # recorded chains
            self._hop(req.rid, "admit", tier=tier,
                      replica=slot.index, tokens=len(req.ids),
                      **({} if deadline_ms is None
                         else {"deadline_ms": float(deadline_ms)}),
                      **({"packed": True} if self.packed
                         else {"bucket": req.bucket}),
                      **({"long_width": req.bucket}
                         if req.bucket in self.long_rows else {}))
            self.metrics.requests_total.inc()
            self._pending += 1
            self._pending_tokens += len(req.ids)
            self.metrics.queue_depth.set(self._pending)
            self._cond.notify_all()
        return req

    @property
    def _pending_units(self) -> int:
        """Admission-ladder depth in the ladder's own unit: real TOKENS on
        the packed path (thresholds were scaled by the pack width), raw
        request count on the padded path."""
        return self._pending_tokens if self.packed else self._pending

    def _admit(self, req: _Request) -> str:
        """Walk the admission ladder under the lock; raises to refuse,
        returns the tier the request was accepted at (its ``admit`` hop
        attr)."""
        adm = self.admission
        waited = False
        while True:
            tier = adm.tier(self._pending_units)
            if tier == "healthy":
                return "backpressure" if waited else "healthy"
            if tier == "backpressure":
                if waited:
                    return tier  # bounded wait paid: accept at elevated depth
                waited = True
                self.metrics.backpressure_waits_total.inc()
                wait = adm.backpressure_wait_sec(req)
                t0 = time.monotonic()
                self._cond.wait(timeout=wait)
                self.metrics.backpressure_wait_ms.observe(
                    (time.monotonic() - t0) * 1e3)
                continue  # re-evaluate: depth may have dropped OR grown
            if tier in ("shed", "degrade"):
                # a pool reaching the degrade band with nothing behind it
                # (no fleet, or a fleet with no cheap model) treats it as
                # an early shed tier — the re-route decision belongs to
                # the fleet front door, which consults admission_tier()
                # BEFORE submitting here
                self._shed_pass(arriving=req)
                if req.done():  # the arrival itself was the doomed one
                    raise LoadShedError(
                        "shed: lowest deadline slack in the pool and under "
                        f"the {adm.shed_slack_ms:.0f}ms viability floor")
                return tier  # accepted at shed depth (its slack is viable)
            # tier == "reject"
            self.metrics.rejected_total.inc()
            self._hop(req.rid, "rejected", tier="reject",
                      **({"shadow": True} if req.shadow_of is not None
                         else {}))
            raise QueueFullError(
                f"queue full ({self._pending_units}/{adm.max_queue}"
                + (" tokens)" if self.packed else ")"))

    def _shed_pass(self, arriving: Optional[_Request] = None) -> None:
        """Shed-tier sweep (caller holds the lock): drop the doomed,
        lowest-slack first, across every replica queue."""
        queued = [r for s in self._slots if s.replica
                  for q in s.replica.all_queues() for r in q
                  if not r.done()]
        victims = self.admission.shed_victims(queued, arriving=arriving)
        if not victims:
            return
        victimset = set(map(id, victims))
        for s in self._slots:
            if s.replica is None:
                continue
            for q in s.replica.all_queues():
                q[:] = [r for r in q if id(r) not in victimset]
        for r in victims:
            if r is arriving:
                if r._complete(None, LoadShedError("shed on arrival")):
                    self._hop(r.rid, "shed", arrival=True,
                              **({"shadow": True}
                                 if r.shadow_of is not None else {}))
                self.metrics.shed_total.inc()
            else:
                self._finish_locked(r, error=LoadShedError(
                    "shed while queued: overload tier, lowest deadline "
                    "slack first"))

    def _pick_slot(self, exclude: Optional[int]) -> Optional[_Slot]:
        """Least-loaded dispatchable slot (healthy first; a warming or
        draining replica is a valid queue target — it just executes later
        — but never preferred over a healthy one)."""
        def candidates(states):
            return [s for s in self._slots
                    if s.index != exclude and s.replica is not None
                    and s.replica.state in states
                    and s.replica.exit_code is None]

        for states in (("healthy",), ("warming", "draining")):
            cands = candidates(states)
            if cands:
                return min(cands, key=lambda s: s.replica.load())
        return None

    def _enqueue(self, slot: _Slot, req: _Request) -> None:
        slot.replica.queue_for(req, self.packed).append(req)
        slot.metrics.requests_total.inc()
        slot.metrics.queue_depth.set(slot.replica.queued())

    # -------------------------------------------------------------- worker
    def _worker(self, rep: _Replica) -> None:
        try:
            self._warm(rep)
            while True:
                if rep.fault == "crash":  # chaos hook fires even when idle
                    raise _InjectedFault(
                        f"replica {rep.index} killed (injected)")
                if rep.fault != "hang":  # a wedged process beats no more
                    mem = getattr(rep.engine, "beat_memory", None)
                    rep.hb.beat(step=rep.batches,
                                **(mem() if mem is not None else {}))
                rewarm = False
                with self._lock:
                    if self._stop or rep.state == "ejected":
                        return
                    # snapshot the flush-age knob for the out-of-lock
                    # pack formation below — the knob is written under
                    # this lock (apply_knob), so reading it after release
                    # would race the controller (threadlint T1)
                    wait_ms = self.max_wait_ms
                    # standby -> warming (activate_replica): leave the lock
                    # and re-run the warmup probes — all compile-cache hits
                    # on a warm engine, but the GATE is the same as a
                    # relaunch's, so a cold engine could never slip through
                    rewarm = rep.state == "warming"
                    batch = None
                    if not rewarm and rep.state == "healthy":
                        batch = self._take_flushable(rep)
                    if not rewarm and batch is None:
                        # a non-healthy replica (draining/warming/standby)
                        # must NOT derive its wakeup from overdue queue
                        # ticks — _next_wakeup would return 0 and the
                        # worker would busy-spin on the router lock
                        timeout = (self._next_wakeup(rep)
                                   if rep.state == "healthy" else None)
                        self._cond.wait(timeout=min(
                            self._beat_interval,
                            timeout if timeout is not None else 3600.0))
                        continue
                    if not rewarm:
                        slot = self._slots[rep.index]
                        if not isinstance(batch, _PackIntent):
                            # a _PackIntent's requests stay QUEUED (visible
                            # to eject/shed/expiry) until the pack is
                            # formed below
                            rep.inflight = batch
                            slot.metrics.inflight.set(len(rep.inflight))
                        slot.metrics.queue_depth.set(rep.queued())
                if rewarm:
                    self._warm(rep)
                    continue
                if isinstance(batch, _PackIntent):
                    # the expensive bin-pack runs OUTSIDE the pool lock
                    w = batch.width
                    rows, segs = ((rep.flush_rows, self.pack_segments)
                                  if w == self.pack_width else
                                  (self.long_rows[w], self.long_segments[w]))
                    pb, _ = form_packed_batch(
                        batch.requests, self.clock(), w, rows, segs,
                        self._tokenizer.pad_id, wait_ms / 1e3)
                    with self._lock:
                        if self._stop or rep.state in ("ejected", "standby"):
                            # ejected (or drained to standby) mid-pack:
                            # every snapshot request was requeued onto
                            # peers (they were still queued) — abandon the
                            # formed batch
                            continue
                        # a snapshot request that VANISHED from the queue
                        # without completing was re-homed by the fleet's
                        # rollback drain (extract_queued) while the batch
                        # formed — executing it here would complete a
                        # request another pool now owns and double-count
                        # its pending slot.  Abandon; whatever is still
                        # queued rides the next pack.  (Completed corpses
                        # — shed/expired by the monitor — stay harmless:
                        # their _finish is an idempotent no-op.)
                        queue = (rep.pack_queue if w == self.pack_width
                                 else rep.long_queues[w])
                        queued_ids = set(map(id, queue))
                        if any(id(r) not in queued_ids and not r.done()
                               for r in pb.requests):
                            continue
                        # reconcile: take exactly the packed requests out
                        # of the queue; anything the monitor completed
                        # meanwhile (shed/expired) executes harmlessly —
                        # its _finish is an idempotent no-op.  Leftovers
                        # never left the queue, order intact.
                        takenset = set(map(id, pb.requests))
                        queue[:] = [r for r in queue
                                    if id(r) not in takenset]
                        rep.inflight = pb.requests
                        slot = self._slots[rep.index]
                        slot.metrics.inflight.set(len(pb.requests))
                        slot.metrics.queue_depth.set(rep.queued())
                    batch = pb
                # _execute's hang-chaos loop polls self._stop lock-free
                # by design: a wedged worker exists to SIMULATE a stuck
                # device stream, and flag writes are atomic under the
                # GIL — the monitor ejects this replica either way
                # jaxlint: disable=T1
                self._execute(rep, batch)
                with self._lock:
                    rep.inflight = []
                    rep.batches += 1
                    slot = self._slots[rep.index]
                    slot.metrics.queue_depth.set(rep.queued())
                    slot.metrics.inflight.set(0)
                    self._cond.notify_all()
        except BaseException:  # noqa: BLE001 — a dying worker must leave a
            # verdict behind: the monitor classifies the crash, ejects the
            # replica, and requeues its queued + in-flight requests onto
            # survivors.  Deliberately NO cleanup here — a SIGKILL'd
            # process would not have run any either, and one recovery path
            # (ejection) is easier to trust than two.
            rep.exit_code = 1

    def _warm(self, rep: _Replica) -> None:
        """Warmup-gated (re)integration: pre-trace every bucket shape, then
        baseline the retrace counter — only after that may dispatch see
        this replica, so a relaunch can never introduce a post-warmup
        retrace."""
        rep.hb.beat(force=True)  # the monitor's grace clock starts now
        if self._checkpoint_path and \
                getattr(rep.engine, "checkpoint_path", None) \
                != self._checkpoint_path:
            rep.engine.load_checkpoint(self._checkpoint_path)
        for seq in self.buckets:
            rep.engine.infer_ids(
                [[self._tokenizer.cls_id, self._tokenizer.sep_id]], seq,
                rows=rep.flush_rows)
            rep.hb.beat(force=True)  # a slow compile must not read as a stall
        if self.packed:
            # the packed path's ONE compiled shape; the bucket warmups
            # above stay — hedged duplicates ride the padded path and must
            # not pay (or count) a compile either
            rep.engine.warmup_packed(self.pack_width, rep.flush_rows,
                                     self.pack_segments)
            rep.hb.beat(force=True)
            for w in self.long_widths:  # one captured shape per long width
                rep.engine.warmup_packed(w, self.long_rows[w],
                                         self.long_segments[w])
                rep.hb.beat(force=True)
        rep.retrace_warm = rep.engine.metrics.retraces.value
        with self._lock:
            slot = self._slots[rep.index]
            # recovery/reintegration are recorded ONLY on a real warming ->
            # healthy transition: an incarnation ejected mid-warmup never
            # serves, and claiming its recovery would let the serve-load
            # gates pass on a pool that is actually a replica short
            if rep.state == "warming":
                rep.state = "healthy"
                if slot.ejected_at is not None:
                    self.metrics.recovery_sec.observe(
                        self.clock() - slot.ejected_at)
                    slot.ejected_at = None
                    self.metrics.reintegrations_total.inc()
            self._cond.notify_all()

    def _take_flushable(self, rep: _Replica):
        """Under the lock: expire/skip dead entries, then pop a flushable
        batch — token-budget/aged from the pack queue on the packed path,
        a full or most-overdue aged bucket otherwise (hedged duplicates
        keep the bucket path alive even when packing is on)."""
        now = self.clock()
        for q in rep.all_queues():
            keep = []
            for r in q:
                if r.done():  # hedge copy whose original already finished
                    continue
                if r.deadline is not None and now >= r.deadline:
                    self._finish_locked(r, error=DeadlineExceeded(
                        "deadline passed while queued"))
                else:
                    keep.append(r)
            q[:] = keep
        # chunked prefill, the batcher's ladder: an OVERDUE long flush
        # (2x the age bound) outranks a full short one; shorts otherwise
        # go first; then a full long chunk; then an aged long one
        oldest_long = [(min(r.submitted for r in q), w)
                       for w, q in rep.long_queues.items() if q]
        if oldest_long:
            oldest, w = min(oldest_long)
            if (now - oldest) * 1e3 >= 2 * self.max_wait_ms:
                return _PackIntent(list(rep.long_queues[w]), w)
        if rep.pack_queue:
            # O(queue) scans, deliberately: the queue is bounded by the
            # token-unit admission ceiling (max_queue x width tokens pool-
            # wide, ~1e3 entries/replica at short-request mixes), so the
            # sum + min cost ~tens of µs per wake — noise against the
            # multi-ms batch execution, and the expensive part (batch
            # FORMATION) already runs outside this lock via _PackIntent
            if rep.queued_tokens() >= rep.flush_tokens \
                    or (now - min(r.submitted for r in rep.pack_queue)) \
                    * 1e3 >= self.max_wait_ms:
                # snapshot only — the worker forms the batch OUTSIDE the
                # pool lock (see _PackIntent) and reconciles after
                return _PackIntent(list(rep.pack_queue), self.pack_width)
        for w in self.long_widths:
            q = rep.long_queues[w]
            if q and sum(len(r.ids) for r in q) >= self.long_rows[w] * w:
                return _PackIntent(list(q), w)
        if oldest_long:
            oldest, w = min(oldest_long)
            if (now - oldest) * 1e3 >= self.max_wait_ms:
                return _PackIntent(list(rep.long_queues[w]), w)
        for b, q in rep.queues.items():
            if len(q) >= rep.flush_rows:
                return self._pop(rep, b)
        aged = [(q[0].submitted, b) for b, q in rep.queues.items() if q]
        if aged:
            oldest, b = min(aged)
            if (now - oldest) * 1e3 >= self.max_wait_ms:
                return self._pop(rep, b)
        return None

    def _pop(self, rep: _Replica, bucket: int) -> List[_Request]:
        q = rep.queues[bucket]
        batch, q[:] = q[: rep.flush_rows], q[rep.flush_rows:]
        return batch

    def _next_wakeup(self, rep: _Replica) -> Optional[float]:
        now = self.clock()
        ticks = []
        for q in rep.all_queues():
            for r in q:
                ticks.append(r.submitted + self.max_wait_ms / 1e3)
                if r.deadline is not None:
                    ticks.append(r.deadline)
        if not ticks:
            return None
        return max(0.0, min(ticks) - now)

    def _execute(self, rep: _Replica, batch) -> None:
        """Run one batch on ``rep``'s engine (outside the lock).  Chaos
        hooks fire here; any engine exception condemns the replica (its
        worker dies with the verdict, the monitor handles recovery)."""
        if rep.fault == "crash":
            raise _InjectedFault(f"replica {rep.index} killed (injected)")
        while rep.fault == "hang":
            # wedged, beats stopped: hold the in-flight batch until the
            # monitor ejects us — the stalled-replica failure shape
            if rep.state == "ejected" or self._stop:
                raise _InjectedFault(f"replica {rep.index} wedged (injected)")
            time.sleep(0.02)
        if isinstance(batch, _PackedBatch):
            return self._execute_packed(rep, batch)
        bucket = batch[0].bucket
        t0 = self.clock()
        retried = sum(1 for r in batch if r.retries)
        for r in batch:
            self.metrics.queue_wait_ms.observe((t0 - r.submitted) * 1e3)
        tr = self.tracer
        if tr.enabled:
            now = tr.now()
            oldest = max(t0 - r.submitted for r in batch)
            tr.record("queue_wait", now - oldest, now, replica=rep.index,
                      bucket=bucket, rows=len(batch), retry=retried,
                      request_ids=exemplar_ids(batch))
            for i, r in enumerate(batch):
                # a hedge loser may have been completed elsewhere AFTER
                # this batch formed — a dispatch hop recorded past its
                # terminal would read as an incomplete chain
                if not r.done():
                    self._hop(r.rid, "dispatch", replica=rep.index,
                              bucket=bucket, row=i, retry=r.retries)
        rows = rep.flush_rows
        logits = rep.engine.infer_ids([r.ids for r in batch], bucket,
                                      rows=rows,
                                      request_ids=[r.rid for r in batch])
        slot = self._slots[rep.index]
        slot.metrics.batches_total.inc()
        slot.metrics.batch_occupancy.observe(len(batch) / rows)
        slot.metrics.fill_ratio.observe(
            sum(len(r.ids) for r in batch) / float(rows * bucket))
        for i, r in enumerate(batch):
            self._finish(r, logits=logits[i], latency=True,
                         replica=rep.index)

    def _execute_packed(self, rep: _Replica, pb: _PackedBatch) -> None:
        """The packed twin of :meth:`_execute`: one fixed-shape packed
        forward serving every riding request, results scattered back by
        the batch's ``(row, slot)`` placements.  Occupancy/fill land in
        TOKEN units — a packed batch spends all its rows by construction,
        so rows would read 1.0 forever."""
        t0 = self.clock()
        retried = sum(1 for r in pb.requests if r.retries)
        for r in pb.requests:
            self.metrics.queue_wait_ms.observe((t0 - r.submitted) * 1e3)
        tr = self.tracer
        if tr.enabled:
            now = tr.now()
            oldest = max(t0 - r.submitted for r in pb.requests)
            tr.record("queue_wait", now - oldest, now, replica=rep.index,
                      bucket=pb.width, rows=len(pb.requests),
                      retry=retried, packed=True,
                      request_ids=exemplar_ids(pb.requests))
            for r, (row, seg) in zip(pb.requests, pb.placements):
                if r.done():  # completed elsewhere since the pack formed
                    continue
                self._hop(r.rid, "pack", replica=rep.index,
                          row=row, slot=seg)
                self._hop(r.rid, "dispatch", replica=rep.index,
                          row=row, slot=seg, packed=True,
                          retry=r.retries)
        logits = rep.engine.infer_packed(
            pb.arrays, segments=len(pb.requests),
            request_ids=[r.rid for r in pb.requests])
        slot = self._slots[rep.index]
        slot.metrics.batches_total.inc()
        slot.metrics.batch_occupancy.observe(pb.fill)
        slot.metrics.fill_ratio.observe(pb.fill)
        for r, (row, seg) in zip(pb.requests, pb.placements):
            self._finish(r, logits=logits[row, seg], latency=True,
                         replica=rep.index)

    # ------------------------------------------------------------- monitor
    def _monitor(self) -> None:
        """Health loop: GangMonitor verdicts -> ejection; plus the deadline
        sweep and the hedging scan each tick."""
        while True:
            time.sleep(self.poll_interval)
            with self._lock:
                if self._stop:
                    return
                self._sweep_expired()
                if self.hedge_ms is not None:
                    self._hedge_scan()
            verdict = self._mon.poll()
            if not verdict or verdict.get("kind") not in ("crashed",
                                                          "stalled"):
                continue
            for i in verdict.get("dead_ranks", []):
                slot = self._slots[i]
                rep = slot.replica
                if rep is None or rep.state == "ejected":
                    continue
                if verdict["kind"] == "stalled" and rep.state == "warming":
                    # warmup captures can outlast stall_timeout (the same
                    # reason Heartbeat skips its construction beat and the
                    # GangMonitor grants a pre-first-beat grace window):
                    # beats land between buckets, but ONE bucket's kernel
                    # build and capture is allowed to run long.  A warming replica
                    # is not dispatch-preferred, so leniency costs
                    # nothing; a crashed warmup still ejects above.
                    continue
                self._eject(i, verdict["kind"])

    def _sweep_expired(self) -> None:
        now = self.clock()
        for s in self._slots:
            rep = s.replica
            if rep is None:
                continue
            for q in rep.all_queues():
                keep = []
                for r in q:
                    if r.done():
                        continue
                    if r.deadline is not None and now >= r.deadline:
                        self._finish_locked(r, error=DeadlineExceeded(
                            "deadline passed while queued"))
                    else:
                        keep.append(r)
                q[:] = keep

    def _hedge_scan(self) -> None:
        """Tail hedging, bounded by the deadline budget: a request queued
        past ``hedge_ms`` that still has slack gets ONE duplicate on a
        strictly less-loaded healthy replica; first completion wins.  The
        duplicate always rides the PADDED per-bucket path — a hedge exists
        to dodge a slow replica NOW, so it must not sit waiting for a pack
        to fill, and the padded bucket shapes are always warm."""
        now = self.clock()
        for s in self._slots:
            rep = s.replica
            if rep is None or rep.state == "ejected":
                continue
            for q in rep.all_queues():
                for r in q:
                    # a long request has no padded bucket to hedge onto
                    if (r.hedged or r.done()
                            or r.bucket not in rep.queues
                            or (now - r.submitted) * 1e3 < self.hedge_ms
                            or r.slack(now) <= 0):
                        continue
                    target = self._pick_slot(exclude=rep.index)
                    if target is None or \
                            target.replica.load() >= rep.load():
                        continue
                    r.hedged = True
                    target.replica.queues[r.bucket].append(r)
                    target.metrics.queue_depth.set(target.replica.queued())
                    self.metrics.hedges_total.inc()
                    self._hop(r.rid, "hedge",
                              from_replica=rep.index,
                              to_replica=target.index)
                    self._cond.notify_all()

    def _eject(self, index: int, reason: str) -> None:
        """Remove a dead/stalled replica from dispatch and move every one
        of its requests (queued AND in-flight) onto survivors within their
        remaining deadline budget."""
        with self._lock:
            slot = self._slots[index]
            rep = slot.replica
            rep.state = "ejected"
            slot.ejected_at = self.clock()
            self.metrics.ejections_total.inc()
            slot.metrics.ejections.inc()
            queued = [r for q in rep.all_queues() for r in q]
            inflight = list(rep.inflight)
            for q in rep.all_queues():
                q.clear()
            rep.inflight = []
            slot.metrics.queue_depth.set(0)
            slot.metrics.inflight.set(0)
            now = self.clock()
            for r, was_inflight in [(r, False) for r in queued] \
                    + [(r, True) for r in inflight]:
                if r.done():
                    continue
                # a hedged request whose copy already lives on a survivor
                # needs no requeue — appending it again would put the SAME
                # request twice in one queue and waste a padded row
                if r.hedged and any(
                        s.replica is not None
                        and s.replica.state != "ejected"
                        and any(r in q
                                for q in s.replica.all_queues())
                        for s in self._slots if s.index != index):
                    continue
                if r.deadline is not None and now >= r.deadline:
                    self._finish_locked(r, error=DeadlineExceeded(
                        f"deadline passed during replica {index} ejection"))
                    continue
                if was_inflight and r.retries >= self.max_retries:
                    self._finish_locked(r, error=ReplicaFailedError(
                        f"replica {index} {reason}; retry budget "
                        f"({self.max_retries}) exhausted"))
                    continue
                target = self._pick_slot(exclude=index)
                if target is None:
                    self._finish_locked(r, error=ReplicaFailedError(
                        f"replica {index} {reason}; no survivor to take "
                        "the request"))
                    continue
                if was_inflight:
                    r.retries += 1
                    self.metrics.retries_total.inc()
                    target.metrics.retries.inc()
                else:
                    self.metrics.requeued_total.inc()
                slot.metrics.requeued_out.inc()
                target.metrics.requeued_in.inc()
                self._hop(r.rid, "requeue",
                          from_replica=index, to_replica=target.index,
                          inflight=was_inflight, packed=self.packed)
                # packed: survivors RE-PACK the orphans — they join the
                # target's token (or long) queue and ride its next packed
                # batch within whatever deadline budget they have left
                target.replica.queue_for(r, self.packed).append(r)
                target.metrics.queue_depth.set(target.replica.queued())
            self._cond.notify_all()
        # crash-path telemetry: the condemned replica's spans + a metrics
        # snapshot land on disk NOW — ejection is the only exit a crashed
        # worker gets, so this is its flush (outside the lock: file I/O
        # must not serialize submitters)
        self.flush_telemetry(f"eject replica {index} ({reason})")

    # ------------------------------------------------------------ recovery
    def kill_replica(self, index: int, kind: str = "crash") -> None:
        """Chaos hook (tests, ``chip_smoke.py`` phase 9): make replica
        ``index`` die like a SIGKILL'd process (``crash``: worker dies,
        beats stop) or wedge like a stuck device stream (``hang``: worker
        holds its batch, beats stop)."""
        if kind not in ("crash", "hang"):
            raise ValueError(f"unknown fault kind {kind!r}")
        with self._lock:
            self._slots[index].replica.fault = kind
            self._cond.notify_all()

    def relaunch(self, index: int, engine=None) -> None:
        """Replace an ejected replica with a fresh incarnation.  The new
        engine loads the pool's current checkpoint and re-runs the bucket
        warmup on its worker BEFORE turning healthy (warmup-gated
        reintegration); recovery time (ejection -> healthy) lands in
        ``metrics.recovery_sec``."""
        if engine is None:
            if self.engine_factory is None:
                raise ValueError("relaunch needs an engine or a factory")
            engine = self.engine_factory(index)

        def check_slot_free() -> None:
            old = self._slots[index].replica
            if old is not None and old.state not in ("ejected",):
                raise RuntimeError(
                    f"replica {index} is {old.state}, not ejected")

        with self._lock:
            check_slot_free()
        # replica construction and the pre-install beat both touch the
        # filesystem (heartbeat dir + beat file) — they run OUTSIDE the
        # pool lock (threadlint T3) so a relaunch never serializes
        # submitters and the monitor behind disk I/O; the slot is
        # re-validated under the lock before install
        rep = self._make_replica(index, engine)
        # the dead incarnation's LAST beat is >= stall_timeout old by
        # construction; a fresh beat must land BEFORE the slot flips
        # live, or the monitor's very next poll reads the stale age
        # against a now-alive adapter and falsely ejects the newcomer
        rep.hb.beat(force=True)
        with self._lock:
            check_slot_free()
            self._slots[index].replica = rep
        self._start_worker(rep)

    def swap_checkpoint(self, path: str) -> Dict:
        """Rolling hot-swap: drain + swap one replica at a time so the pool
        keeps serving throughout.  A corrupt artifact
        (:class:`CorruptCheckpointError`) or template mismatch ROLLS BACK
        that replica (a failed load leaves the engine's params untouched)
        and aborts the rollout — a bad file must cost one replica's swap
        attempt, never the pool.  Returns a report dict."""
        report: Dict = {"path": path, "swapped": [], "rolled_back": [],
                        "skipped": []}
        for slot in self._slots:
            with self._lock:
                rep = slot.replica
                if rep is None or rep.state != "healthy":
                    report["skipped"].append(slot.index)
                    continue
                rep.state = "draining"
                self._cond.notify_all()
            # wait out the in-flight batch (new dispatch is paused; its
            # queue keeps accepting and survivors keep serving)
            with self._lock:
                while rep.inflight and rep.exit_code is None \
                        and not self._stop:
                    self._cond.wait(timeout=0.02)
                # the replica may have died or been ejected DURING the
                # drain wait (or the router may be stopping) — swapping a
                # corpse must not count as a successful rollout step
                if self._stop or rep.exit_code is not None \
                        or rep.state != "draining":
                    if rep.state == "draining" and rep.exit_code is None:
                        rep.state = "healthy"  # un-pause a stop-skipped one
                    report["skipped"].append(slot.index)
                    continue
            try:
                with self.tracer.span("swap", replica=slot.index,
                                      path=os.path.basename(path)):
                    rep.engine.load_checkpoint(path)
                self.metrics.swaps_total.inc()
                report["swapped"].append(slot.index)
            except (CorruptCheckpointError, ValueError) as e:
                self.metrics.swap_rollbacks_total.inc()
                report["rolled_back"].append(slot.index)
                report["error"] = f"{type(e).__name__}: {e}"
                with self._lock:
                    if rep.state == "draining":
                        rep.state = "healthy"
                    self._cond.notify_all()
                break
            with self._lock:
                if rep.state == "draining":
                    rep.state = "healthy"
                self._cond.notify_all()
        if report["swapped"] and not report["rolled_back"]:
            self._checkpoint_path = path  # relaunches warm onto the new one
        return report

    # ------------------------------------------------------- tuning surface
    #: the knobs the feedback control plane may actuate — ONE setter
    #: (:meth:`apply_knob`) so every write is thread-safe and every
    #: controller-side write can be funneled through the decision-recording
    #: ``_actuate`` choke point (jaxlint R13 flags any other path)
    KNOBS = ("hedge_ms", "max_wait_ms", "backpressure_at", "shed_at",
             "degrade_at", "shed_slack_ms")

    def apply_knob(self, name: str, value) -> None:
        """Set one tunable serving knob, thread-safely, effective for the
        next flush/scan (workers and the monitor read these under the
        pool lock).  Admission thresholds are validated against the
        ladder's ordering invariant — a controller bug must surface here,
        not as an unreachable tier."""
        with self._lock:
            if name == "hedge_ms":
                self.hedge_ms = None if value is None else float(value)
            elif name == "max_wait_ms":
                self.max_wait_ms = float(value)
            elif name in ("backpressure_at", "shed_at", "degrade_at"):
                adm = self.admission
                trial = {"backpressure_at": adm.backpressure_at,
                         "shed_at": adm.shed_at,
                         "degrade_at": adm.degrade_at,
                         name: (None if value is None and
                                name == "degrade_at" else int(value))}
                if not (0 <= trial["backpressure_at"] <= trial["shed_at"]
                        <= adm.max_queue):
                    raise ValueError(
                        f"knob {name}={value} breaks tier ordering: "
                        f"backpressure_at {trial['backpressure_at']} <= "
                        f"shed_at {trial['shed_at']} <= max_queue "
                        f"{adm.max_queue}")
                if trial["degrade_at"] is not None and not (
                        trial["backpressure_at"] <= trial["degrade_at"]
                        <= trial["shed_at"]):
                    raise ValueError(
                        f"knob {name}={value} breaks tier ordering: "
                        f"degrade_at {trial['degrade_at']} must sit "
                        f"between backpressure_at "
                        f"{trial['backpressure_at']} and shed_at "
                        f"{trial['shed_at']}")
                setattr(adm, name, trial[name])
            elif name == "shed_slack_ms":
                self.admission.shed_slack_ms = float(value)
            else:
                raise KeyError(f"unknown knob {name!r} (tunable: "
                               f"{self.KNOBS})")
            self._cond.notify_all()

    def knob_values(self) -> Dict:
        """Current values of every tunable knob (controller sense input +
        the exporter's ``controller`` source).  Reads under the pool lock
        — the knobs are written there (:meth:`apply_knob`), and a torn
        multi-knob snapshot would hand the controller a tier ordering no
        actuation ever installed (threadlint T1).  No caller holds the
        lock: the telemetry paths (`snapshot`, ejection flush) all run
        outside it."""
        with self._lock:
            return {"hedge_ms": self.hedge_ms,
                    "max_wait_ms": self.max_wait_ms,
                    "backpressure_at": self.admission.backpressure_at,
                    "shed_at": self.admission.shed_at,
                    "degrade_at": self.admission.degrade_at,
                    "shed_slack_ms": self.admission.shed_slack_ms}

    # -------------------------------------------------------- fleet surface
    def admission_tier(self) -> str:
        """The ladder tier an arrival would meet RIGHT NOW — the fleet
        front door consults this before submitting, so a ``degrade``-band
        arrival can be re-routed to the cheap model instead of walking
        into this pool's shed pass."""
        with self._lock:
            return self.admission.tier(self._pending_units)

    def extract_queued(self) -> List[_Request]:
        """Pull every queued (NOT in-flight) request out of this pool —
        the fleet's canary-rollback drain.  Accounting is reconciled
        (pending counts, gauges); in-flight batches finish where they are
        (their callers get the answer that was already executing).  The
        extracted requests are live futures the caller must re-home."""
        with self._lock:
            out: List[_Request] = []
            seen: set = set()  # a hedged request lives in TWO queues
            # a queued request whose twin is IN FLIGHT (a hedged
            # duplicate racing its original) must not be re-homed: this
            # pool is about to complete it, and handing it to another
            # pool would charge two pending slots for one completion
            inflight_ids = {id(r) for s in self._slots if s.replica
                            for r in s.replica.inflight}
            for s in self._slots:
                rep = s.replica
                if rep is None:
                    continue
                for q in rep.all_queues():
                    out += [r for r in q if not r.done()
                            and id(r) not in seen
                            and id(r) not in inflight_ids]
                    seen.update(map(id, q))
                    q.clear()
                s.metrics.queue_depth.set(0)
            for r in out:
                self._pending -= 1
                self._pending_tokens -= len(r.ids)
            self.metrics.queue_depth.set(self._pending)
            self._cond.notify_all()
            return out

    def adopt(self, req: _Request) -> int:
        """Enqueue an ALREADY-ADMITTED request (a fleet re-home: canary
        rollback drains the candidate's queue into the primary pool) —
        deliberately bypassing the admission ladder, because a rollback
        must never turn accepted work into rejections.  Returns the slot
        index; raises :class:`ReplicaFailedError` when no replica can
        take it."""
        with self._lock:
            if self._stop or not self._started:
                raise RuntimeError("router is not running (call start())")
            slot = self._pick_slot(exclude=None)
            if slot is None:
                raise ReplicaFailedError(
                    "no replica available to adopt the request")
            self._enqueue(slot, req)
            self._pending += 1
            self._pending_tokens += len(req.ids)
            self.metrics.requests_total.inc()
            self.metrics.queue_depth.set(self._pending)
            self._cond.notify_all()
            return slot.index

    def deactivate_replica(self, index: Optional[int] = None) -> int:
        """Drain one healthy replica to a WARM STANDBY (control-plane
        scale-down): its queued requests move to peers within their
        deadline budgets (graceful — no retry is charged), its worker
        parks (still beating, so the monitor keeps seeing it alive), and
        its engine keeps every compiled cache, so
        :meth:`activate_replica`'s warmup-gated return is all cache hits —
        zero post-warmup retraces by construction.  ``index=None`` picks
        the least-loaded healthy replica.  Refuses to drain the last
        dispatchable replica.  Returns the drained slot index."""
        with self._lock:
            healthy = [s for s in self._slots if s.replica is not None
                       and s.replica.state == "healthy"
                       and s.replica.exit_code is None]
            dispatchable = [s for s in self._slots if s.replica is not None
                            and s.replica.state in ("healthy", "draining")
                            and s.replica.exit_code is None]
            if index is None:
                cands = sorted(healthy, key=lambda s: s.replica.load())
                if not cands:
                    raise RuntimeError("no healthy replica to deactivate")
                slot = cands[0]
            else:
                slot = self._slots[index]
                if slot.replica is None \
                        or slot.replica.state != "healthy":
                    raise RuntimeError(
                        f"replica {index} is "
                        f"{slot.replica.state if slot.replica else 'empty'}"
                        ", not healthy")
            if len(dispatchable) <= 1:
                raise RuntimeError("refusing to drain the last "
                                   "dispatchable replica")
            rep = slot.replica
            rep.state = "standby"
            self.metrics.scale_downs_total.inc()
            # queued work moves to peers NOW (the standby executes
            # nothing); in-flight work finishes on this worker first —
            # the state flip only stops NEW dispatch
            queued = [r for q in rep.all_queues() for r in q]
            for q in rep.all_queues():
                q.clear()
            slot.metrics.queue_depth.set(0)
            now = self.clock()
            for r in queued:
                if r.done():
                    continue
                if r.deadline is not None and now >= r.deadline:
                    self._finish_locked(r, error=DeadlineExceeded(
                        "deadline passed while queued"))
                    continue
                target = self._pick_slot(exclude=slot.index)
                if target is None:  # cannot happen (dispatchable > 1),
                    rep.state = "healthy"  # but never strand work on a bug
                    raise RuntimeError("no peer to absorb the drained "
                                       "queue")
                self.metrics.requeued_total.inc()
                slot.metrics.requeued_out.inc()
                target.metrics.requeued_in.inc()
                self._hop(r.rid, "requeue",
                          from_replica=slot.index,
                          to_replica=target.index, standby=True,
                          inflight=False, packed=self.packed)
                target.replica.queue_for(r, self.packed).append(r)
                target.metrics.queue_depth.set(target.replica.queued())
            self._cond.notify_all()
            return slot.index

    def activate_replica(self, index: Optional[int] = None) -> int:
        """Bring a warm standby back into dispatch through the SAME
        warmup gate a relaunch uses: standby -> warming (the worker
        re-runs every bucket probe — compile-cache hits on the warm
        engine) -> healthy.  If the pool's checkpoint advanced while the
        replica was parked (rolling swap), the warmup reloads it first.
        ``index=None`` picks the first standby.  Returns the slot index."""
        with self._lock:
            if index is None:
                standbys = [s for s in self._slots if s.replica is not None
                            and s.replica.state == "standby"]
                if not standbys:
                    raise RuntimeError("no standby replica to activate")
                slot = standbys[0]
            else:
                slot = self._slots[index]
                if slot.replica is None \
                        or slot.replica.state != "standby":
                    raise RuntimeError(
                        f"replica {index} is "
                        f"{slot.replica.state if slot.replica else 'empty'}"
                        ", not standby")
            slot.replica.state = "warming"
            self.metrics.scale_ups_total.inc()
            self._cond.notify_all()
            return slot.index

    @property
    def active_count(self) -> int:
        """Replicas currently dispatchable or becoming so (healthy /
        draining / warming) — the control plane's capacity signal."""
        return sum(1 for s in self._slots if s.replica is not None
                   and s.replica.state in ("healthy", "draining", "warming")
                   and s.replica.exit_code is None)

    @property
    def standby_count(self) -> int:
        return sum(1 for s in self._slots if s.replica is not None
                   and s.replica.state == "standby")

    # ----------------------------------------------------------- reporting
    def flush_telemetry(self, event: str = "") -> None:
        """Spans + a full metrics snapshot to disk (``telemetry_dir``),
        best-effort: called from the ejection path and from ``stop`` so a
        pool that dies mid-storm still leaves its evidence.  Telemetry
        flushing must never take the router down with it."""
        try:
            self.tracer.flush()
        except OSError:
            pass
        try:
            _save_json({"event": event,
                        "wall_time": time.time(),
                        **self.snapshot()},
                       os.path.join(self.telemetry_dir,
                                    "router_snapshot.json"))
        except OSError:
            pass

    def control_snapshot(self) -> Dict:
        """The control plane's per-tick sense input: counters, gauges,
        knobs and ONE latency percentile — none of the per-replica
        histogram-window copies :meth:`snapshot` pays, so a sub-second
        control interval never steals meaningful time from the serving
        workers it exists to help."""
        m = self.metrics
        return {
            "router": {
                "requests_total": m.requests_total.value,
                "deadline_expired_total": m.deadline_expired_total.value,
                "queue_depth": m.queue_depth.value,
                "admission": {
                    "backpressure_waits":
                        m.backpressure_waits_total.value,
                    "shed": m.shed_total.value,
                    "rejected": m.rejected_total.value,
                },
                "request_latency_ms":
                    {"p99": m.request_latency_ms.percentile(99)},
            },
            "knobs": self.knob_values(),
            "active": self.active_count,
            "standby": self.standby_count,
        }

    @property
    def tokenizer(self):
        """The pool's shared tokenizer (every replica encodes identically
        — the fleet front door encodes once through this)."""
        return self._tokenizer

    def engine(self, index: int = 0):
        """The live engine in slot ``index`` (current incarnation)."""
        rep = self._slots[index].replica
        if rep is None:
            raise KeyError(f"slot {index} has no replica")
        return rep.engine

    @property
    def states(self) -> Dict[int, str]:
        return {s.index: (s.replica.state if s.replica else "empty")
                for s in self._slots}

    @property
    def retraces_post_warmup(self) -> int:
        """Pool-wide retraces since each LIVE replica's warmup baseline —
        the serve-load smoke's zero-retrace gate (ejected incarnations are
        out of the pool and out of the count)."""
        return sum(s.replica.retraces_post_warmup for s in self._slots
                   if s.replica and s.replica.state != "ejected")

    def snapshot(self) -> Dict:
        """Router + per-replica metrics (incl. each replica's device-slice
        HBM state), JSON-ready (the ``results/serve_load_smoke.json``
        building block and the live exporter's ``serve`` source)."""
        def replica_memory(s: _Slot):
            fn = getattr(s.replica.engine, "memory_snapshot", None) \
                if s.replica else None
            return fn() if fn is not None else None

        return {
            "router": self.metrics.snapshot(),
            "knobs": self.knob_values(),
            "active": self.active_count,
            "standby": self.standby_count,
            "replicas": {
                str(s.index): {
                    "state": s.replica.state if s.replica else "empty",
                    "batches": s.replica.batches if s.replica else 0,
                    "retraces_post_warmup":
                        s.replica.retraces_post_warmup if s.replica else 0,
                    **s.metrics.snapshot(),
                    "engine": (s.replica.engine.metrics.snapshot()
                               if s.replica else None),
                    "memory": replica_memory(s),
                }
                for s in self._slots
            },
        }
