"""Feedback control plane for the serving tier — the twin of
``pdnlp_tpu/serve/controller.py`` (laws, knob specs, decision records and
snapshot keys unchanged).  :class:`ServeController` closes the loop over
the port's routers:

    sense -> decide -> actuate -> evaluate -> (auto-revert)

- **sense**: one ``router.control_snapshot()`` per tick, reduced to
  windowed rates (arrival, deadline-miss, shed, reject, backpressure), the
  latency p99, a queue-pressure utilization EWMA, the windowed drafter
  acceptance and, on the split pools, the TTFT / inter-token p99s and the
  per-pool backlogs;
- **decide**: small, explainable control laws per knob — ``hedge_ms``
  tracks a multiple of observed p99; the flush age (``max_wait_ms``)
  tracks the observed arrival rate; the admission ladder
  (``backpressure_at``, ``shed_slack_ms``) tightens under deadline-miss /
  shed pressure and relaxes back when the pool is clean; the **replica
  count** drains a replica to a warm standby when utilization stays low
  and reactivates it through the router's warmup-gated path when load
  returns (never below ``min_replicas``); the **speculation** law halves
  ``draft_k`` (or switches speculation off) when the drafter's acceptance
  stays low and deepens it when acceptance is high; the **pool split**
  moves one engine between the prefill and decode pools on a sustained
  backlog imbalance; the **rollout** law steps a fleet's canary fraction
  up a :class:`RolloutPlan` and rolls it back on a parity or p99
  regression;
- **actuate**: every write — no exceptions — passes through the
  :meth:`_actuate` choke point, which enforces the knob's **clamp
  range**, a per-knob **cooldown**, the decide-side **hysteresis band**
  and any active **backoff hold**, then records a **decision record**
  (:mod:`pdnlp_tpu_torch.obs.decision`: cause metrics -> action ->
  old/new) so ``python -m pdnlp_tpu_torch.tools.trace decisions`` can
  explain why capacity changed;
- **evaluate / revert**: every actuation opens an evaluation window over
  the SLO signal it was meant to improve; a change whose signal regressed
  past the revert margin is **auto-reverted** and the knob enters a
  capped-exponential **backoff hold**.  The revert itself is a recorded
  decision chained to the original via ``revert_of``.

The controller never takes the router down: a failing tick is counted and
skipped, actuation errors surface in :meth:`snapshot` (the exporter's
``controller`` source), and :meth:`stop` resolves every pending
evaluation so flushed traces always validate.  The clock is injectable
and :meth:`step` runs one tick without the thread, so the laws are
testable without sleeping.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from pdnlp_tpu_torch.obs.decision import mint_decision_id, record_decision
from pdnlp_tpu_torch.serve.fleet import RolloutPlan  # noqa: F401 — the rollout
#   law's config type (re-exported so callers configure rollouts from the
#   controller module they already import)


class KnobSpec:
    """Safe range + anti-oscillation policy for one tunable knob."""

    __slots__ = ("name", "lo", "hi", "cooldown_s", "hysteresis",
                 "signal", "noise_floor", "integer")

    def __init__(self, name: str, lo: float, hi: float, *,
                 cooldown_s: float = 10.0, hysteresis: float = 0.25,
                 signal: str = "p99_ms", noise_floor: float = 0.0,
                 integer: bool = False):
        self.name = name
        self.lo = lo
        self.hi = hi
        self.cooldown_s = float(cooldown_s)
        #: minimum RELATIVE change decide() must want before an actuation
        #: is considered at all — the no-flap band
        self.hysteresis = float(hysteresis)
        #: the SLO signal an actuation of this knob is judged against
        self.signal = signal
        #: absolute signal slack added to the revert margin (percentile
        #: jitter on a quiet pool must not read as a regression)
        self.noise_floor = float(noise_floor)
        self.integer = bool(integer)

    def clamp(self, value: float) -> float:
        v = min(self.hi, max(self.lo, value))
        return int(round(v)) if self.integer else float(v)


def default_specs() -> Dict[str, KnobSpec]:
    """The declared safe ranges (the JAX package's, unchanged)."""
    return {
        "hedge_ms": KnobSpec("hedge_ms", 5.0, 2000.0, cooldown_s=10.0,
                             hysteresis=0.25, signal="p99_ms",
                             noise_floor=5.0),
        "max_wait_ms": KnobSpec("max_wait_ms", 1.0, 250.0, cooldown_s=5.0,
                                hysteresis=0.3, signal="p99_ms",
                                noise_floor=5.0),
        "backpressure_at": KnobSpec("backpressure_at", 1, 10 ** 9,
                                    cooldown_s=10.0, hysteresis=0.2,
                                    signal="slo_pressure",
                                    noise_floor=0.02, integer=True),
        "shed_slack_ms": KnobSpec("shed_slack_ms", 1.0, 1000.0,
                                  cooldown_s=10.0, hysteresis=0.2,
                                  signal="slo_pressure",
                                  noise_floor=0.02),
        # evaluated against p99: a bad scale-DOWN shows up as queueing
        # latency long before it shows up as misses/sheds (scale-UPS are
        # never revert candidates — see _evaluate)
        "replicas": KnobSpec("replicas", 1, 64, cooldown_s=15.0,
                             hysteresis=0.0, signal="p99_ms",
                             noise_floor=5.0, integer=True),
        # the fleet's canary traffic fraction: hysteresis 0 so the small
        # first rollout step (0.05) actuates; judged against p99 like a
        # scale change (the rollout law's OWN parity/latency regression
        # check is the primary rollback trigger — the eval window is the
        # second line of defense)
        "canary_fraction": KnobSpec("canary_fraction", 0.0, 1.0,
                                    cooldown_s=5.0, hysteresis=0.0,
                                    signal="p99_ms", noise_floor=5.0),
        # speculative decoding's draft depth: judged against spec_waste
        # (1 - acceptance, "bad is high" like every revert signal) so a
        # k the drafter cannot cash auto-reverts; hysteresis 0 because
        # the law moves in single integer steps
        "draft_k": KnobSpec("draft_k", 0, 8, cooldown_s=5.0,
                            hysteresis=0.0, signal="spec_waste",
                            noise_floor=0.05, integer=True),
        # the disaggregated pool split (fraction of engines in the
        # prefill role): the law moves in whole-engine quanta (the
        # router's prefill_share_step), so hysteresis 0; the actuation
        # is judged against the signal the DIRECTION it moved puts at
        # risk (growing prefill starves decode -> inter_token_p99_ms,
        # shrinking starves prefill -> ttft_p99_ms) — the law passes
        # the signal explicitly, this default covers injected writes
        "prefill_share": KnobSpec("prefill_share", 0.1, 0.9,
                                  cooldown_s=10.0, hysteresis=0.0,
                                  signal="ttft_p99_ms",
                                  noise_floor=5.0),
    }


class _Sense:
    """One tick's reduced telemetry (plain attrs; JSON-able via vars())."""

    def __init__(self, **kw):
        self.t: float = kw.get("t", 0.0)
        self.arrival_rate: Optional[float] = kw.get("arrival_rate")
        self.miss_rate: Optional[float] = kw.get("miss_rate")
        self.shed_rate: Optional[float] = kw.get("shed_rate")
        self.reject_rate: Optional[float] = kw.get("reject_rate")
        self.backpressure_rate: Optional[float] = kw.get(
            "backpressure_rate")
        self.p99_ms: Optional[float] = kw.get("p99_ms")
        self.queue_depth: float = kw.get("queue_depth", 0.0)
        self.util: Optional[float] = kw.get("util")
        self.active: int = kw.get("active", 0)
        self.standby: int = kw.get("standby", 0)
        #: windowed speculative-decoding acceptance (accepted/drafted
        #: over this tick's counter delta; None = no drafting happened)
        self.accept_rate: Optional[float] = kw.get("accept_rate")
        #: disaggregated pools: the two latency signals the pool-split
        #: law trades off (blending them into one p99 would hide the
        #: tradeoff the split exists to move), plus per-pool pressure
        self.ttft_p99_ms: Optional[float] = kw.get("ttft_p99_ms")
        self.inter_token_p99_ms: Optional[float] = kw.get(
            "inter_token_p99_ms")
        self.prefill_backlog: Optional[float] = kw.get("prefill_backlog")
        self.decode_backlog: Optional[float] = kw.get("decode_backlog")
        self.knobs: Dict = kw.get("knobs", {})

    @property
    def spec_waste(self) -> Optional[float]:
        """Fraction of drafted tokens the verify call threw away —
        speculation's "bad is high" signal (the ``draft_k`` knob's
        revert judge)."""
        if self.accept_rate is None:
            return None
        return 1.0 - self.accept_rate

    @property
    def slo_pressure(self) -> Optional[float]:
        """The request-weighted fraction of traffic the pool is failing
        (deadline misses + sheds + rejects) — the admission and scaling
        laws' composite signal."""
        parts = [self.miss_rate, self.shed_rate, self.reject_rate]
        if all(p is None for p in parts):
            return None
        return sum(p or 0.0 for p in parts)

    def signal(self, key: str) -> Optional[float]:
        if key == "slo_pressure":
            return self.slo_pressure
        return getattr(self, key, None)

    def as_dict(self) -> Dict:
        out = {k: v for k, v in vars(self).items() if k != "knobs"}
        out["slo_pressure"] = self.slo_pressure
        out["spec_waste"] = self.spec_waste
        return out


class _PendingEval:
    """One actuation awaiting its evaluation-window verdict."""

    __slots__ = ("did", "knob", "old", "new", "signal", "baseline",
                 "t_eval", "revert_of")

    def __init__(self, did, knob, old, new, signal, baseline, t_eval,
                 revert_of):
        self.did = did
        self.knob = knob
        self.old = old
        self.new = new
        self.signal = signal
        self.baseline = baseline
        self.t_eval = t_eval
        self.revert_of = revert_of


class ServeController:
    """The serve tier's feedback controller (module docstring).

    ``router`` needs the :class:`~pdnlp_tpu_torch.serve.router.ReplicaRouter`
    tuning surface: ``snapshot()``, ``apply_knob``/``knob_values``,
    ``deactivate_replica``/``activate_replica``, ``active_count``/
    ``standby_count`` — a test double with those quacks fine.  ``clock``
    is injectable; :meth:`step` runs one full tick without the thread, so
    the control laws are testable without sleeping.
    """

    def __init__(self, router, *,
                 interval_s: float = 1.0,
                 min_replicas: int = 1,
                 specs: Optional[Dict[str, KnobSpec]] = None,
                 eval_window_s: float = 10.0,
                 revert_margin: float = 0.2,
                 hold_base_s: float = 30.0,
                 hold_cap_s: float = 480.0,
                 hedge_factor: float = 2.0,
                 manage_hedge: Optional[bool] = None,
                 manage_flush: bool = True,
                 manage_admission: bool = True,
                 fill_fraction: float = 0.5,
                 wait_budget_ms: Optional[float] = 50.0,
                 pressure_hi: float = 0.05,
                 pressure_lo: float = 0.005,
                 util_low: float = 0.15,
                 util_high: float = 0.75,
                 util_batch: float = 0.5,
                 accept_floor: float = 0.35,
                 accept_high: float = 0.85,
                 spec_patience: int = 2,
                 split_patience: int = 2,
                 split_backlog_min: float = 2.0,
                 scale_patience: int = 3,
                 ewma_alpha: float = 0.4,
                 batch_rows: Optional[int] = None,
                 rollout: Optional[RolloutPlan] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None):
        self.router = router
        self.interval_s = float(interval_s)
        self.min_replicas = max(1, int(min_replicas))
        self.specs = dict(default_specs())
        if specs:
            self.specs.update(specs)
        self.specs["replicas"].lo = self.min_replicas
        slots = getattr(router, "_slots", None)
        if slots is not None:
            self.specs["replicas"].hi = len(slots)
        self.eval_window_s = float(eval_window_s)
        self.revert_margin = float(revert_margin)
        self.hold_base_s = float(hold_base_s)
        self.hold_cap_s = float(hold_cap_s)
        self.hedge_factor = float(hedge_factor)
        # hedging is managed only where it is wired at all: a router
        # launched with hedge_ms=None (hedging off) keeps it off unless
        # explicitly opted in
        self.manage_hedge = (router.knob_values().get("hedge_ms")
                             is not None if manage_hedge is None
                             else bool(manage_hedge))
        self.manage_flush = bool(manage_flush)
        self.manage_admission = bool(manage_admission)
        self.fill_fraction = float(fill_fraction)
        #: cap on the flush age the arrival law may ask for — batching
        #: never buys latency past the point a deadline-bound service can
        #: afford (the clamp range is the SAFE bound; this is the law's
        #: SENSIBLE bound, and the gap between the two is exactly where
        #: the bad-actuation probe injects)
        self.wait_budget_ms = (None if wait_budget_ms is None
                               else float(wait_budget_ms))
        self.pressure_hi = float(pressure_hi)
        self.pressure_lo = float(pressure_lo)
        self.util_low = float(util_low)
        self.util_high = float(util_high)
        #: below this utilization the flush-age law floors the age:
        #: batches execute as FIXED padded shapes, so waiting to fill rows
        #: only pays when the pool actually needs the capacity — an idle
        #: pool should trade its abundant rows for latency, not the
        #: reverse
        self.util_batch = float(util_batch)
        #: speculation law bands: below the floor for ``spec_patience``
        #: consecutive ticks the drafter is wasting its k (halve it /
        #: switch speculation off); above the high band the drafter is
        #: cashing almost everything (a deeper k is free upside)
        self.accept_floor = float(accept_floor)
        self.accept_high = float(accept_high)
        self.spec_patience = int(spec_patience)
        self._spec_low_ticks = 0
        #: pool-split law: sustained one-sided backlog pressure (at least
        #: ``split_backlog_min`` more queued streams than the other pool)
        #: for ``split_patience`` consecutive ticks earns one whole-engine
        #: re-role; the signed counter means flapping pressure resets it
        self.split_patience = int(split_patience)
        self.split_backlog_min = float(split_backlog_min)
        self._split_ticks = 0
        self.scale_patience = int(scale_patience)
        self.ewma_alpha = float(ewma_alpha)
        self.batch_rows = int(batch_rows
                              if batch_rows is not None
                              else getattr(router, "max_batch_size", 8))
        self.clock = clock
        self.tracer = tracer if tracer is not None \
            else getattr(router, "tracer", None)

        #: the canary-rollout law's config (None = no rollout management;
        #: also requires the router to BE a fleet — rollout_sense() is the
        #: FleetRouter surface the law reads)
        self.rollout = rollout
        self._rollout_ticks = 0
        self._rollout_aborted = False
        self.rollbacks_total = 0
        knobs0 = router.knob_values()
        self._default_backpressure_at = knobs0.get("backpressure_at")
        self._default_shed_slack_ms = knobs0.get("shed_slack_ms")
        self._prev_counters: Optional[Dict] = None
        self._prev_t: Optional[float] = None
        self._util_ew: Optional[float] = None
        self._low_ticks = 0
        self._pending: List[_PendingEval] = []
        self._last_actuated: Dict[str, float] = {}
        self._last_did: Dict[str, str] = {}  # per-knob latest decision id
        self._hold_until: Dict[str, float] = {}
        self._strikes: Dict[str, int] = {}
        self.last_sense: Optional[_Sense] = None
        self.actuations_total = 0
        self.reverts_total = 0
        self.blocked_total = 0     # cooldown/hold/clamp-no-op refusals
        self.errors_total = 0
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()   # protects _pending vs snapshot()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ServeController":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="pdnlp-serve-controller")
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the loop and RESOLVE every pending evaluation (outcome
        ``shutdown``) — a flushed trace must never carry an action without
        an outcome."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        with self._lock:
            pending, self._pending = self._pending, []
        sense = self.last_sense
        for p in pending:
            observed = sense.signal(p.signal) if sense is not None else None
            self._record_outcome(p, "shutdown", observed)

    def __enter__(self) -> "ServeController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — the control plane
                # must never take the serving tier down with it
                self.errors_total += 1
                self.last_error = f"{type(e).__name__}: {e}"

    # ---------------------------------------------------------------- sense
    def step(self) -> Optional[_Sense]:
        """One full control tick: sense -> evaluate pending -> decide ->
        actuate.  Public so tests (and the chip smoke) can drive the loop with
        an injected clock instead of the thread."""
        sense = self._sense()
        if sense is None:
            return None  # first tick primes the counter deltas only
        self.last_sense = sense
        self._evaluate(sense)
        self._decide(sense)
        return sense

    def _sense(self) -> Optional[_Sense]:
        # prefer the router's lightweight control_snapshot: the full
        # snapshot copies every per-replica histogram window, and at a
        # sub-second control interval that steals real time from the
        # serving workers it is supposed to be helping
        snap_fn = getattr(self.router, "control_snapshot", None) \
            or self.router.snapshot
        snap = snap_fn()
        now = self.clock()
        r = snap.get("router", {})
        adm = r.get("admission", {})
        spec = snap.get("speculation") or {}
        counters = {
            "requests": r.get("requests_total", 0),
            "deadline": r.get("deadline_expired_total", 0),
            "shed": adm.get("shed", 0),
            "rejected": adm.get("rejected", 0),
            "backpressure": adm.get("backpressure_waits", 0),
            "draft_tokens": spec.get("draft_tokens", 0),
            "accepted_tokens": spec.get("accepted_tokens", 0),
        }
        prev, prev_t = self._prev_counters, self._prev_t
        self._prev_counters, self._prev_t = counters, now
        if prev is None or prev_t is None or now <= prev_t:
            return None
        dt = now - prev_t
        d = {k: counters[k] - prev[k] for k in counters}
        # arrival rate = admissions + hard rejects; sheds are deliberately
        # EXCLUDED — shed_total mixes arrival sheds (not in
        # requests_total) with shed-while-queued (already counted at
        # admit), and double-counting the latter would inflate the
        # arrival rate exactly when the pool is shedding, pushing the
        # flush-age law toward shorter waits mid-overload
        arrived = d["requests"] + d["rejected"]
        per_req = max(1.0, float(arrived))
        lat = r.get("request_latency_ms", {}) or {}
        # disaggregated routers surface the split latency signals and a
        # per-pool pressure block; absent on every other router shape
        lat2 = snap.get("latency") or {}
        pools = snap.get("by_pool") or {}
        active = snap.get("active",
                          getattr(self.router, "active_count", 1))
        queue_depth = float(r.get("queue_depth", 0.0))
        util = queue_depth / max(1.0, active * self.batch_rows)
        a = self.ewma_alpha
        self._util_ew = util if self._util_ew is None \
            else a * util + (1 - a) * self._util_ew
        return _Sense(
            t=now,
            arrival_rate=arrived / dt,
            miss_rate=d["deadline"] / per_req,
            shed_rate=d["shed"] / per_req,
            reject_rate=d["rejected"] / per_req,
            backpressure_rate=d["backpressure"] / per_req,
            p99_ms=lat.get("p99"),
            queue_depth=queue_depth,
            util=self._util_ew,
            active=active,
            standby=snap.get("standby",
                             getattr(self.router, "standby_count", 0)),
            # no eager default: knob_values() takes the pool lock, and
            # control_snapshot already carries the knobs on every tick
            knobs=(snap["knobs"] if "knobs" in snap
                   else self.router.knob_values()),
            # windowed acceptance: this tick's drafted/accepted deltas,
            # not the lifetime ratio — a drafter that goes cold must show
            # up within spec_patience ticks, and a cumulative rate
            # converges far too slowly for that
            accept_rate=(d["accepted_tokens"] / d["draft_tokens"]
                         if d["draft_tokens"] > 0 else None),
            ttft_p99_ms=lat2.get("ttft_p99_ms"),
            inter_token_p99_ms=lat2.get("inter_token_p99_ms"),
            prefill_backlog=(pools.get("prefill") or {}).get("backlog"),
            decode_backlog=(pools.get("decode") or {}).get("backlog"),
        )

    # --------------------------------------------------------------- decide
    def _decide(self, s: _Sense) -> None:
        cause = {k: round(v, 6) for k, v in s.as_dict().items()
                 if isinstance(v, (int, float))}
        self._decide_hedge(s, cause)
        self._decide_flush_age(s, cause)
        self._decide_admission(s, cause)
        self._decide_replicas(s, cause)
        self._decide_speculation(s, cause)
        self._decide_pool_split(s, cause)
        self._decide_rollout(s, cause)

    def _wants(self, knob: str, current, target) -> bool:
        """The decide-side hysteresis band: only a relative change beyond
        the knob's band is worth actuating (no oscillation around the
        setpoint)."""
        spec = self.specs[knob]
        if current is None:
            return True
        cur = float(current)
        if cur == 0:
            return target != 0
        return abs(float(target) - cur) / abs(cur) > spec.hysteresis

    def _decide_hedge(self, s: _Sense, cause: Dict) -> None:
        if not self.manage_hedge or s.p99_ms is None:
            return
        target = self.specs["hedge_ms"].clamp(self.hedge_factor * s.p99_ms)
        if self._wants("hedge_ms", s.knobs.get("hedge_ms"), target):
            self._actuate("hedge_ms", target, cause)

    def _decide_flush_age(self, s: _Sense, cause: Dict) -> None:
        if not self.manage_flush or not s.arrival_rate:
            return
        # batching buys CAPACITY (batches execute as fixed padded shapes,
        # so per-batch cost is flat in real rows) at the price of waiting.
        # Under low utilization capacity is abundant — flush immediately.
        # Once the pool is working for a living, wait a fraction of the
        # observed batch fill time (arrival-rate tracked), capped by the
        # wait budget a deadline-bound service can afford.
        if s.util is not None and s.util < self.util_batch:
            target_ms = self.specs["max_wait_ms"].lo
        else:
            per_replica = s.arrival_rate / max(1, s.active)
            fill_s = self.batch_rows / max(per_replica, 1e-6)
            target_ms = 1e3 * self.fill_fraction * fill_s
            if self.wait_budget_ms is not None:
                target_ms = min(target_ms, self.wait_budget_ms)
        target = self.specs["max_wait_ms"].clamp(target_ms)
        if self._wants("max_wait_ms", s.knobs.get("max_wait_ms"), target):
            self._actuate("max_wait_ms", target, cause)

    def _decide_admission(self, s: _Sense, cause: Dict) -> None:
        if not self.manage_admission:
            return
        pressure = s.slo_pressure
        if pressure is None:
            return
        cur = s.knobs.get("backpressure_at")
        if cur is not None:
            spec = self.specs["backpressure_at"]
            shed_at = s.knobs.get("shed_at")
            hi = min(spec.hi, shed_at if shed_at is not None else spec.hi,
                     self._default_backpressure_at or spec.hi)
            if pressure > self.pressure_hi:
                # failing traffic: convert bursts to latency earlier
                target = max(spec.lo, int(cur * 0.75))
            elif pressure < self.pressure_lo and cur < hi:
                # clean pool: relax back toward the configured default
                target = min(hi, max(cur + 1, int(cur * 1.25)))
            else:
                target = cur
            if target != cur and self._wants("backpressure_at", cur,
                                             target):
                self._actuate("backpressure_at", target, cause)
        # the shed tier's viability floor rides the same pressure signal:
        # when deadline-miss/shed rates say the pool is failing traffic,
        # raise the floor so doomed work is dropped EARLIER (freeing
        # capacity for requests that can still make it); decay back
        # toward the configured default when the pool runs clean
        slack = s.knobs.get("shed_slack_ms")
        if slack is not None:
            sspec = self.specs["shed_slack_ms"]
            default = self._default_shed_slack_ms or sspec.lo
            if pressure > self.pressure_hi:
                target = sspec.clamp(max(slack * 1.5, default))
            elif pressure < self.pressure_lo and slack > default:
                target = sspec.clamp(max(default, slack / 1.5))
            else:
                target = slack
            if target != slack and self._wants("shed_slack_ms", slack,
                                               target):
                self._actuate("shed_slack_ms", target, cause)

    def _decide_replicas(self, s: _Sense, cause: Dict) -> None:
        pressure = s.slo_pressure or 0.0
        rising = (s.util is not None and s.util > self.util_high) \
            or (s.backpressure_rate or 0.0) > 0 \
            or pressure > self.pressure_hi
        if rising and s.standby > 0:
            self._low_ticks = 0
            self._actuate("replicas", s.active + 1, cause)
            return
        low = (s.util is not None and s.util < self.util_low
               and (s.backpressure_rate or 0.0) == 0
               and pressure <= self.pressure_lo)
        if low and s.active > self.min_replicas:
            self._low_ticks += 1
            if self._low_ticks >= self.scale_patience:
                self._low_ticks = 0
                self._actuate("replicas", s.active - 1, cause)
        else:
            self._low_ticks = 0

    def _decide_speculation(self, s: _Sense, cause: Dict) -> None:
        """The speculation law: the drafter earns its k or loses it.

        Windowed acceptance below ``accept_floor`` for ``spec_patience``
        consecutive ticks means the cheap model is drafting tokens the
        primary keeps refusing — every rejected draft is a wasted drafter
        step AND a wasted verify column, so halve k (switch speculation
        off entirely when acceptance is catastrophic or k is already at
        1).  Acceptance above ``accept_high`` means nearly every draft is
        landing: a deeper k is close-to-free upside, step it up by one.
        Both moves route through :meth:`_actuate`, so they are clamped to
        the ``draft_k`` spec, hold-off/cooldown gated, decision-recorded,
        and auto-revert-eligible on ``spec_waste`` regression.
        ``accept_rate is None`` (no drafting happened in the window —
        speculation off or traffic idle) ticks the law to a standstill:
        re-enable is the revert path's job, not a blind retry."""
        cur = s.knobs.get("draft_k")
        if s.accept_rate is None or cur is None or cur <= 0:
            self._spec_low_ticks = 0
            return
        cur = int(cur)
        if s.accept_rate < self.accept_floor:
            self._spec_low_ticks += 1
            if self._spec_low_ticks >= self.spec_patience:
                self._spec_low_ticks = 0
                target = 0 if (s.accept_rate < self.accept_floor / 2
                               or cur <= 1) else cur // 2
                self._actuate("draft_k", target, cause)
            return
        self._spec_low_ticks = 0
        if s.accept_rate > self.accept_high \
                and cur < int(self.specs["draft_k"].hi):
            self._actuate("draft_k", cur + 1, cause)

    def _decide_pool_split(self, s: _Sense, cause: Dict) -> None:
        """The pool-split law: the controller's first STRUCTURAL knob.

        Dormant unless the router is disaggregated (``prefill_share`` +
        its quantum ``prefill_share_step`` in the sensed knobs).  The
        pressure signal is the BACKLOG imbalance — streams queued for a
        prefill slot vs payloads queued at decode doors — because
        backlog leads latency: by the time ``ttft_p99`` degrades, the
        prefill queue has been starved for a full histogram window.
        Sustained imbalance (``split_backlog_min`` for
        ``split_patience`` ticks, signed so flapping resets) moves the
        split ONE engine quantum, through :meth:`_actuate` with the
        eval signal the move puts at risk: growing the prefill pool is
        judged against ``inter_token_p99_ms`` (decode lost an engine),
        shrinking against ``ttft_p99_ms`` — so a re-balance that hurts
        the side it taxed auto-reverts.  Targets are quantized exactly
        as the router reports them (``round(cur ± step, 6)``), so the
        eval window's staleness check compares equal."""
        cur = s.knobs.get("prefill_share")
        step = s.knobs.get("prefill_share_step")
        if cur is None or step is None:
            return  # not a disaggregated pool
        pb = s.prefill_backlog
        db = s.decode_backlog
        if pb is None and db is None:
            return
        pb = float(pb or 0.0)
        db = float(db or 0.0)
        spec = self.specs["prefill_share"]
        if pb >= db + self.split_backlog_min:
            self._split_ticks = max(0, self._split_ticks) + 1
            if self._split_ticks >= self.split_patience:
                self._split_ticks = 0
                target = round(float(cur) + float(step), 6)
                if spec.lo <= target <= spec.hi:
                    self._actuate("prefill_share", target, cause,
                                  signal="inter_token_p99_ms")
        elif db >= pb + self.split_backlog_min:
            self._split_ticks = min(0, self._split_ticks) - 1
            if -self._split_ticks >= self.split_patience:
                self._split_ticks = 0
                target = round(float(cur) - float(step), 6)
                if spec.lo <= target <= spec.hi:
                    self._actuate("prefill_share", target, cause,
                                  signal="ttft_p99_ms")
        else:
            self._split_ticks = 0

    def _decide_rollout(self, s: _Sense, cause: Dict) -> None:
        """The canary-rollout law: step ``canary_fraction`` up the
        :class:`RolloutPlan` while shadow parity and candidate p99 hold;
        ROLL BACK to 0 — through the same ``_actuate`` choke point, so
        the undo is clamped, decision-recorded and chained to the advance
        it reverses — the moment either regresses.  A rolled-back rollout
        stays down: re-trying a candidate the evidence condemned needs an
        operator (a new candidate resets the controller)."""
        plan = self.rollout
        sense_fn = getattr(self.router, "rollout_sense", None)
        if plan is None or sense_fn is None:
            return
        rs = sense_fn()
        frac = rs.get("canary_fraction") or 0.0
        cause = {**cause,
                 **{f"rollout_{k}": round(v, 6) for k, v in rs.items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)}}
        checked = rs.get("parity_checked") or 0
        mismatch = rs.get("mismatch_rate") or 0.0
        p_p99 = rs.get("primary_p99_ms")
        c_p99 = rs.get("candidate_p99_ms")
        evidence = checked >= plan.min_shadow_checked
        parity_bad = evidence and mismatch > plan.parity_tolerance
        p99_bad = (p_p99 is not None and c_p99 is not None
                   and c_p99 > plan.p99_factor * p_p99 + plan.p99_floor_ms)
        if frac > 0 and (parity_bad or p99_bad):
            # ROLLBACK: the fraction drops to 0 (the fleet drains the
            # candidate's queue back to the primary), force=True so a
            # cooldown can never delay the undo, revert_of chains it to
            # the advance (and keeps the eval window from "reverting the
            # rollback" — re-installing a condemned canary)
            if self._actuate(
                    "canary_fraction", 0.0,
                    {**cause, "rollback": True,
                     "parity_bad": parity_bad, "p99_bad": p99_bad},
                    force=True,
                    revert_of=self._last_did.get("canary_fraction",
                                                 "rollout")):
                self.rollbacks_total += 1
                self._rollout_aborted = True
                self._rollout_ticks = 0
            return
        if self._rollout_aborted or frac >= plan.steps[-1]:
            return  # rolled back for good, or rollout complete
        if not evidence or parity_bad or p99_bad:
            self._rollout_ticks = 0
            return
        self._rollout_ticks += 1
        if self._rollout_ticks < plan.patience:
            return
        self._rollout_ticks = 0
        nxt = next((st for st in plan.steps if st > frac + 1e-9),
                   plan.steps[-1])
        self._actuate("canary_fraction", nxt, cause)

    # -------------------------------------------------------------- actuate
    def _actuate(self, knob: str, value, cause: Dict, *,
                 signal: Optional[str] = None, force: bool = False,
                 revert_of: Optional[str] = None) -> bool:
        """THE choke point: every knob write in the control plane comes
        through here.  Enforces the
        backoff hold, the per-knob cooldown and the clamp range, applies
        the change through the router's thread-safe setter surface,
        records the decision chain, and opens the evaluation window."""
        spec = self.specs[knob]
        now = self.clock()
        if not force:
            if now < self._hold_until.get(knob, 0.0):
                self.blocked_total += 1
                return False
            if now - self._last_actuated.get(knob, -1e18) < spec.cooldown_s:
                self.blocked_total += 1
                return False
        # None is a legitimate knob value (hedge_ms=None = hedging off) —
        # both as the pre-actuation old value a revert restores and as a
        # revert target; clamp only applies to numbers
        value = spec.clamp(value) if value is not None else None
        old = self._knob_value(knob)
        if value == (spec.clamp(old)
                     if spec.integer and old is not None else old):
            self.blocked_total += 1
            return False
        signal_key = signal or spec.signal
        baseline = (self.last_sense.signal(signal_key)
                    if self.last_sense is not None else None)
        try:
            self._apply(knob, value, old)
        except Exception as e:  # noqa: BLE001 — a refused apply (e.g. the
            # last dispatchable replica) is a blocked decision, not a
            # controller crash
            self.errors_total += 1
            self.last_error = f"{type(e).__name__}: {e}"
            return False
        did = mint_decision_id()
        if self.tracer is not None:
            record_decision(self.tracer, did, "action", knob=knob,
                            old=old, new=value, cause=cause,
                            signal=signal_key,
                            **({"baseline": baseline}
                               if baseline is not None else {}),
                            **({"revert_of": revert_of}
                               if revert_of else {}))
        self.actuations_total += 1
        self._last_actuated[knob] = now
        self._last_did[knob] = did
        with self._lock:
            self._pending.append(_PendingEval(
                did, knob, old, value, signal_key, baseline,
                now + self.eval_window_s, revert_of))
        return True

    def _knob_value(self, knob: str):
        if knob == "replicas":
            return getattr(self.router, "active_count", None)
        return self.router.knob_values().get(knob)

    def _apply(self, knob: str, value, old) -> None:
        if knob == "replicas":
            current = self.router.active_count
            if value < current:
                self.router.deactivate_replica()
            elif value > current:
                self.router.activate_replica()
            return
        self.router.apply_knob(knob, value)

    def inject(self, knob: str, value, cause_label: str = "injected"
               ) -> bool:
        """Chaos/test hook: push an actuation through the SAME ``_actuate``
        choke point (clamped, decision-recorded, evaluated) bypassing only
        cooldown/hold — a test injects a bad value here and checks that
        the evaluation window auto-reverts it."""
        return self._actuate(knob, value, {"note": cause_label},
                             force=True)

    # ------------------------------------------------------------- evaluate
    def _evaluate(self, s: _Sense) -> None:
        with self._lock:
            due = [p for p in self._pending if s.t >= p.t_eval]
            self._pending = [p for p in self._pending if s.t < p.t_eval]
        for p in due:
            observed = s.signal(p.signal)
            spec = self.specs[p.knob]
            # staleness: if the knob no longer holds the value this
            # actuation set (something else — a forced rollback, a crash
            # changing active_count — moved it since), there is nothing
            # left to keep OR revert: "reverting" to p.old would
            # re-install state a later decision deliberately replaced
            # (e.g. routing caller traffic back onto a canary the
            # rollout law just condemned)
            current = self._knob_value(p.knob)
            if current != p.new:
                self._record_outcome(p, "superseded", observed)
                continue
            # a scale-UP is never a revert candidate: the ambient signal
            # can keep worsening while the burst that triggered it is
            # still building, and "reverting" would drain capacity at
            # exactly the moment the SLO is failing — the symmetric risk
            # (drained too much) is what revert exists for, and that is
            # the scale-DOWN direction, which stays fully revertable
            scale_up = (p.knob == "replicas"
                        and isinstance(p.old, (int, float))
                        and isinstance(p.new, (int, float))
                        and p.new > p.old)
            regressed = (
                p.revert_of is None and not scale_up
                and observed is not None and p.baseline is not None
                and (observed - p.baseline)
                > max(self.revert_margin * abs(p.baseline),
                      spec.noise_floor))
            if not regressed:
                if p.revert_of is None:
                    self._strikes[p.knob] = 0
                self._record_outcome(p, "kept", observed)
                continue
            # the change made its own SLO signal worse: undo it and hold
            # this knob under capped-exponential backoff
            self._record_outcome(p, "reverted", observed)
            self.reverts_total += 1
            strikes = self._strikes.get(p.knob, 0) + 1
            self._strikes[p.knob] = strikes
            self._hold_until[p.knob] = s.t + min(
                self.hold_cap_s, self.hold_base_s * (2 ** (strikes - 1)))
            self._actuate(p.knob, p.old,
                          {"reverting": p.did,
                           "observed": observed, "baseline": p.baseline},
                          signal=p.signal, force=True, revert_of=p.did)

    def _record_outcome(self, p: _PendingEval, result: str,
                        observed) -> None:
        if self.tracer is None:
            return
        delta = (observed / p.baseline - 1.0
                 if isinstance(observed, (int, float))
                 and isinstance(p.baseline, (int, float)) and p.baseline
                 else None)
        record_decision(self.tracer, p.did, "outcome", knob=p.knob,
                        result=result, signal=p.signal,
                        **({"observed": observed}
                           if observed is not None else {}),
                        **({"baseline": p.baseline}
                           if p.baseline is not None else {}),
                        **({"delta_ratio": round(delta, 6)}
                           if delta is not None else {}))

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> Dict:
        """JSON-ready controller state — the live exporter's
        ``controller`` source on ``/metrics``."""
        now = self.clock()
        with self._lock:
            pending = len(self._pending)
        holds = {k: round(t - now, 3)
                 for k, t in self._hold_until.items() if t > now}
        return {
            "knobs": {**self.router.knob_values(),
                      "replicas": getattr(self.router, "active_count",
                                          None)},
            "active": getattr(self.router, "active_count", None),
            "standby": getattr(self.router, "standby_count", None),
            "min_replicas": self.min_replicas,
            "actuations_total": self.actuations_total,
            "reverts_total": self.reverts_total,
            "rollbacks_total": self.rollbacks_total,
            "rollout": ({"aborted": self._rollout_aborted,
                         "healthy_ticks": self._rollout_ticks,
                         "steps": list(self.rollout.steps)}
                        if self.rollout is not None else None),
            "blocked_total": self.blocked_total,
            "errors_total": self.errors_total,
            "pending_evals": pending,
            "holds_s": holds,
            "strikes": dict(self._strikes),
            "sense": (self.last_sense.as_dict()
                      if self.last_sense is not None else None),
        }

    def health_summary(self) -> Dict:
        """The compact ``/healthz`` summary (exporter ``health_sources``):
        what an operator wants at a glance — is the control plane alive,
        what is it holding, how often has it had to undo itself."""
        now = self.clock()
        return {
            "running": self._thread is not None,
            "active": getattr(self.router, "active_count", None),
            "standby": getattr(self.router, "standby_count", None),
            "actuations": self.actuations_total,
            "reverts": self.reverts_total,
            "held_knobs": sorted(k for k, t in self._hold_until.items()
                                 if t > now),
            "last_error": self.last_error,
        }
