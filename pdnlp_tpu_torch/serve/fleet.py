"""Multi-model serving fleet: one front door, many models, safe rollouts
— the twin of ``pdnlp_tpu/serve/fleet.py`` (roles, traffic policy, hop
records and snapshot keys unchanged).

:class:`FleetRouter` composes the port's
:class:`~pdnlp_tpu_torch.serve.router.ReplicaRouter` into a fleet — one
``ReplicaRouter`` per **model id** (each with its own replicas, engines,
captured graphs, metrics and health loop), fronted by a traffic policy:

- **roles** — exactly one ``primary`` (the model callers' answers come
  from), at most one ``candidate`` (a checkpoint under validation: shadow
  target + canary target) and at most one ``cheap`` (an int8 or distilled
  variant that absorbs overload).  :func:`parse_fleet_spec` turns the
  ``--fleet`` CLI string (``id=checkpoint:dtype:replicas[:role]``) into
  :class:`ModelSpec` rows;

- **shadow traffic** (``shadow_fraction``) — a sampled fraction of
  primary-routed requests is DUPLICATED onto the candidate.  The caller
  always gets the primary's answer (the shadow is a separate request whose
  terminal hop is stamped ``shadow=True`` — the chain contract in
  :mod:`pdnlp_tpu_torch.obs.request` proves no candidate answer can leak);
  a harvester thread joins each (primary, shadow) pair off the hot path
  and accumulates argmax parity + latency deltas in a
  :class:`ShadowReport` — the evidence the rollout law advances on;

- **canary rollout** (``canary_fraction``) — a fraction of CALLER traffic
  is routed to the candidate for real.  The fraction is a knob: the
  control plane (:class:`~pdnlp_tpu_torch.serve.controller.ServeController`
  with a :class:`RolloutPlan`) steps it up only while shadow parity and
  candidate p99 hold, and **auto-rolls-back** to 0 through its
  ``_actuate`` choke point when either regresses.  Setting the fraction
  to 0 from a live rollout drains every request still queued on the
  candidate back to the primary with a ``rollback`` hop — zero accepted
  work lost (the groups share buckets and pack mode, so the drained
  request meets a shape the primary's engines captured at warmup);

- **degrade tier** — the primary pool's admission ladder gains the
  ``degrade`` band (:class:`~pdnlp_tpu_torch.serve.batcher.AdmissionControl`
  ``degrade_at``, between backpressure and shed): an arrival meeting that
  band is re-routed to the cheap model instead of walking into the shed
  pass, with a ``degrade`` hop recorded BEFORE the cheap pool's admit.
  With no cheap model registered the band falls through to the shed tier
  (loudly, once).

Every traffic-fraction write comes through :meth:`FleetRouter.apply_knob`
— the fleet's ONE setter — and controller-side writes come through the
controller's ``_actuate``.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from pdnlp_tpu_torch.obs.request import record_hop
from pdnlp_tpu_torch.serve.batcher import LoadShedError, QueueFullError, _Request
from pdnlp_tpu_torch.serve.metrics import FleetMetrics, _save_json
from pdnlp_tpu_torch.serve.router import ReplicaRouter
from pdnlp_tpu_torch.utils.metrics import Histogram

#: the fleet roles a model spec may declare
ROLES = ("primary", "candidate", "cheap")

#: serving dtypes a spec may pin (``auto`` follows ``args.dtype``)
SPEC_DTYPES = ("auto", "bf16", "int8")


class ModelSpec:
    """One ``--fleet`` entry: model id -> checkpoint / dtype / replicas /
    role."""

    __slots__ = ("model_id", "checkpoint", "dtype", "replicas", "role")

    def __init__(self, model_id: str, checkpoint: Optional[str], *,
                 dtype: str = "auto", replicas: int = 1,
                 role: str = "primary"):
        if dtype not in SPEC_DTYPES:
            raise ValueError(f"fleet spec {model_id!r}: dtype must be one "
                             f"of {SPEC_DTYPES}, got {dtype!r}")
        if role not in ROLES:
            raise ValueError(f"fleet spec {model_id!r}: role must be one "
                             f"of {ROLES}, got {role!r}")
        if int(replicas) < 1:
            raise ValueError(f"fleet spec {model_id!r}: replicas must be "
                             f">= 1, got {replicas}")
        self.model_id = model_id
        self.checkpoint = checkpoint or None
        self.dtype = dtype
        self.replicas = int(replicas)
        self.role = role

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ModelSpec({self.model_id}={self.checkpoint}:{self.dtype}"
                f":{self.replicas}:{self.role})")


def parse_fleet_spec(spec: str) -> List[ModelSpec]:
    """``--fleet`` string -> validated :class:`ModelSpec` rows.

    Format (comma-separated entries)::

        model_id=checkpoint[:dtype[:replicas[:role]]]

    e.g. ``prod=out/dp-cls.msgpack:bf16:2,next=out/new.msgpack:bf16:1:
    candidate,tiny=out/dp-cls.int8.msgpack:int8:1:cheap``.  The FIRST
    entry defaults to role ``primary``; later entries must name a role.
    Exactly one primary; at most one candidate; at most one cheap."""
    specs: List[ModelSpec] = []
    for i, entry in enumerate(s.strip() for s in spec.split(",")):
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"fleet spec entry {entry!r}: expected "
                             "model_id=checkpoint[:dtype[:replicas[:role]]]")
        model_id, rest = entry.split("=", 1)
        parts = rest.split(":")
        ckpt = parts[0] or None
        dtype = parts[1] if len(parts) > 1 and parts[1] else "auto"
        replicas = int(parts[2]) if len(parts) > 2 and parts[2] else 1
        role = parts[3] if len(parts) > 3 and parts[3] else (
            "primary" if i == 0 else None)
        if role is None:
            raise ValueError(
                f"fleet spec entry {entry!r}: every entry after the first "
                f"must name a role ({'/'.join(ROLES)})")
        if len(parts) > 4:
            raise ValueError(f"fleet spec entry {entry!r}: too many "
                             "':'-separated fields")
        specs.append(ModelSpec(model_id.strip(), ckpt, dtype=dtype,
                               replicas=replicas, role=role))
    if not specs:
        raise ValueError("empty fleet spec")
    ids = [s.model_id for s in specs]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate model ids in fleet spec: {ids}")
    for role, lo, hi in (("primary", 1, 1), ("candidate", 0, 1),
                         ("cheap", 0, 1)):
        n = sum(1 for s in specs if s.role == role)
        if not (lo <= n <= hi):
            raise ValueError(f"fleet spec needs {lo}..{hi} {role!r} "
                             f"model(s), got {n}")
    return specs


def parse_speculate_spec(spec: str) -> ModelSpec:
    """``--speculate`` string -> the drafter's :class:`ModelSpec`.

    Accepts a bare checkpoint path (a distilled same-architecture
    checkpoint: the model id defaults to ``draft`` and ``build_decode_pool``
    keeps the primary's architecture) or a fleet-style entry
    ``model_id=checkpoint[:dtype]`` whose model id names the drafter's
    ARCHITECTURE (a :mod:`pdnlp_tpu_torch.models.config` registry key, e.g.
    ``bert-small``).  The returned spec
    is pinned to role ``cheap`` — the fleet role whose job description
    (int8/distilled, fast, vocabulary-compatible with the primary) is
    exactly what a draft model needs — with 1 replica: a drafter rides
    its primary engine's replica, it is never a pool of its own."""
    entry = spec.strip()
    if not entry:
        raise ValueError("empty --speculate spec")
    if "=" not in entry:
        return ModelSpec("draft", entry, role="cheap")
    model_id, rest = entry.split("=", 1)
    parts = rest.split(":")
    if len(parts) > 2:
        raise ValueError(f"speculate spec {entry!r}: expected "
                         "model_id=checkpoint[:dtype]")
    dtype = parts[1] if len(parts) > 1 and parts[1] else "auto"
    return ModelSpec(model_id.strip(), parts[0] or None, dtype=dtype,
                     role="cheap")


def drafter_spec(specs: Sequence[ModelSpec]) -> Optional[ModelSpec]:
    """The fleet's speculative-decoding drafter: its ``cheap`` entry.

    The same distilled/int8 variant that absorbs classification overload
    through the degrade band becomes the draft model in generative
    serving (draft-k / verify-1 — :mod:`pdnlp_tpu_torch.serve.decode`); one
    spec, two jobs.  ``None`` when the fleet declares no cheap model."""
    for s in specs:
        if s.role == "cheap":
            return s
    return None


class ShadowReport:
    """Accumulated shadow-pair evidence: per-request argmax parity and
    latency deltas between the primary's answer and the candidate's.
    Fed by the fleet's harvester thread (off the hot path); read by the
    rollout law and the fleet's snapshot."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.checked = 0          # pairs resolved with a primary answer
        self.matches = 0
        self.mismatches = 0
        self.shadow_failed = 0    # shadow errored/timed out (primary fine)
        self.voided = 0           # primary errored/timed out: nothing to judge
        self.primary_ms = Histogram()
        self.shadow_ms = Histogram()
        self.delta_ms = Histogram()   # shadow latency - primary latency

    def observe(self, match: bool, primary_ms: Optional[float],
                shadow_ms: Optional[float]) -> None:
        with self._lock:
            self.checked += 1
            if match:
                self.matches += 1
            else:
                self.mismatches += 1
            if primary_ms is not None:
                self.primary_ms.observe(primary_ms)
            if shadow_ms is not None:
                self.shadow_ms.observe(shadow_ms)
            if primary_ms is not None and shadow_ms is not None:
                self.delta_ms.observe(shadow_ms - primary_ms)

    def observe_failed(self, primary_ms: Optional[float] = None) -> None:
        with self._lock:
            self.checked += 1
            self.shadow_failed += 1
            if primary_ms is not None:
                self.primary_ms.observe(primary_ms)

    def observe_void(self) -> None:
        with self._lock:
            self.voided += 1

    @property
    def parity_checked(self) -> int:
        """Pairs where BOTH sides produced an answer to compare."""
        return self.matches + self.mismatches

    @property
    def mismatch_rate(self) -> float:
        return self.mismatches / max(1, self.parity_checked)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "checked": self.checked,
                "matches": self.matches,
                "mismatches": self.mismatches,
                "mismatch_rate": round(self.mismatch_rate, 6),
                "shadow_failed": self.shadow_failed,
                "voided": self.voided,
                "primary_ms": self.primary_ms.snapshot(),
                "shadow_ms": self.shadow_ms.snapshot(),
                "delta_ms": self.delta_ms.snapshot(),
            }


class RolloutPlan:
    """Config for the controller's canary-rollout law: the fraction steps,
    the parity/latency evidence each advance needs, and the regression
    bounds that trigger auto-rollback."""

    __slots__ = ("steps", "min_shadow_checked", "parity_tolerance",
                 "p99_factor", "p99_floor_ms", "patience")

    def __init__(self, steps: Sequence[float] = (0.05, 0.25, 0.5, 1.0), *,
                 min_shadow_checked: int = 20,
                 parity_tolerance: float = 0.02,
                 p99_factor: float = 1.5,
                 p99_floor_ms: float = 10.0,
                 patience: int = 3):
        steps = tuple(float(s) for s in steps)
        if not steps or any(not (0.0 < s <= 1.0) for s in steps) \
                or list(steps) != sorted(set(steps)):
            raise ValueError(f"rollout steps must be strictly ascending "
                             f"fractions in (0, 1], got {steps}")
        self.steps = steps
        #: shadow pairs that must have been parity-checked before the
        #: FIRST advance (and before a mismatch rate is trusted at all)
        self.min_shadow_checked = int(min_shadow_checked)
        #: mismatch rate above this = parity regression -> rollback
        self.parity_tolerance = float(parity_tolerance)
        #: candidate p99 above ``factor x primary p99 + floor`` = latency
        #: regression -> rollback (the floor keeps ms-scale jitter on a
        #: fast pool from reading as a regression)
        self.p99_factor = float(p99_factor)
        self.p99_floor_ms = float(p99_floor_ms)
        #: consecutive healthy control ticks between advances
        self.patience = int(patience)


class _ShadowPair:
    __slots__ = ("primary", "shadow", "t0")

    def __init__(self, primary: _Request, shadow: _Request, t0: float):
        self.primary = primary
        self.shadow = shadow
        self.t0 = t0


class FleetRouter:
    """The fleet front door (module docstring has the full story).

    ``groups`` maps model id -> a **started-able** :class:`ReplicaRouter`
    whose ``model_id`` matches its key (so every hop either pool records
    is model-labelled).  The fleet quacks like a router where the control
    plane is concerned — ``knob_values``/``apply_knob``/
    ``control_snapshot``/``active_count``/``deactivate_replica``/... all
    delegate to the PRIMARY group, plus the fleet-owned traffic knobs
    (``shadow_fraction``, ``canary_fraction``) — so one
    :class:`ServeController` drives both the serving knobs and the
    rollout.
    """

    #: the fleet-owned traffic knobs (group knobs delegate to the primary)
    FLEET_KNOBS = ("shadow_fraction", "canary_fraction")

    def __init__(self, groups: Dict[str, ReplicaRouter], *,
                 primary: str,
                 candidate: Optional[str] = None,
                 cheap: Optional[str] = None,
                 shadow_fraction: float = 0.0,
                 canary_fraction: float = 0.0,
                 shadow_timeout_s: float = 60.0,
                 harvest_interval_s: float = 0.02,
                 metrics: Optional[FleetMetrics] = None,
                 tracer=None,
                 clock: Callable[[], float] = time.monotonic):
        if primary not in groups:
            raise ValueError(f"primary model {primary!r} not in groups "
                             f"{sorted(groups)}")
        for role, mid in (("candidate", candidate), ("cheap", cheap)):
            if mid is not None and mid not in groups:
                raise ValueError(f"{role} model {mid!r} not in groups "
                                 f"{sorted(groups)}")
        if candidate is not None and candidate == primary:
            raise ValueError("candidate must be a different model than "
                             "the primary")
        for mid, g in groups.items():
            if g.model_id != mid:
                raise ValueError(
                    f"group {mid!r} was built with model_id="
                    f"{g.model_id!r} — every pool must stamp its fleet "
                    "key on its hops (ReplicaRouter(model_id=...))")
        self.groups = dict(groups)
        self.primary = primary
        self.candidate = candidate
        self.cheap = cheap
        if not (0.0 <= float(shadow_fraction) <= 1.0):
            raise ValueError(f"shadow_fraction must be in [0, 1], got "
                             f"{shadow_fraction}")
        if not (0.0 <= float(canary_fraction) <= 1.0):
            raise ValueError(f"canary_fraction must be in [0, 1], got "
                             f"{canary_fraction}")
        if canary_fraction and candidate is None:
            raise ValueError("canary_fraction needs a candidate model")
        self.shadow_fraction = float(shadow_fraction)
        self.canary_fraction = float(canary_fraction)
        self.shadow_timeout_s = float(shadow_timeout_s)
        self.harvest_interval_s = float(harvest_interval_s)
        self.metrics = metrics or FleetMetrics()
        self.shadow_report = ShadowReport()
        self.tracer = tracer if tracer is not None \
            else groups[primary].tracer
        self.clock = clock
        # deterministic fraction accumulators (exactly `fraction` of
        # traffic, no RNG) — one small lock for both, taken per submit
        self._traffic_lock = threading.Lock()
        self._shadow_acc = 0.0
        self._canary_acc = 0.0
        self._pairs_lock = threading.Lock()
        self._pairs: List[_ShadowPair] = []
        self._harvester: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._warned_no_cheap = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetRouter":
        for g in self.groups.values():
            g.start()
        if self._harvester is None:
            self._stop_evt.clear()
            self._harvester = threading.Thread(
                target=self._harvest_loop, daemon=True,
                name="pdnlp-fleet-shadow")
            self._harvester.start()
        return self

    def wait_ready(self, timeout: float = 120.0) -> bool:
        return all(g.wait_ready(timeout) for g in self.groups.values())

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        for g in self.groups.values():
            g.stop(drain=drain, timeout=timeout)
        self._stop_evt.set()
        if self._harvester is not None:
            self._harvester.join(timeout=5)
            self._harvester = None
        # every request is completed by now (a stopped pool fails its
        # leftovers loudly): resolve what resolved, void the rest
        self._harvest_once(final=True)

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- submit
    def submit(self, text: str,
               deadline_ms: Optional[float] = None) -> _Request:
        prim = self.groups[self.primary]
        ids = prim.tokenizer.encode_ids(text, prim.buckets[-1])
        return self.submit_ids(ids, deadline_ms=deadline_ms)

    def submit_ids(self, ids: List[int],
                   deadline_ms: Optional[float] = None) -> _Request:
        """The fleet front door: canary split -> degrade-band re-route ->
        group admission; a sampled fraction of primary-routed admissions
        grows a shadow duplicate on the candidate.  Raises exactly what
        :meth:`ReplicaRouter.submit_ids` raises."""
        self.metrics.requests_total.inc()
        target = self._pick_model()
        group = self.groups[target]
        req = group.make_request(ids, deadline_ms=deadline_ms)
        tier = group.admission_tier()
        if tier == "degrade" and target != self.cheap:
            if self.cheap is None:
                # the band is configured but nothing sits behind it: fall
                # through to the group's own ladder, where the degrade
                # band IS an early shed tier — loudly, once, because a
                # fleet shedding where it meant to degrade is an operator
                # error worth a page
                if not self._warned_no_cheap:
                    self._warned_no_cheap = True
                    print("WARNING: fleet degrade band reached with NO "
                          "cheap model registered — falling through to "
                          "the shed tier (register a cheap/int8 model to "
                          "absorb overload instead of dropping it)",
                          file=sys.stderr)
                self.metrics.degrade_fallthrough_total.inc()
            else:
                # re-route to the cheap model: the degrade hop lands
                # BEFORE the cheap pool's admit, so the chain reads
                # degrade -> admit -> dispatch -> complete and the
                # degrade-precedes-dispatch contract holds by construction
                record_hop(self.tracer, req.rid, "degrade",
                           from_model=target, to_model=self.cheap,
                           tier=tier)
                self.metrics.degraded_total.inc()
                return self.groups[self.cheap].submit_request(
                    req, deadline_ms=deadline_ms)
        fut = group.submit_request(req, deadline_ms=deadline_ms)
        if target == self.candidate:
            # counted AFTER admission: this is "caller traffic whose
            # answer IS the candidate's" — a canary pick the candidate's
            # door refused never became candidate-answered traffic
            self.metrics.canary_routed_total.inc()
        elif target == self.primary:
            self._maybe_shadow(req, deadline_ms)
        return fut

    def _pick_model(self) -> str:
        """Canary split: exactly ``canary_fraction`` of caller traffic to
        the candidate (deterministic accumulator, no RNG), the rest to
        the primary."""
        if self.candidate is None:
            return self.primary
        with self._traffic_lock:
            if self.canary_fraction <= 0.0:
                return self.primary
            self._canary_acc += self.canary_fraction
            if self._canary_acc >= 1.0:
                self._canary_acc -= 1.0
                return self.candidate
        return self.primary

    # -------------------------------------------------------------- shadow
    def _maybe_shadow(self, primary_req: _Request,
                      deadline_ms: Optional[float]) -> None:
        if self.candidate is None:
            return
        with self._traffic_lock:
            if self.shadow_fraction <= 0.0:
                return
            self._shadow_acc += self.shadow_fraction
            if self._shadow_acc < 1.0:
                return
            self._shadow_acc -= 1.0
        group = self.groups[self.candidate]
        sreq = group.make_request(list(primary_req.ids),
                                  deadline_ms=deadline_ms)
        sreq.shadow_of = primary_req.rid
        # the duplicate's chain OPENS with the shadow hop (before the
        # candidate pool's admit): first-hop shadow IS the chain-contract
        # marker that this request must never terminate caller-visibly
        record_hop(self.tracer, sreq.rid, "shadow", of=primary_req.rid,
                   model=self.candidate)
        record_hop(self.tracer, primary_req.rid, "shadow",
                   to_model=self.candidate, shadow_rid=sreq.rid)
        try:
            group.submit_request(sreq, deadline_ms=deadline_ms)
        except (LoadShedError, QueueFullError, RuntimeError):
            # the candidate refused (overloaded/stopped): the caller is
            # untouched — shadow traffic is strictly best-effort
            self.metrics.shadow_dropped_total.inc()
            return
        self.metrics.shadows_total.inc()
        with self._pairs_lock:
            self._pairs.append(_ShadowPair(primary_req, sreq,
                                           self.clock()))

    def _harvest_loop(self) -> None:
        while not self._stop_evt.wait(self.harvest_interval_s):
            self._harvest_once()

    def _harvest_once(self, final: bool = False) -> None:
        """Join resolved (primary, shadow) pairs into the report — runs on
        the harvester thread (and once at stop), never on a caller's."""
        now = self.clock()
        with self._pairs_lock:
            pairs, self._pairs = self._pairs, []
        keep: List[_ShadowPair] = []
        for p in pairs:
            if p.primary.done() and p.shadow.done():
                self._resolve(p)
            elif final or now - p.t0 > self.shadow_timeout_s:
                # one side never resolved: a wedged candidate must not
                # hold parity evidence hostage forever
                if p.primary.done() and p.primary._error is None:
                    self.shadow_report.observe_failed(
                        self._latency_ms(p.primary))
                else:
                    self.shadow_report.observe_void()
            else:
                keep.append(p)
        if keep:
            with self._pairs_lock:
                self._pairs = keep + self._pairs

    @staticmethod
    def _latency_ms(r: _Request) -> Optional[float]:
        # born/completed_at are BOTH time.monotonic stamps (`submitted`
        # may live in a group's injectable clock domain — mixing the two
        # would corrupt the parity evidence under any non-default clock)
        if r.completed_at is None:
            return None
        return max(0.0, (r.completed_at - r.born) * 1e3)

    def _resolve(self, p: _ShadowPair) -> None:
        if p.primary._error is not None:
            self.shadow_report.observe_void()
            return
        plat = self._latency_ms(p.primary)
        if p.shadow._error is not None or p.shadow._logits is None:
            self.shadow_report.observe_failed(plat)
            return
        match = int(np.argmax(p.primary._logits)) \
            == int(np.argmax(p.shadow._logits))
        self.shadow_report.observe(match, plat, self._latency_ms(p.shadow))

    # ------------------------------------------------------ tuning surface
    def apply_knob(self, name: str, value) -> None:
        """The fleet's ONE knob setter (controller-side writes come
        through the controller's ``_actuate``).  Fleet-owned knobs are handled here; everything else
        delegates to the PRIMARY group's setter.  Dropping
        ``canary_fraction`` to 0 from a live rollout IS the rollback: the
        candidate's queued requests drain back to the primary."""
        if name == "shadow_fraction":
            v = float(value)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"shadow_fraction must be in [0, 1], "
                                 f"got {value}")
            with self._traffic_lock:
                self.shadow_fraction = v
        elif name == "canary_fraction":
            if self.candidate is None:
                raise ValueError("canary_fraction needs a candidate model "
                                 "in the fleet")
            v = float(value)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"canary_fraction must be in [0, 1], "
                                 f"got {value}")
            with self._traffic_lock:
                old, self.canary_fraction = self.canary_fraction, v
            if v == 0.0 and old > 0.0:
                self._rollback_drain()
        else:
            self.groups[self.primary].apply_knob(name, value)

    def knob_values(self) -> Dict:
        return {**self.groups[self.primary].knob_values(),
                "shadow_fraction": self.shadow_fraction,
                "canary_fraction": self.canary_fraction}

    def _rollback_drain(self) -> None:
        """Canary rollback: re-home every request still QUEUED on the
        candidate onto the primary (``rollback`` hop -> adopt — the
        admission ladder is deliberately bypassed, accepted work must
        never become a rejection), and retire queued shadow duplicates
        (they have no caller; their terminal stays on the shadow side).
        In-flight candidate batches finish where they are."""
        cand = self.groups[self.candidate]
        prim = self.groups[self.primary]
        drained = cand.extract_queued()
        self.metrics.rollbacks_total.inc()
        for r in drained:
            if r.shadow_of is not None:
                if r._complete(None, LoadShedError("canary rolled back")):
                    record_hop(self.tracer, r.rid, "shed", shadow=True,
                               model=self.candidate, rollback=True)
                continue
            record_hop(self.tracer, r.rid, "rollback",
                       from_model=self.candidate, to_model=self.primary)
            self.metrics.rolled_back_requests_total.inc()
            try:
                prim.adopt(r)
            except Exception as e:  # noqa: BLE001 — a primary with no
                # replica left cannot adopt: fail the caller loudly
                # rather than strand the future forever
                if r._complete(None, e):
                    record_hop(self.tracer, r.rid, "failed",
                               model=self.primary,
                               error=type(e).__name__)

    # --------------------------------------------- controller quack surface
    @property
    def max_batch_size(self) -> int:
        return self.groups[self.primary].max_batch_size

    @property
    def active_count(self) -> int:
        return self.groups[self.primary].active_count

    @property
    def standby_count(self) -> int:
        return self.groups[self.primary].standby_count

    def deactivate_replica(self, index: Optional[int] = None) -> int:
        return self.groups[self.primary].deactivate_replica(index)

    def activate_replica(self, index: Optional[int] = None) -> int:
        return self.groups[self.primary].activate_replica(index)

    def engine(self, index: int = 0):
        return self.groups[self.primary].engine(index)

    @property
    def retraces_post_warmup(self) -> int:
        return sum(g.retraces_post_warmup for g in self.groups.values())

    @property
    def states(self) -> Dict[str, Dict[int, str]]:
        return {mid: g.states for mid, g in self.groups.items()}

    def control_snapshot(self) -> Dict:
        """The controller's per-tick sense input: the PRIMARY group's
        lightweight snapshot (its knobs/queue/p99 drive the serving laws)
        with the fleet knobs folded in."""
        snap = self.groups[self.primary].control_snapshot()
        snap["knobs"] = self.knob_values()
        return snap

    def rollout_sense(self) -> Dict:
        """The rollout law's evidence: the live fraction, shadow parity,
        and primary-vs-candidate p99 (None without a candidate)."""
        rep = self.shadow_report
        out = {
            "canary_fraction": self.canary_fraction,
            "shadow_fraction": self.shadow_fraction,
            "parity_checked": rep.parity_checked,
            "mismatch_rate": rep.mismatch_rate,
            "shadow_failed": rep.shadow_failed,
            "primary_p99_ms": self.groups[self.primary]
            .metrics.request_latency_ms.percentile(99),
            "candidate_p99_ms": None,
        }
        if self.candidate is not None:
            out["candidate_p99_ms"] = self.groups[self.candidate] \
                .metrics.request_latency_ms.percentile(99)
        return out

    # ----------------------------------------------------------- reporting
    def snapshot(self) -> Dict:
        """Fleet + per-model metrics, JSON-ready.  The ``models`` block is
        keyed by model id — the exporter renders it as a ``model`` label
        on every per-model gauge, so one Prometheus scrape distinguishes
        primary/candidate/cheap tiers."""
        return {
            "fleet": {
                **self.metrics.snapshot(),
                "roles": {"primary": self.primary,
                          "candidate": self.candidate,
                          "cheap": self.cheap},
                "knobs": {"shadow_fraction": self.shadow_fraction,
                          "canary_fraction": self.canary_fraction},
            },
            "shadow": self.shadow_report.snapshot(),
            "models": {mid: g.snapshot()
                       for mid, g in self.groups.items()},
        }

    def save_snapshot(self, path: str) -> None:
        _save_json(self.snapshot(), path)

    def health_summary(self) -> Dict:
        """The compact ``/healthz`` block: per-model role/active state,
        the live traffic split and the shadow verdict at a glance."""
        rep = self.shadow_report
        return {
            "models": {mid: {
                "role": ("primary" if mid == self.primary else
                         "candidate" if mid == self.candidate else
                         "cheap" if mid == self.cheap else "unknown"),
                "active": g.active_count,
                "standby": g.standby_count,
            } for mid, g in self.groups.items()},
            "canary_fraction": self.canary_fraction,
            "shadow_fraction": self.shadow_fraction,
            "shadow": {"parity_checked": rep.parity_checked,
                       "mismatch_rate": round(rep.mismatch_rate, 4),
                       "shadow_failed": rep.shadow_failed},
            "degraded": self.metrics.degraded_total.value,
            "rollbacks": self.metrics.rollbacks_total.value,
        }
