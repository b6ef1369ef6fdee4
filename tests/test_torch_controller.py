"""The port's serving controller (``pdnlp_tpu_torch.serve.controller``) held
against the JAX package's on the CPU — the twins of
``tests/test_controller.py``.

Every control-law case runs the same scripted fake router, on the same
injected clock, through JAX's ``ServeController`` and the port's
(:func:`twin`): the JAX test's own assertions hold under both, and the
decision records the two controllers write — every ``action``
(``knob``, ``old`` -> ``new``, the cause metrics) and every ``outcome``
(``kept`` / ``reverted`` / ``superseded`` / ``shutdown``) — are equal
record for record, and so are the router writes.  Decision ids differ by
package, so only their presence is compared.  The warm-standby cycle,
the knob surface, the decision-chain CLI round trip, the exporter wiring
and the replay schedules run on the port's real router and tools; the
replay schedules are also held to JAX's, value for value.  The
``control_snapshot()`` key trees of the four router shapes are held to
JAX's.
"""
import json
import urllib.request
from types import SimpleNamespace

import pytest

from pdnlp_tpu.obs import decision as jdecision
from pdnlp_tpu.obs.trace import Tracer as JaxTracer
from pdnlp_tpu.serve import controller as jcontroller
from pdnlp_tpu.serve import fleet as jfleet
from pdnlp_tpu.serve import replay as jreplay
from pdnlp_tpu_torch.obs import decision as pdecision
from pdnlp_tpu_torch.obs.decision import (
    decision_chains, decision_issues, validate_decisions,
)
from pdnlp_tpu_torch.obs.trace import Tracer
from pdnlp_tpu_torch.serve import controller as pcontroller
from pdnlp_tpu_torch.serve import fleet as pfleet
from pdnlp_tpu_torch.serve import replay as preplay

from tests.test_elastic import FakeClock
from tests.test_torch_serve_router import FakeEngine, _router

#: the two packages' control planes, side by side
JAX = SimpleNamespace(name="jax", ServeController=jcontroller.ServeController,
                      RolloutPlan=jfleet.RolloutPlan, Tracer=JaxTracer,
                      decision=jdecision)
PORT = SimpleNamespace(name="port",
                       ServeController=pcontroller.ServeController,
                       RolloutPlan=pfleet.RolloutPlan, Tracer=Tracer,
                       decision=pdecision)
PKGS = (JAX, PORT)

#: decision-record attrs that carry a package-minted decision id
_ID_KEYS = ("decision_id", "revert_of", "cause_reverting")


def decision_log(tracer):
    """The decision records' attrs, in order, ids replaced by presence."""
    out = []
    for rec in tracer.records():
        if rec.get("name") != "decision":
            continue
        attrs = dict(rec.get("attrs") or {})
        for k in _ID_KEYS:
            if k in attrs:
                attrs[k] = True
        out.append(attrs)
    return out


def twin(scenario, *args, **kw):
    """``scenario(P, ...)`` -> ``[(controller, router), ...]`` under JAX's
    control plane and the port's; each controller is stopped (pending
    evaluations resolve), then both packages' decision records and router
    writes must be equal.  Returns the port's log."""
    logs = []
    for P in PKGS:
        pairs = scenario(P, *args, **kw)
        log = []
        for c, r in pairs:
            c.stop()
            log.append((decision_log(r.tracer), list(r.applied)))
        logs.append(log)
    assert logs[1] == logs[0]
    assert any(d for d, _ in logs[1]) or all(not a for _, a in logs[1])
    return logs[1]


class FakeRouter:
    """Router-shaped test double exposing exactly the tuning surface the
    controller consumes: snapshot counters/gauges the test scripts, and
    recorded actuations (``tests/test_controller.py:FakeRouter``, with
    the tracer of package ``P``)."""

    def __init__(self, P, active=3, standby=0):
        self.counters = {"requests": 0, "deadline": 0, "shed": 0,
                         "rejected": 0, "backpressure": 0}
        self.p99 = None
        self.active = active
        self.standby = standby
        self.queue_depth = 0.0
        self.max_batch_size = 8
        self.knobs = {"hedge_ms": 100.0, "max_wait_ms": 5.0,
                      "backpressure_at": 32, "shed_at": 48,
                      "shed_slack_ms": 10.0}
        self.applied = []
        self.tracer = P.Tracer(enabled=True)

    def knob_values(self):
        return dict(self.knobs)

    def apply_knob(self, name, value):
        if name not in self.knobs:
            raise KeyError(name)
        self.knobs[name] = value
        self.applied.append((name, value))

    def deactivate_replica(self, index=None):
        if self.active <= 1:
            raise RuntimeError("last dispatchable replica")
        self.active -= 1
        self.standby += 1
        self.applied.append(("scale_down", self.active))
        return 0

    def activate_replica(self, index=None):
        if self.standby <= 0:
            raise RuntimeError("no standby")
        self.active += 1
        self.standby -= 1
        self.applied.append(("scale_up", self.active))
        return 0

    @property
    def active_count(self):
        return self.active

    @property
    def standby_count(self):
        return self.standby

    def snapshot(self):
        c = self.counters
        return {
            "router": {
                "requests_total": c["requests"],
                "deadline_expired_total": c["deadline"],
                "queue_depth": self.queue_depth,
                "admission": {"backpressure_waits": c["backpressure"],
                              "shed": c["shed"],
                              "rejected": c["rejected"]},
                "request_latency_ms": {"p99": self.p99},
            },
            "active": self.active,
            "standby": self.standby,
            "knobs": self.knob_values(),
        }


def _controller(P, router=None, clk=None, **kw):
    router = router or FakeRouter(P)
    clk = clk or FakeClock()
    kw.setdefault("eval_window_s", 5.0)
    kw.setdefault("hold_base_s", 30.0)
    kw.setdefault("revert_margin", 0.2)
    kw.setdefault("scale_patience", 3)
    c = P.ServeController(router, clock=clk, tracer=router.tracer, **kw)
    assert c.step() is None  # first tick only primes the counter deltas
    clk.advance(1.0)
    return c, router, clk


def _tick(c, clk, dt=1.0):
    s = c.step()
    clk.advance(dt)
    return s


#: neutralizes the scaling law in knob-focused tests
NO_SCALE = {"scale_patience": 10 ** 6}


# ------------------------------------------------------------- hysteresis
def _hysteresis(P):
    c, r, clk = _controller(P, **NO_SCALE)
    r.p99 = 51.0  # target hedge = 102ms vs current 100ms: inside the band
    _tick(c, clk)
    assert [a for a in r.applied if a[0] == "hedge_ms"] == []
    r.p99 = 100.0  # target 200ms: 100% change, outside the band
    _tick(c, clk)
    assert ("hedge_ms", 200.0) in r.applied
    applied_before = len(r.applied)
    for p99 in (95.0, 108.0, 99.0, 104.0):
        clk.advance(60.0)  # cooldown long expired — only the band holds
        r.p99 = p99
        _tick(c, clk)
    assert len(r.applied) == applied_before
    return [(c, r)]


def test_hysteresis_prevents_flapping():
    twin(_hysteresis)


# ---------------------------------------------------------------- cooldown
def _cooldown(P):
    c, r, clk = _controller(P, **NO_SCALE)
    r.p99 = 100.0
    _tick(c, clk)
    assert ("hedge_ms", 200.0) in r.applied
    r.p99 = 60.0
    _tick(c, clk)
    assert ("hedge_ms", 120.0) not in r.applied
    assert c.blocked_total >= 1
    clk.advance(10.0)
    _tick(c, clk)
    assert ("hedge_ms", 120.0) in r.applied
    return [(c, r)]


def test_cooldown_respected():
    twin(_cooldown)


# ------------------------------------------------------------------- clamp
def _clamp(P):
    c, r, clk = _controller(P, **NO_SCALE)
    spec = c.specs["max_wait_ms"]
    assert c.inject("max_wait_ms", 10_000.0)
    assert r.knobs["max_wait_ms"] == spec.hi
    clk.advance(1.0)
    assert c.inject("max_wait_ms", -5.0)
    assert r.knobs["max_wait_ms"] == spec.lo
    c2, r2, clk2 = _controller(P, FakeRouter(P, active=1))
    assert not c2.inject("replicas", 0)
    assert r2.active == 1
    return [(c, r), (c2, r2)]


def test_clamp_bounds_hold():
    twin(_clamp)


# -------------------------------------------------------- evaluate / revert
def _bad_actuation(P):
    c, r, clk = _controller(P, manage_hedge=False, **NO_SCALE)
    r.p99 = 100.0
    _tick(c, clk)
    assert c.inject("hedge_ms", 900.0)
    assert r.knobs["hedge_ms"] == 900.0
    r.p99 = 500.0
    clk.advance(c.eval_window_s + 1.0)
    _tick(c, clk)
    assert r.knobs["hedge_ms"] == 100.0
    assert c.reverts_total == 1
    assert c._strikes["hedge_ms"] == 1
    blocked0 = c.blocked_total
    assert not c._actuate("hedge_ms", 400.0, {"note": "law"})
    assert c.blocked_total == blocked0 + 1
    assert r.knobs["hedge_ms"] == 100.0
    assert "hedge_ms" in c.snapshot()["holds_s"]
    clk.advance(c.eval_window_s + 1.0)
    _tick(c, clk)
    assert r.knobs["hedge_ms"] == 100.0
    assert c.reverts_total == 1
    clk.advance(c.hold_base_s + 1.0)
    assert c.inject("hedge_ms", 900.0)
    r.p99 = 700.0
    clk.advance(c.eval_window_s + 1.0)
    _tick(c, clk)
    assert c._strikes["hedge_ms"] == 2
    hold = c.snapshot()["holds_s"]["hedge_ms"]
    assert c.hold_base_s < hold <= 2 * c.hold_base_s
    return [(c, r)]


def test_bad_actuation_auto_reverts_and_enters_backoff_hold():
    twin(_bad_actuation)


def _revert_none(P):
    r = FakeRouter(P)
    r.knobs["hedge_ms"] = None
    c, r, clk = _controller(P, router=r, manage_hedge=False, **NO_SCALE)
    r.p99 = 100.0
    _tick(c, clk)
    assert c.inject("hedge_ms", 500.0)
    assert r.knobs["hedge_ms"] == 500.0
    r.p99 = 400.0
    clk.advance(c.eval_window_s + 1.0)
    _tick(c, clk)
    assert r.knobs["hedge_ms"] is None
    assert c.reverts_total == 1 and c.errors_total == 0
    c.stop()
    assert not P.decision.validate_decisions(r.tracer.records())["incomplete"]
    return [(c, r)]


def test_revert_restores_a_none_valued_knob():
    twin(_revert_none)


def _scale_up_kept(P):
    c, r, clk = _controller(P, FakeRouter(P, active=2, standby=1),
                            manage_hedge=False, **NO_SCALE)
    r.p99 = 50.0
    _tick(c, clk)
    assert c.inject("replicas", 3)
    assert r.active == 3
    r.p99 = 500.0
    clk.advance(c.eval_window_s + 1.0)
    _tick(c, clk)
    assert r.active == 3
    assert c.reverts_total == 0
    clk.advance(c.specs["replicas"].cooldown_s + 1.0)
    assert c.inject("replicas", 2)
    assert r.active == 2
    r.p99 = 2000.0
    clk.advance(c.eval_window_s + 1.0)
    _tick(c, clk)
    assert r.active == 3 and c.reverts_total == 1
    return [(c, r)]


def test_scale_up_is_never_auto_reverted():
    twin(_scale_up_kept)


def _kept_resets(P):
    c, r, clk = _controller(P, **NO_SCALE)
    r.p99 = 100.0
    _tick(c, clk)
    c._strikes["hedge_ms"] = 1
    assert c.inject("hedge_ms", 250.0)
    r.p99 = 90.0
    clk.advance(c.eval_window_s + 1.0)
    _tick(c, clk)
    assert r.knobs["hedge_ms"] == 250.0
    assert c.reverts_total == 0
    assert c._strikes["hedge_ms"] == 0
    return [(c, r)]


def test_kept_outcome_resets_strikes():
    twin(_kept_resets)


# ------------------------------------------------------------- scaling law
def _scale_down_patience(P):
    c, r, clk = _controller(P, scale_patience=3, util_low=0.2,
                            util_high=0.7)
    for i in range(2):
        _tick(c, clk)
        assert not any(a[0] == "scale_down" for a in r.applied), i
    _tick(c, clk)
    assert ("scale_down", 2) in r.applied
    assert r.standby == 1
    r.queue_depth = 3 * 2 * r.max_batch_size
    clk.advance(c.specs["replicas"].cooldown_s)
    for _ in range(4):
        _tick(c, clk)
        if ("scale_up", 3) in r.applied:
            break
    assert ("scale_up", 3) in r.applied
    assert r.standby == 0
    return [(c, r)]


def test_scale_down_needs_patience_then_reactivates_on_load():
    log = twin(_scale_down_patience)
    knobs = [(a["knob"], a["old"], a["new"]) for a in log[0][0]
             if a["phase"] == "action"]
    assert ("replicas", 3, 2) in knobs and ("replicas", 2, 3) in knobs


def _scale_floor(P):
    c, r, clk = _controller(P, min_replicas=2, scale_patience=1)
    for _ in range(6):
        clk.advance(c.specs["replicas"].cooldown_s)
        _tick(c, clk)
    assert r.active == 2
    assert r.applied.count(("scale_down", 2)) == 1
    return [(c, r)]


def test_scale_down_never_below_floor():
    twin(_scale_floor)


# ------------------------------------------- real router: standby cycle
def test_router_standby_cycle_requeues_and_rewarms():
    """The port's real ``ReplicaRouter``: a drain moves the queued request
    to the peer without charging a retry, standby replicas take no
    dispatch, the last dispatchable replica refuses to drain, and a
    reactivation goes back through warming."""
    clk = FakeClock()
    r, engines = _router(n=2, start=False, clock=clk, max_batch_size=100,
                         max_wait_ms=60_000.0)
    r._started = True  # white-box: queue mechanics, no workers
    for s in r._slots:
        s.replica.state = "healthy"
    req = r.submit_ids([2, 3], deadline_ms=60_000)
    rep = next(s.replica for s in r._slots
               if any(req in q for q in s.replica.queues.values()))
    idx = rep.index
    other = r._slots[1 - idx].replica
    assert r.deactivate_replica() == 1 - idx
    r.activate_replica(1 - idx)
    other.state = "healthy"  # white-box: no worker to run the re-warm
    assert r.deactivate_replica(idx) == idx
    assert any(req in q for q in other.queues.values())
    assert req.retries == 0
    assert rep.state == "standby"
    assert r.metrics.scale_downs_total.value == 2
    assert r.metrics.requeued_total.value == 1
    assert r._slots[idx].metrics.requeued_out.value == 1
    assert r._slots[1 - idx].metrics.requeued_in.value == 1
    req2 = r.submit_ids([2, 3], deadline_ms=60_000)
    assert any(req2 in q for q in other.queues.values())
    with pytest.raises(RuntimeError, match="last dispatchable"):
        r.deactivate_replica()
    r.activate_replica(idx)
    assert rep.state == "warming"
    assert r.metrics.scale_ups_total.value == 2


def test_router_standby_reactivation_is_warmup_gated_zero_retraces():
    """Full-thread cycle on the port's router: drain -> standby (worker
    parked, beating) -> activate -> the worker re-runs every bucket probe
    before dispatch, from the warm engine's cache, so the pool's
    post-warmup capture count stays zero; nothing queued is lost."""
    r, engines = _router(n=2)
    try:
        idx = r.deactivate_replica()
        probes_before = len(engines[idx].calls)
        assert r.states[idx] == "standby"
        assert r.active_count == 1 and r.standby_count == 1
        futs = [r.submit_ids([2, 3], deadline_ms=10_000) for _ in range(6)]
        assert all(f.result(timeout=10) is not None for f in futs)
        r.activate_replica(idx)
        assert r.wait_ready(10)
        assert r.states[idx] == "healthy"
        probes = engines[idx].calls[probes_before:]
        assert [p for p in probes if p[0] == 1][: len(r.buckets)] == \
            [(1, b) for b in r.buckets]
        assert r.retraces_post_warmup == 0
        assert r.submit_ids([2, 3], deadline_ms=10_000)\
                .result(timeout=10) is not None
        assert r.metrics.ejections_total.value == 0
        assert r.metrics.reintegrations_total.value == 0
        assert r.metrics.failed_total.value == 0
    finally:
        r.stop(drain=False)


def test_apply_knob_validates_tier_ordering():
    r, _ = _router(n=2, start=False)
    assert r.knob_values()["max_wait_ms"] == 2.0
    r.apply_knob("max_wait_ms", 9.0)
    assert r.knob_values()["max_wait_ms"] == 9.0
    with pytest.raises(ValueError, match="tier ordering"):
        r.apply_knob("backpressure_at", r.admission.max_queue + 1)
    with pytest.raises(KeyError):
        r.apply_knob("poll_interval", 1.0)


# -------------------------------------------------------- decision chains
def _chains(P):
    c, r, clk = _controller(P)
    r.p99 = 100.0
    _tick(c, clk)
    assert c.inject("hedge_ms", 900.0)
    r.p99 = 500.0
    clk.advance(c.eval_window_s + 1.0)
    _tick(c, clk)
    c.stop()
    return [(c, r)]


def test_decision_chains_validate_and_cli_roundtrip(tmp_path, capsys):
    """The chains validate, ``tools.trace decisions`` exits 0 on them and
    1 on a stripped copy, and its table is ``format_decisions``' — the
    same text JAX's prints for the same records."""
    from pdnlp_tpu_torch.obs.export import write_jsonl
    from pdnlp_tpu_torch.tools import trace as trace_cli

    twin(_chains)
    c, r = _chains(PORT)[0]
    records = r.tracer.records()
    report = validate_decisions(records)
    assert report["checked"] >= 2 and not report["incomplete"]
    assert report["reverted"] >= 1
    for chain in decision_chains(records).values():
        assert decision_issues(chain) == []
    assert pdecision.format_decisions(records) == \
        jdecision.format_decisions(records)
    path = tmp_path / "trace_proc0.jsonl"
    write_jsonl(records, str(path))
    capsys.readouterr()
    assert trace_cli.main(["decisions", str(path)]) == 0
    out = capsys.readouterr().out
    assert out.strip() == pdecision.format_decisions(
        trace_cli.load_records(str(path))).strip()
    assert "complete" in out
    stripped = [rec for rec in records
                if (rec.get("attrs") or {}).get("phase") != "outcome"]
    bad = tmp_path / "bad.jsonl"
    write_jsonl(stripped, str(bad))
    assert trace_cli.main(["decisions", str(bad)]) == 1
    assert "INCOMPLETE" in capsys.readouterr().out


def _stop_resolves(P):
    c, r, clk = _controller(P, manage_hedge=False, **NO_SCALE)
    r.p99 = 100.0
    _tick(c, clk)
    assert c.inject("max_wait_ms", 40.0)
    assert c.snapshot()["pending_evals"] == 1
    c.stop()
    assert c.snapshot()["pending_evals"] == 0
    assert not P.decision.validate_decisions(
        r.tracer.records())["incomplete"]
    return [(c, r)]


def test_controller_stop_resolves_pending_evaluations():
    twin(_stop_resolves)


# ------------------------------------------------------------- exporter
def test_controller_state_on_metrics_and_healthz():
    """Controller state is a ``/metrics`` source and its summary rides
    ``/healthz`` on the port's exporter; a raising summary reports itself
    instead of killing the probe.  The snapshot's keys are JAX's."""
    from pdnlp_tpu_torch.obs.exporter import MetricsExporter

    c, r, clk = _controller(PORT, manage_hedge=False, **NO_SCALE)
    r.p99 = 100.0
    _tick(c, clk)
    assert c.inject("max_wait_ms", 40.0)
    jc, jr, jclk = _controller(JAX, manage_hedge=False, **NO_SCALE)
    jr.p99 = 100.0
    _tick(jc, jclk)
    assert jc.inject("max_wait_ms", 40.0)
    assert c.snapshot() == jc.snapshot()
    assert c.health_summary() == jc.health_summary()
    exp = MetricsExporter({"controller": c.snapshot}, port=0,
                          health_sources={"controller": c.health_summary})
    exp.start()
    try:
        base = f"http://127.0.0.1:{exp.port}"
        body = urllib.request.urlopen(base + "/metrics").read().decode()
        assert "pdnlp_controller_actuations_total 1" in body
        assert "pdnlp_controller_knobs_max_wait_ms 40" in body
        health = json.loads(
            urllib.request.urlopen(base + "/healthz").read().decode())
        assert health["controller"]["actuations"] == 1
        assert health["controller"]["active"] == 3
        assert "held_knobs" in health["controller"]
        exp.health_sources["boom"] = lambda: 1 / 0
        health = json.loads(
            urllib.request.urlopen(base + "/healthz").read().decode())
        assert health["status"] == "ok"
        assert "ZeroDivisionError" in health["boom"]["error"]
    finally:
        exp.stop()
        c.stop()
        jc.stop()


# ------------------------------------------------------------------ replay
def _sched(xs):
    return [x.as_tuple() for x in xs]


def test_replay_same_seed_and_trace_identical_schedule():
    a = preplay.synth_arrivals(200, 150.0, seed=11)
    b = preplay.synth_arrivals(200, 150.0, seed=11)
    assert _sched(a) == _sched(b)
    assert _sched(preplay.synth_arrivals(200, 150.0, seed=12)) != _sched(a)
    for shape in ("steady", "diurnal", "flash"):
        s1 = preplay.shape_arrivals(a, shape, speed=5.0)
        s2 = preplay.shape_arrivals(b, shape, speed=5.0)
        assert _sched(s1) == _sched(s2)
        assert len(s1) == len(a)
        assert [x.tokens for x in s1] == [x.tokens for x in a]
        assert s1[-1].t < a[-1].t
    steady = preplay.shape_arrivals(a, "steady", speed=5.0)
    flash = preplay.shape_arrivals(a, "flash", speed=5.0)
    assert flash[-1].t < steady[-1].t
    assert preplay.ids_for(a[3], 3) == preplay.ids_for(b[3], 3)
    assert len(preplay.ids_for(a[3], 3)) == a[3].tokens

    tr = Tracer(enabled=True)
    r, _ = _router(n=2, tracer=tr)
    try:
        futs = [r.submit_ids([2] * k, deadline_ms=4000) for k in (4, 9, 6)]
        for f in futs:
            f.result(timeout=10)
    finally:
        r.stop(drain=False)
    got1 = preplay.arrivals_from_trace(tr.records())
    got2 = preplay.arrivals_from_trace(tr.records())
    assert _sched(got1) == _sched(got2)
    assert [x.tokens for x in got1] == [4, 9, 6]
    assert all(x.deadline_ms == 4000.0 for x in got1)
    assert got1[0].t == 0.0
    # JAX's reader rebuilds the same schedule from the port's records
    assert _sched(jreplay.arrivals_from_trace(tr.records())) == _sched(got1)


@pytest.mark.parametrize("shape", ["steady", "diurnal", "flash"])
def test_replay_schedules_equal_jax(shape):
    """Same seed, same schedule as JAX's, exactly: the Poisson arrivals,
    each warp of them and the replayed ids."""
    kw = dict(lengths=(6, 10, 16, 22, 28, 40), deadline_ms=2500.0, seed=7)
    a = preplay.synth_arrivals(300, 80.0, **kw)
    ja = jreplay.synth_arrivals(300, 80.0, **kw)
    assert _sched(a) == _sched(ja)
    for speed in (1.0, 3.5):
        got = preplay.shape_arrivals(a, shape, speed=speed)
        want = jreplay.shape_arrivals(ja, shape, speed=speed)
        assert _sched(got) == _sched(want)
    assert [preplay.ids_for(x, i) for i, x in enumerate(a)] == \
        [jreplay.ids_for(x, i) for i, x in enumerate(ja)]


def test_replay_drives_a_schedule_and_accounts_outcomes():
    """``replay`` over the port's router on an injected clock and sleep:
    every arrival submitted at its offset, every answer accounted."""
    sched = preplay.shape_arrivals(
        preplay.synth_arrivals(24, 400.0, seed=3), "flash", speed=2.0)
    r, _ = _router(n=2)
    try:
        rep = preplay.replay(r.submit_ids, sched, result_timeout=10.0)
    finally:
        r.stop(drain=False)
    d = rep.as_dict()
    assert d["submitted"] == 24 and d["ok"] == 24 and d["lost"] == 0
    assert d["tokens_ok"] == sum(a.tokens for a in sched)
    assert set(d) == set(jreplay.ReplayReport().as_dict())


# ----------------------------------------- control_snapshot key trees
def key_tree(obj):
    """A snapshot's key structure: nested dict keys, leaves None."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    return None


def test_replica_router_control_snapshot_keys_match_jax():
    from tests.test_router import FakeEngine as JaxFakeEngine
    from pdnlp_tpu.serve import ReplicaRouter as JaxRouter
    from pdnlp_tpu_torch.serve import ReplicaRouter

    kw = dict(buckets=(32, 64), max_batch_size=4, max_wait_ms=2.0)
    ours = ReplicaRouter([FakeEngine(), FakeEngine()], **kw)
    ref = JaxRouter([JaxFakeEngine(), JaxFakeEngine()], **kw)
    assert key_tree(ours.control_snapshot()) == \
        key_tree(ref.control_snapshot())
    assert ours.knob_values() == ref.knob_values()


def test_fleet_control_snapshot_keys_match_jax():
    from tests.test_router import FakeEngine as JaxFakeEngine
    from pdnlp_tpu.serve import ReplicaRouter as JaxRouter
    from pdnlp_tpu_torch.serve import FleetRouter, ReplicaRouter

    kw = dict(buckets=(32, 64), max_batch_size=4, max_wait_ms=2.0)

    def fleet(Router, Engine, Fleet):
        groups = {m: Router([Engine()], model_id=m, **kw)
                  for m in ("prod", "cand")}
        return Fleet(groups, primary="prod", candidate="cand",
                     shadow_fraction=0.5)

    ours = fleet(ReplicaRouter, FakeEngine, FleetRouter)
    ref = fleet(JaxRouter, JaxFakeEngine, jfleet.FleetRouter)
    assert key_tree(ours.control_snapshot()) == \
        key_tree(ref.control_snapshot())
    assert ours.rollout_sense().keys() == ref.rollout_sense().keys()
    assert key_tree(ours.snapshot()["fleet"]) == \
        key_tree(ref.snapshot()["fleet"])
    assert key_tree(ours.health_summary()) == key_tree(ref.health_summary())
