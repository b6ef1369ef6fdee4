"""The port's multi-model fleet (``pdnlp_tpu_torch.serve.fleet``) on the
CPU — the twins of ``tests/test_fleet.py``: the degrade admission band,
shadow traffic that never leaks a candidate answer, exact shadow sampling,
the rollback drain, per-model metrics, the shadow / degrade / rollback
chain rules and the per-model Prometheus labels on fake engines; the
canary-rollout law through JAX's ``ServeController`` and the port's on the
same scripted fake fleet (the same actuations and outcomes,
``tests.test_torch_controller.twin``); and one real two-model pass — an
fp32 primary and an int8 candidate on weights converted from JAX's
engine, shadowing every request — held to JAX's fleet on the same weights.

Tolerance (the real pass): fp32 logits at 2e-4 (the flash tests'
end-to-end bound); int8 within ``tests/test_torch_serve_quant.py``'s
``BF16_BAND`` with equal argmax; shadow counts equal.
"""
import json
import time
import urllib.request

import numpy as np
import pytest

from pdnlp_tpu.serve import fleet as jfleet
from pdnlp_tpu_torch.obs.exporter import MetricsExporter
from pdnlp_tpu_torch.obs.request import chain_issues, validate_chains
from pdnlp_tpu_torch.obs.trace import Tracer
from pdnlp_tpu_torch.serve import (
    AdmissionControl, FleetRouter, LoadShedError, QueueFullError,
    ReplicaRouter, parse_fleet_spec,
)

from tests.test_elastic import FakeClock
from tests.test_torch_controller import NO_SCALE, FakeRouter, twin
from tests.test_torch_serve_quant import BF16_BAND
from tests.test_torch_serve_router import FakeEngine

ATOL = 2e-4


def _group(mid, tracer, n=1, engines=None, **kw):
    engines = engines or [FakeEngine() for _ in range(n)]
    kw.setdefault("buckets", (32, 64))
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("stall_timeout", 10.0)
    kw.setdefault("poll_interval", 0.02)
    kw.setdefault("max_queue", 256)
    return ReplicaRouter(engines, model_id=mid, tracer=tracer, **kw)


def _argmax_engine(label_idx, num_labels=6):
    """A FakeEngine whose every answer argmaxes at ``label_idx`` — so a
    leaked answer is detectable by its class."""
    e = FakeEngine(num_labels=num_labels)
    e.infer_ids = lambda id_lists, seq, rows=0, request_ids=None: \
        np.eye(num_labels, dtype=np.float32)[
            np.full(len(id_lists), label_idx)] * 7.0
    return e


# --------------------------------------------------------- admission band
def test_admission_ladder_walks_all_five_tiers_on_fake_clock():
    clk = FakeClock()
    adm = AdmissionControl(16, backpressure_at=8, degrade_at=10,
                           shed_at=12, shed_slack_ms=10.0, clock=clk)
    assert [adm.tier(n) for n in (0, 7, 8, 9, 10, 11, 12, 15, 16)] == [
        "healthy", "healthy", "backpressure", "backpressure", "degrade",
        "degrade", "shed", "shed", "reject"]
    adm4 = AdmissionControl(16, backpressure_at=8, shed_at=12, clock=clk)
    assert adm4.tier(10) == "backpressure"
    with pytest.raises(ValueError):  # band must sit between bp and shed
        AdmissionControl(16, backpressure_at=8, degrade_at=13, shed_at=12)
    with pytest.raises(ValueError):
        AdmissionControl(16, backpressure_at=8, degrade_at=4, shed_at=12)


def test_degrade_band_reroutes_to_cheap_with_hop_before_dispatch():
    """An overload burst against a tight primary ladder: degrade-band
    arrivals land on the cheap model (and get its answer), every degraded
    chain carries the degrade hop before its dispatch, and the primary
    never reaches its shed tier."""
    tracer = Tracer(enabled=True)
    prim = _group("prod", tracer, engines=[_argmax_engine(0)],
                  max_batch_size=100, max_wait_ms=25.0, max_queue=16,
                  backpressure_at=6, degrade_at=8, shed_at=12,
                  backpressure_wait_ms=1.0, shed_slack_ms=120_000.0)
    cheap = _group("tiny", tracer, engines=[_argmax_engine(3)],
                   max_batch_size=100, max_wait_ms=25.0)
    fleet = FleetRouter({"prod": prim, "tiny": cheap}, primary="prod",
                        cheap="tiny", tracer=tracer).start()
    assert fleet.wait_ready(10)
    try:
        futs = [fleet.submit_ids([2, 3, 4], deadline_ms=60_000)
                for _ in range(24)]
        outs = [int(np.argmax(f.result(timeout=10))) for f in futs]
    finally:
        fleet.stop()
    degraded = fleet.metrics.degraded_total.value
    assert degraded >= 1
    assert prim.metrics.shed_total.value == 0
    assert fleet.metrics.requests_total.value == 24
    assert outs.count(3) == degraded and outs.count(0) == 24 - degraded
    report = validate_chains(tracer.records())
    assert not report["incomplete"]
    assert report["degraded"] == degraded
    assert cheap.metrics.requests_total.value == degraded
    assert prim.metrics.requests_total.value == 24 - degraded


def test_degrade_without_cheap_falls_through_to_shed_loudly(capsys):
    tracer = Tracer(enabled=True)
    prim = _group("prod", tracer, max_batch_size=100,
                  max_wait_ms=60_000.0, max_queue=16, backpressure_at=2,
                  degrade_at=2, shed_at=12, backpressure_wait_ms=1.0,
                  shed_slack_ms=120_000.0)
    fleet = FleetRouter({"prod": prim}, primary="prod", tracer=tracer)
    prim._started = True  # white-box: queue mechanics only
    fleet.submit_ids([2, 3], deadline_ms=30_000)
    fleet.submit_ids([2, 3], deadline_ms=30_000)
    with pytest.raises(LoadShedError):
        fleet.submit_ids([2, 3], deadline_ms=30_000)
    assert fleet.metrics.degrade_fallthrough_total.value >= 1
    assert fleet.metrics.degraded_total.value == 0
    assert "NO cheap model" in capsys.readouterr().err


def test_fleet_rejects_at_hard_full_and_validates_spec():
    tracer = Tracer(enabled=False)
    prim = _group("prod", tracer, max_batch_size=100,
                  max_wait_ms=60_000.0, max_queue=2, backpressure_at=2,
                  shed_at=2, backpressure_wait_ms=0.5)
    fleet = FleetRouter({"prod": prim}, primary="prod", tracer=tracer)
    prim._started = True
    fleet.submit_ids([2, 3])
    fleet.submit_ids([2, 3])
    with pytest.raises(QueueFullError):
        fleet.submit_ids([2, 3])
    with pytest.raises(ValueError):
        FleetRouter({"prod": prim}, primary="missing")
    with pytest.raises(ValueError):
        FleetRouter({"prod": prim}, primary="prod", candidate="prod")
    with pytest.raises(ValueError):  # groups must carry their fleet key
        FleetRouter({"other": prim}, primary="other")
    with pytest.raises(ValueError):  # canary needs a candidate
        FleetRouter({"prod": prim}, primary="prod", canary_fraction=0.5)


def _spec_rows(specs):
    return [(s.model_id, s.checkpoint, s.role, s.dtype, s.replicas)
            for s in specs]


def test_parse_fleet_spec_roles_and_errors():
    """The same rows as JAX's parser for the same strings, and a refusal
    wherever JAX's refuses."""
    spec = ("prod=a.msgpack:bf16:2,next=b.msgpack::1:candidate,"
            "tiny=a.int8.msgpack:int8:1:cheap")
    specs = parse_fleet_spec(spec)
    assert [(s.model_id, s.role, s.dtype, s.replicas) for s in specs] == [
        ("prod", "primary", "bf16", 2), ("next", "candidate", "auto", 1),
        ("tiny", "cheap", "int8", 1)]
    assert _spec_rows(specs) == _spec_rows(jfleet.parse_fleet_spec(spec))
    from pdnlp_tpu_torch.serve.fleet import drafter_spec

    assert drafter_spec(specs).model_id == "tiny"
    assert drafter_spec(specs[:2]) is None
    for bad in ("a=x.msgpack,b=y.msgpack",          # second names no role
                "a=x.msgpack,b=y.msgpack:::primary",  # two primaries
                "a=x.msgpack,a=y.msgpack:::cheap",    # duplicate ids
                "a=x.msgpack:::boss",                 # unknown role
                "a=x.msgpack:fp8",                    # bad dtype
                "a=x:bf16:1:primary:extra", "", "noequals"):
        with pytest.raises(ValueError):
            parse_fleet_spec(bad)
        with pytest.raises(ValueError):
            jfleet.parse_fleet_spec(bad)


# ----------------------------------------------------------- shadow traffic
def test_shadow_never_leaks_the_candidate_answer():
    """Every request duplicated onto a candidate that answers a different
    class: every caller still gets the primary's class, and the
    mismatches land in the ShadowReport."""
    tracer = Tracer(enabled=True)
    prim = _group("prod", tracer, engines=[_argmax_engine(0)])
    cand = _group("cand", tracer, engines=[_argmax_engine(1)])
    fleet = FleetRouter({"prod": prim, "cand": cand}, primary="prod",
                        candidate="cand", shadow_fraction=1.0,
                        tracer=tracer).start()
    assert fleet.wait_ready(10)
    try:
        futs = [fleet.submit_ids([2, 3, 4], deadline_ms=30_000)
                for _ in range(10)]
        outs = [int(np.argmax(f.result(timeout=10))) for f in futs]
        deadline = time.monotonic() + 10
        while fleet.shadow_report.parity_checked < 10 \
                and time.monotonic() < deadline:
            fleet._harvest_once()
            time.sleep(0.02)
    finally:
        fleet.stop()
    assert outs == [0] * 10
    rep = fleet.shadow_report
    assert rep.parity_checked == 10 and rep.mismatches == 10
    assert fleet.metrics.shadows_total.value == 10
    report = validate_chains(tracer.records())
    assert not report["incomplete"]
    assert report["shadowed"] == 10
    assert report["checked"] == 20  # 10 callers + 10 duplicates


def test_shadow_fraction_sampling_is_exact():
    tracer = Tracer(enabled=False)
    prim = _group("prod", tracer, max_batch_size=100,
                  max_wait_ms=60_000.0)
    cand = _group("cand", tracer, max_batch_size=100,
                  max_wait_ms=60_000.0)
    fleet = FleetRouter({"prod": prim, "cand": cand}, primary="prod",
                        candidate="cand", shadow_fraction=0.25,
                        tracer=tracer)
    prim._started = True
    cand._started = True
    for _ in range(40):
        fleet.submit_ids([2, 3], deadline_ms=60_000)
    assert fleet.metrics.shadows_total.value == 10
    assert cand._pending == 10  # duplicates queue on the candidate only


# ------------------------------------------------------- canary rollout law
class FakeFleet(FakeRouter):
    """Fleet-shaped double: the FakeRouter tuning surface plus the
    rollout surface (``rollout_sense``, the traffic-fraction knobs, and a
    recorded rollback drain on fraction -> 0)."""

    def __init__(self, P, **kw):
        super().__init__(P, **kw)
        self.knobs["canary_fraction"] = 0.0
        self.knobs["shadow_fraction"] = 0.5
        self.sense = {"parity_checked": 50, "mismatch_rate": 0.0,
                      "shadow_failed": 0, "primary_p99_ms": 20.0,
                      "candidate_p99_ms": 21.0}
        self.rollback_drains = 0

    def apply_knob(self, name, value):
        if name == "canary_fraction":
            old = self.knobs["canary_fraction"]
            self.knobs["canary_fraction"] = value
            self.applied.append((name, value))
            if value == 0.0 and old > 0.0:
                self.rollback_drains += 1
            return
        super().apply_knob(name, value)

    def rollout_sense(self):
        return {"canary_fraction": self.knobs["canary_fraction"],
                "shadow_fraction": self.knobs["shadow_fraction"],
                **self.sense}


def _rollout_controller(P, plan=None, **sense):
    fleet = FakeFleet(P)
    fleet.sense.update(sense)
    clk = FakeClock()
    plan = plan or P.RolloutPlan(steps=(0.1, 0.5, 1.0),
                                 min_shadow_checked=5, patience=2,
                                 p99_factor=1.5, p99_floor_ms=5.0)
    c = P.ServeController(fleet, clock=clk, tracer=fleet.tracer,
                          rollout=plan, eval_window_s=5.0,
                          revert_margin=10.0, **NO_SCALE)
    assert c.step() is None  # prime the counter deltas
    clk.advance(1.0)
    return c, fleet, clk


def _tick(c, clk, dt=1.0):
    s = c.step()
    clk.advance(dt)
    return s


def _rollout_advances(P):
    c, fleet, clk = _rollout_controller(P)
    for _ in range(30):
        _tick(c, clk)
    advances = [v for k, v in fleet.applied if k == "canary_fraction"]
    assert advances == [0.1, 0.5, 1.0]
    assert fleet.knobs["canary_fraction"] == 1.0
    assert c.rollbacks_total == 0 and fleet.rollback_drains == 0
    return [(c, fleet)]


def test_rollout_advances_stepwise_on_clean_evidence():
    twin(_rollout_advances)


def _rollout_waits(P):
    c, fleet, clk = _rollout_controller(P, parity_checked=0)
    for _ in range(10):
        _tick(c, clk)
    assert fleet.knobs["canary_fraction"] == 0.0
    fleet.sense["parity_checked"] = 50
    for _ in range(5):
        _tick(c, clk)
    assert fleet.knobs["canary_fraction"] > 0.0
    return [(c, fleet)]


def test_rollout_waits_for_parity_evidence():
    twin(_rollout_waits)


def _rollout_parity_rollback(P):
    c, fleet, clk = _rollout_controller(P)
    for _ in range(12):
        _tick(c, clk)
    assert fleet.knobs["canary_fraction"] >= 0.5
    fleet.sense["mismatch_rate"] = 0.3
    _tick(c, clk)
    assert fleet.knobs["canary_fraction"] == 0.0
    assert c.rollbacks_total == 1 and fleet.rollback_drains == 1
    fleet.sense["mismatch_rate"] = 0.0
    for _ in range(10):
        _tick(c, clk)
    assert fleet.knobs["canary_fraction"] == 0.0
    assert c.rollbacks_total == 1
    c.stop()
    records = fleet.tracer.records()
    assert not P.decision.validate_decisions(records)["incomplete"]
    rollback = [ch for ch in P.decision.decision_chains(records).values()
                if any(a.get("attrs", {}).get("knob") == "canary_fraction"
                       and a.get("attrs", {}).get("new") == 0.0 for a in ch)]
    assert rollback and any(
        a.get("attrs", {}).get("revert_of") for ch in rollback for a in ch)
    return [(c, fleet)]


def test_rollout_rolls_back_on_parity_regression_and_stays_down():
    log = twin(_rollout_parity_rollback)
    rb = [a for a in log[0][0] if a["phase"] == "action"
          and a.get("cause_rollback")]
    assert len(rb) == 1 and rb[0]["cause_parity_bad"] is True


def _rollout_p99_rollback(P):
    c, fleet, clk = _rollout_controller(P)
    for _ in range(6):
        _tick(c, clk)
    assert fleet.knobs["canary_fraction"] > 0.0
    fleet.sense["candidate_p99_ms"] = 200.0  # 10x the primary
    _tick(c, clk)
    assert fleet.knobs["canary_fraction"] == 0.0
    assert c.rollbacks_total == 1
    return [(c, fleet)]


def test_rollout_rolls_back_on_candidate_p99_regression():
    twin(_rollout_p99_rollback)


def _stale_advance(P):
    c, fleet, clk = _rollout_controller(P)
    fleet.p99 = 20.0
    for _ in range(8):
        _tick(c, clk)
    assert fleet.knobs["canary_fraction"] == 0.5
    fleet.sense["mismatch_rate"] = 0.5
    fleet.p99 = 500.0
    _tick(c, clk)
    assert fleet.knobs["canary_fraction"] == 0.0
    for _ in range(10):
        _tick(c, clk)
    assert fleet.knobs["canary_fraction"] == 0.0
    assert c.rollbacks_total == 1
    fractions = [v for k, v in fleet.applied if k == "canary_fraction"]
    assert fractions[-1] == 0.0 and 0.0 not in fractions[:-1]
    return [(c, fleet)]


def test_stale_advance_eval_never_reinstalls_a_rolled_back_canary():
    log = twin(_stale_advance)
    results = [a["result"] for a in log[0][0] if a["phase"] == "outcome"]
    assert "superseded" in results and "reverted" not in results


# ------------------------------------------------------- rollback drain
def test_extract_queued_skips_inflight_hedged_duplicates():
    tracer = Tracer(enabled=False)
    g = _group("cand", tracer, n=2, max_batch_size=100,
               max_wait_ms=60_000.0)
    g._started = True
    r1 = g.submit_ids([2, 3], deadline_ms=60_000)
    r2 = g.submit_ids([2, 3], deadline_ms=60_000)
    rep0, rep1 = g._slots[0].replica, g._slots[1].replica
    for q in rep0.all_queues() + rep1.all_queues():
        q[:] = [r for r in q if r is not r1]
    r1.hedged = True
    rep0.inflight = [r1]
    rep1.queues[r1.bucket].append(r1)
    drained = g.extract_queued()
    assert drained == [r2]      # the hedge copy stayed with its pool
    assert g._pending == 1      # r1's slot still charged here, once


def test_canary_routed_counts_only_accepted_candidate_traffic():
    tracer = Tracer(enabled=False)
    prim = _group("prod", tracer, max_batch_size=100,
                  max_wait_ms=60_000.0)
    cand = _group("cand", tracer, max_batch_size=100,
                  max_wait_ms=60_000.0, max_queue=2, backpressure_at=2,
                  shed_at=2)
    fleet = FleetRouter({"prod": prim, "cand": cand}, primary="prod",
                        candidate="cand", canary_fraction=1.0,
                        tracer=tracer)
    prim._started = True
    cand._started = True
    fleet.submit_ids([2, 3])
    fleet.submit_ids([2, 3])
    with pytest.raises(QueueFullError):  # the candidate's door refused
        fleet.submit_ids([2, 3])
    assert fleet.metrics.canary_routed_total.value == 2  # not 3


def test_rollback_drain_rehomes_queued_candidate_requests():
    """Fraction -> 0 mid-rollout: everything queued on the candidate moves
    to the primary with a ``rollback`` hop and completes exactly once —
    with the primary's answer."""
    tracer = Tracer(enabled=True)
    prim = _group("prod", tracer, engines=[_argmax_engine(0)],
                  max_batch_size=100, max_wait_ms=60_000.0)
    cand = _group("cand", tracer, engines=[_argmax_engine(1)],
                  max_batch_size=100, max_wait_ms=60_000.0)
    fleet = FleetRouter({"prod": prim, "cand": cand}, primary="prod",
                        candidate="cand", canary_fraction=0.5,
                        tracer=tracer).start()
    assert fleet.wait_ready(10)
    try:
        futs = [fleet.submit_ids([2, 3], deadline_ms=60_000)
                for _ in range(10)]
        assert fleet.metrics.canary_routed_total.value == 5
        fleet.apply_knob("canary_fraction", 0.0)
        assert fleet.metrics.rollbacks_total.value == 1
        rolled = fleet.metrics.rolled_back_requests_total.value
        prim.apply_knob("max_wait_ms", 1.0)
        outs = [int(np.argmax(f.result(timeout=10))) for f in futs]
    finally:
        fleet.stop()
    assert rolled >= 1
    assert outs.count(1) == 5 - rolled
    assert outs.count(0) == 5 + rolled
    report = validate_chains(tracer.records())
    assert not report["incomplete"]
    assert report["rolled_back"] == rolled


# --------------------------------------------------- chain-integrity rules
def _hop(hop, t, **attrs):
    return {"name": "hop", "t0": t,
            "attrs": {"request_id": "r1-1", "hop": hop, **attrs}}


def test_chain_rules_shadow_must_terminate_shadow_side():
    good = [_hop("shadow", 0.0, of="r1-0"), _hop("admit", 1.0),
            _hop("dispatch", 2.0), _hop("complete", 3.0, shadow=True)]
    assert chain_issues(good) == []
    leak = [_hop("shadow", 0.0, of="r1-0"), _hop("admit", 1.0),
            _hop("dispatch", 2.0), _hop("complete", 3.0)]
    assert any("CALLER-VISIBLE" in i for i in chain_issues(leak))
    refused = [_hop("shadow", 0.0, of="r1-0"),
               _hop("rejected", 1.0, shadow=True)]
    assert chain_issues(refused) == []
    headless = [_hop("shadow", 0.0, of="r1-0"),
                _hop("dispatch", 1.0), _hop("complete", 2.0, shadow=True)]
    assert any("not followed by 'admit'" in i
               for i in chain_issues(headless))


def test_chain_rules_degrade_precedes_dispatch():
    good = [_hop("degrade", 0.0, from_model="prod", to_model="tiny"),
            _hop("admit", 1.0, model="tiny"), _hop("dispatch", 2.0),
            _hop("complete", 3.0)]
    assert chain_issues(good) == []
    late = [_hop("admit", 0.0), _hop("dispatch", 1.0),
            _hop("degrade", 2.0), _hop("complete", 3.0)]
    assert any("after a dispatch" in i for i in chain_issues(late))
    headless = [_hop("degrade", 0.0), _hop("dispatch", 1.0),
                _hop("complete", 2.0)]
    assert any("not followed by 'admit'" in i
               for i in chain_issues(headless))


def test_chain_rules_rollback_is_not_terminal_and_not_benign_tail():
    good = [_hop("admit", 0.0, model="cand"), _hop("rollback", 1.0),
            _hop("dispatch", 2.0), _hop("complete", 3.0)]
    assert chain_issues(good) == []
    orphan = [_hop("admit", 0.0), _hop("rollback", 1.0)]
    assert any("no terminal" in i for i in chain_issues(orphan))
    stray = [_hop("admit", 0.0), _hop("complete", 1.0),
             _hop("rollback", 2.0)]
    assert any("after the terminal" in i for i in chain_issues(stray))
    double = [_hop("admit", 0.0), _hop("rollback", 1.0),
              _hop("complete", 2.0), _hop("complete", 3.0)]
    assert any("2 terminal hops" in i for i in chain_issues(double))


# --------------------------------------------------- per-model export
def test_exporter_scrapes_per_model_labels():
    """The fleet snapshot's ``models`` block renders as a ``model`` label
    — one scrape tells primary from candidate — and the shadow parity
    counters and fleet counters ride the same scrape."""
    tracer = Tracer(enabled=False)
    prim = _group("prod", tracer, max_batch_size=100,
                  max_wait_ms=60_000.0)
    cand = _group("cand", tracer, max_batch_size=100,
                  max_wait_ms=60_000.0)
    fleet = FleetRouter({"prod": prim, "cand": cand}, primary="prod",
                        candidate="cand", shadow_fraction=1.0,
                        tracer=tracer)
    prim._started = True
    cand._started = True
    for _ in range(3):
        fleet.submit_ids([2, 3], deadline_ms=60_000)
    fleet.shadow_report.observe(True, 10.0, 12.0)
    fleet.shadow_report.observe(False, 10.0, 40.0)
    ex = MetricsExporter({"serve": fleet.snapshot},
                         health_sources={"fleet": fleet.health_summary},
                         port=0).start()
    try:
        base = f"http://127.0.0.1:{ex.port}"
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=5).read().decode()
        hz = json.loads(urllib.request.urlopen(base + "/healthz",
                                               timeout=5).read())
    finally:
        ex.stop(final_flight=False)
    assert 'pdnlp_serve_models_router_queue_depth{model="prod"} 3' in body
    assert 'pdnlp_serve_models_router_queue_depth{model="cand"} 3' in body
    assert 'model="cand"' in body and "request_latency_ms" in body
    assert ('pdnlp_serve_models_replicas_queue_depth'
            '{model="prod",replica="0"}') in body
    assert "pdnlp_serve_shadow_mismatches 1" in body
    assert "pdnlp_serve_fleet_shadows_total 3" in body
    assert hz["fleet"]["models"]["prod"]["role"] == "primary"
    assert hz["fleet"]["shadow"]["parity_checked"] == 2


# --------------------------------------------------- real engines (2-model)
TEXTS = ["天地人你我", "好坏大小上下来去", "高兴悲伤讨厌", "爱恨喜怒"]


def _run_fleet(fleet, submit, n=12):
    """Shadow every one of ``n`` requests; returns the callers' logits,
    the shadows' logits (by caller index) and the shadow report."""
    shadows = {}
    resolve = fleet._resolve
    index = {}

    def keep(p):
        if p.shadow._logits is not None:
            shadows[index[p.primary.rid]] = np.asarray(p.shadow._logits)
        resolve(p)

    fleet._resolve = keep
    fleet.start()
    assert fleet.wait_ready(300)
    try:
        futs = []
        for i in range(n):
            f = submit(fleet, TEXTS[i % len(TEXTS)])
            index[f.rid] = i
            futs.append(f)
        outs = [np.asarray(f.result(timeout=60)) for f in futs]
        deadline = time.monotonic() + 30
        while fleet.shadow_report.checked < n \
                and time.monotonic() < deadline:
            fleet._harvest_once()
            time.sleep(0.05)
    finally:
        fleet.stop()
    return np.stack(outs), shadows, fleet.shadow_report


def test_real_engine_two_model_fp32_int8_parity(tmp_path):
    """One real pass: an fp32 primary and an int8 candidate serving the
    same checkpoint (JAX's engine's weights, saved by JAX) behind the
    port's fleet and behind JAX's — full shadowing, the callers' logits
    and the shadows' held to JAX's, the same shadow counts, zero captures
    after warmup, every chain complete."""
    import jax

    from pdnlp_tpu.data.tokenizer import WordPieceTokenizer as JaxTok
    from pdnlp_tpu.serve import InferenceEngine as JaxEngine
    from pdnlp_tpu.serve import ReplicaRouter as JaxRouter
    from pdnlp_tpu.train import checkpoint as jckpt
    from pdnlp_tpu.utils.config import Args as JaxArgs
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from pdnlp_tpu_torch.serve import InferenceEngine
    from pdnlp_tpu_torch.utils.config import Args

    vocab = build_vocab(TEXTS, size=128)
    jargs = JaxArgs(model="bert-tiny", trace=True,
                    trace_dir=str(tmp_path / "jtrace"))
    jf32 = JaxEngine(jargs, tokenizer=JaxTok(vocab), mesh=None)
    ck = str(tmp_path / "fleet-cls.msgpack")
    jckpt.save(ck, jax.device_get(jf32.params))
    ji8 = JaxEngine(JaxArgs(model="bert-tiny", serve_dtype="int8"),
                    tokenizer=JaxTok(vocab), mesh=None)
    args = Args(model="bert-tiny", device="cpu", trace=True,
                trace_dir=str(tmp_path / "trace"))
    tok = WordPieceTokenizer(vocab)
    pf32 = InferenceEngine(args, tokenizer=tok)
    pi8 = InferenceEngine(args.replace(serve_dtype="int8"), tokenizer=tok)

    def build(Router, Fleet, e32, e8, tracer):
        def mk(mid, eng):
            return Router([eng], buckets=(32,), max_batch_size=2,
                          max_wait_ms=5.0, stall_timeout=10.0,
                          poll_interval=0.05, checkpoint_path=ck,
                          model_id=mid, tracer=tracer)

        return Fleet({"fp32": mk("fp32", e32), "int8": mk("int8", e8)},
                     primary="fp32", candidate="int8", shadow_fraction=1.0,
                     tracer=tracer)

    ours = build(ReplicaRouter, FleetRouter, pf32, pi8, pf32.tracer)
    ref = build(JaxRouter, jfleet.FleetRouter, jf32, ji8, jf32.tracer)
    got, got_sh, rep = _run_fleet(ours, lambda f, t: f.submit(
        t, deadline_ms=60_000))
    want, want_sh, jrep = _run_fleet(ref, lambda f, t: f.submit(
        t, deadline_ms=60_000))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert sorted(got_sh) == sorted(want_sh) == list(range(12))
    g8 = np.stack([got_sh[i] for i in range(12)])
    w8 = np.stack([want_sh[i] for i in range(12)])
    np.testing.assert_allclose(g8, w8, **BF16_BAND)
    np.testing.assert_array_equal(g8.argmax(-1), w8.argmax(-1))
    for k in ("checked", "matches", "mismatches", "shadow_failed",
              "voided"):
        assert getattr(rep, k) == getattr(jrep, k), k
    assert rep.parity_checked == 12 and rep.shadow_failed == 0
    assert rep.mismatches <= 1
    assert ours.retraces_post_warmup == 0
    report = validate_chains(pf32.tracer.records())
    assert not report["incomplete"]
    assert report["shadowed"] == 12


def test_cli_fleet_with_controller_answers_from_the_primary(tmp_path):
    """``serve.cli --fleet ... --shadow_fraction 1 --controller on`` on the
    CPU: every caller answer is the single-engine run's (the primary's),
    every request was shadowed, the snapshot carries the per-model
    ``models`` block, and the spans' decision chains are complete
    (``tools.trace decisions`` exits 0)."""
    import os
    import subprocess
    import sys

    from pdnlp_tpu_torch.data.tokenizer import build_vocab, save_vocab
    from pdnlp_tpu_torch.tools import trace as trace_cli

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    vpath = str(tmp_path / "vocab.txt")
    save_vocab(build_vocab(TEXTS, size=128), vpath)
    texts = TEXTS * 3
    common = [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--device",
              "cpu", "--model", "bert-tiny", "--vocab_path", vpath,
              "--max_wait_ms", "5", "--output_dir", str(tmp_path / "out")]
    env = {**os.environ, "PYTHONPATH": repo}

    def run(extra):
        return subprocess.run(common + extra, input="\n".join(texts) + "\n",
                              capture_output=True, text=True, timeout=240,
                              cwd=str(tmp_path), env=env)

    plain = run([])
    assert plain.returncode == 0, plain.stderr
    r = run(["--fleet", "prod=:auto:2,next=::1:candidate,tiny=:int8:1:cheap",
             "--shadow_fraction", "1", "--controller", "on",
             "--trace", "true", "--trace_dir", str(tmp_path / "trace"),
             "--metrics_path", str(tmp_path / "m.json")])
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines() == plain.stdout.splitlines()
    assert "[controller] feedback control plane on" in r.stderr
    snap = json.load(open(tmp_path / "m.json"))
    assert snap["fleet"]["requests_total"] == len(texts)
    assert snap["fleet"]["shadows_total"] == len(texts)
    assert set(snap["models"]) == {"prod", "next", "tiny"}
    assert all(m["router"]["failed_total"] == 0
               for m in snap["models"].values())
    trace = str(tmp_path / "trace" / "trace_proc0.jsonl")
    assert trace_cli.main(["decisions", trace]) == 0
    records = trace_cli.load_records(trace)
    assert validate_chains(records)["shadowed"] == len(texts)
    assert not validate_chains(records)["incomplete"]
