"""The port's replica router (``pdnlp_tpu_torch.serve.router``): the twins
of ``tests/test_router.py`` and of the router cases of
``tests/test_telemetry.py`` — tiered admission against JAX's
``AdmissionControl`` over the same depth sweep and injected clock, least-
loaded dispatch, eject/requeue with deadline budgets, crash and stall
ejection with zero lost requests, warmup-gated relaunch, rolling swap with
rollback on a corrupt manifest, hedging first-wins, hop chains that pass
``validate_chains`` — on fake engines, plus real bert-tiny engines on the
CPU: answers equal to the JAX engine's (fp32 logits at atol 2e-4, the
flash tests' end-to-end bound), zero recaptures after warmup and after a
relaunch, and chunked prefill across replicas.

Every ``result``, ``wait_ready`` and ``stop`` is bounded, so no case can
hang the suite.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.obs.request import chains, validate_chains
from pdnlp_tpu_torch.obs.trace import Tracer
from pdnlp_tpu_torch.serve import (
    AdmissionControl, DeadlineExceeded, LoadShedError, QueueFullError,
    ReplicaRouter, ServeMetrics,
)
from pdnlp_tpu_torch.serve.batcher import _Request
from pdnlp_tpu_torch.train import checkpoint as ckpt

from tests.test_elastic import FakeClock

ATOL = 2e-4


class FakeEngine:
    """Engine-shaped double: instant host-side forwards, recorded calls,
    real manifest-verified checkpoint loads (a corrupt file raises the
    real ``CorruptCheckpointError``)."""

    def __init__(self, num_labels=6, latency=0.0):
        self.args = SimpleNamespace(max_seq_len=128)
        self.cfg = SimpleNamespace(max_position=512)
        self.device = torch.device("cpu")
        self.tokenizer = SimpleNamespace(
            cls_id=2, sep_id=3, pad_id=0,
            encode_ids=lambda text, n: [2] * min(max(len(text), 2), n))
        self.metrics = ServeMetrics()
        self.tracer = Tracer(enabled=False)
        self.span_attrs = {}
        self.checkpoint_path = None
        self.num_labels = num_labels
        self.latency = latency
        self.calls = []

    def pad_rows(self, n):
        return int(n)

    def infer_ids(self, id_lists, seq, rows=0, request_ids=None):
        if self.latency:
            time.sleep(self.latency)
        self.calls.append((len(id_lists), int(seq)))
        return np.full((len(id_lists), self.num_labels), float(seq),
                       np.float32)

    def warmup_packed(self, seq_len, rows, max_segments):
        self.calls.append(("warm_packed", int(seq_len), int(rows)))

    def infer_packed(self, arrays, segments=0, request_ids=None):
        rows, seq = arrays["input_ids"].shape
        M = arrays["cls_positions"].shape[1]
        if self.latency:
            time.sleep(self.latency)
        self.calls.append(("packed", int(segments), int(seq)))
        return np.full((rows, M, self.num_labels), float(seq), np.float32)

    def load_checkpoint(self, path):
        ckpt.load_raw(path)  # real manifest verification
        self.checkpoint_path = path


def _router(n=2, *, start=True, clock=None, engines=None, **kw):
    engines = engines or [FakeEngine() for _ in range(n)]
    kw.setdefault("buckets", (32, 64))
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("stall_timeout", 1.0)
    kw.setdefault("poll_interval", 0.02)
    if clock is not None:
        kw["clock"] = clock
    r = ReplicaRouter(engines, **kw)
    if start:
        r.start()
        assert r.wait_ready(10)
    return r, engines


def _wait_state(r, index, state, timeout=10.0):
    deadline = time.monotonic() + timeout
    while r.states[index] != state and time.monotonic() < deadline:
        time.sleep(0.01)
    assert r.states[index] == state


# ----------------------------------------------------------- admission tiers
def test_admission_tiers_and_shed_order_match_jax():
    """The same depth sweep and injected clock through both packages'
    ``AdmissionControl``: identical tiers at every depth (with and without
    the degrade band), identical shed victims, identical bounded waits."""
    from pdnlp_tpu.serve.batcher import AdmissionControl as JaxAdmission
    from pdnlp_tpu.serve.batcher import _Request as JaxRequest

    clk = FakeClock()
    for kw in ({"backpressure_at": 8, "shed_at": 12},
               {"backpressure_at": 4, "shed_at": 12, "degrade_at": 9},
               {}):
        ours = AdmissionControl(16, shed_slack_ms=50.0, clock=clk, **kw)
        ref = JaxAdmission(16, shed_slack_ms=50.0, clock=clk, **kw)
        assert [ours.tier(d) for d in range(20)] == \
            [ref.tier(d) for d in range(20)]
    deadlines = [clk() + 10.0, clk() + 0.030, clk() + 0.010, None,
                 clk() + 0.049, clk() - 0.001]
    ours_q = [_Request([2, 3], 32, d) for d in deadlines]
    ref_q = [JaxRequest([2, 3], 32, d) for d in deadlines]
    for r in ours_q + ref_q:
        r.submitted = clk()
    ours = AdmissionControl(8, shed_slack_ms=50.0, clock=clk)
    ref = JaxAdmission(8, shed_slack_ms=50.0, clock=clk)
    got = [ours_q.index(v) for v in ours.shed_victims(ours_q[1:],
                                                      arriving=ours_q[0])]
    want = [ref_q.index(v) for v in ref.shed_victims(ref_q[1:],
                                                     arriving=ref_q[0])]
    assert got == want == [5, 2, 1, 4]
    assert [ours.backpressure_wait_sec(r) for r in ours_q] == \
        [ref.backpressure_wait_sec(r) for r in ref_q]
    with pytest.raises(ValueError):
        AdmissionControl(8, backpressure_at=7, shed_at=3)
    with pytest.raises(ValueError):
        AdmissionControl(16, backpressure_at=8, shed_at=12, degrade_at=4)


def test_router_walks_all_tiers_healthy_to_reject():
    r, _ = _router(n=2, max_batch_size=100, max_wait_ms=60_000.0,
                   max_queue=8, backpressure_at=4, shed_at=6,
                   backpressure_wait_ms=5.0, shed_slack_ms=20.0)
    try:
        for _ in range(4):
            r.submit_ids([2, 3], deadline_ms=60_000)
        assert r.metrics.backpressure_waits_total.value == 0
        r.submit_ids([2, 3], deadline_ms=60_000)  # depth 4: bounded wait
        assert r.metrics.backpressure_waits_total.value == 1
        r.submit_ids([2, 3], deadline_ms=60_000)
        r.submit_ids([2, 3], deadline_ms=60_000)  # depth 6: shed tier
        with pytest.raises(LoadShedError):
            r.submit_ids([2, 3], deadline_ms=5.0)
        assert r.metrics.shed_total.value == 1
        r.submit_ids([2, 3], deadline_ms=60_000)  # depth 7
        with pytest.raises(QueueFullError):      # depth 8: hard reject
            r.submit_ids([2, 3], deadline_ms=60_000)
        assert r.metrics.rejected_total.value == 1
    finally:
        r.stop(drain=False, timeout=5)


def test_shed_evicts_queued_lowest_slack_not_just_arrivals():
    clk = FakeClock()
    r, _ = _router(n=1, start=False, clock=clk, max_batch_size=100,
                   max_wait_ms=60_000.0, max_queue=8, backpressure_at=2,
                   shed_at=2, shed_slack_ms=50.0)
    r._started = True  # white-box: no workers, queue mechanics only
    doomed = r.submit_ids([2, 3], deadline_ms=40.0)
    roomy = r.submit_ids([2, 3], deadline_ms=60_000)
    fresh = r.submit_ids([2, 3], deadline_ms=60_000)
    with pytest.raises(LoadShedError):
        doomed.result(timeout=0)
    assert not roomy.done() and not fresh.done()
    assert r.metrics.shed_total.value == 1


def test_least_loaded_dispatch_balances_queues():
    r, _ = _router(n=3, start=False, clock=FakeClock(), max_batch_size=100,
                   max_wait_ms=60_000.0, max_queue=100)
    r._started = True
    for _ in range(9):
        r.submit_ids([2, 3], deadline_ms=60_000)
    assert [s.replica.load() for s in r._slots] == [3, 3, 3]


def test_eject_requeues_within_deadline_budget():
    clk = FakeClock()
    r, _ = _router(n=2, start=False, clock=clk, max_batch_size=100,
                   max_wait_ms=60_000.0, max_queue=100, max_retries=1)
    r._started = True
    alive = r.submit_ids([2, 3], deadline_ms=60_000)
    expired = r.submit_ids([2, 3], deadline_ms=100.0)
    q0, q1 = r._slots[0].replica.queues, r._slots[1].replica.queues
    for q in q1.values():
        for req in q:
            q0[req.bucket].append(req)
        q.clear()
    inflight = r.submit_ids([2, 3], deadline_ms=60_000)
    for q in q1.values():
        q.clear()
    r._slots[0].replica.inflight = [inflight]
    clk.advance(0.2)
    r._eject(0, "stalled")
    assert r._slots[0].replica.state == "ejected"
    with pytest.raises(DeadlineExceeded):
        expired.result(timeout=0)
    q1_reqs = [req for q in q1.values() for req in q]
    assert alive in q1_reqs and inflight in q1_reqs
    assert inflight.retries == 1
    assert r.metrics.requeued_total.value == 1
    assert r.metrics.retries_total.value == 1
    assert r.metrics.ejections_total.value == 1


def test_eject_exhausted_retry_budget_fails_loudly():
    r, _ = _router(n=2, start=False, clock=FakeClock(), max_batch_size=100,
                   max_wait_ms=60_000.0, max_retries=0)
    r._started = True
    req = r.submit_ids([2, 3], deadline_ms=60_000)
    rep = next(s.replica for s in r._slots
               if any(req in q for q in s.replica.queues.values()))
    for q in rep.queues.values():
        q.clear()
    rep.inflight = [req]
    r._eject(rep.index, "crashed")
    with pytest.raises(Exception, match="retry budget"):
        req.result(timeout=0)


# ------------------------------------------------------------ crash / stall
def test_crash_mid_traffic_zero_lost_and_relaunch_reintegrates():
    r, _ = _router(n=2, max_batch_size=2, max_wait_ms=5.0,
                   stall_timeout=0.5, tracer=Tracer(enabled=True))
    try:
        futs = [r.submit_ids([2, 3, 4], deadline_ms=30_000)
                for _ in range(12)]
        r.kill_replica(0, "crash")
        outs = [f.result(timeout=30) for f in futs]
        assert all(o.shape == (6,) for o in outs)  # zero lost
        _wait_state(r, 0, "ejected")
        assert r.metrics.ejections_total.value == 1
        report = validate_chains(r.tracer.records(), [f.rid for f in futs])
        assert report["incomplete"] == {} and report["complete"] == 12

        fresh = FakeEngine()
        r.relaunch(0, engine=fresh)
        assert r.wait_ready(10)
        # warmup-gated: one probe per bucket before any traffic
        assert fresh.calls[: len(r.buckets)] == [(1, b) for b in r.buckets]
        assert r.metrics.reintegrations_total.value == 1
        assert r.submit_ids([2, 3], deadline_ms=30_000)\
            .result(timeout=10) is not None
    finally:
        r.stop(drain=False, timeout=5)


def test_stalled_replica_ejected_by_heartbeat_staleness():
    r, _ = _router(n=2, max_batch_size=2, max_wait_ms=5.0,
                   stall_timeout=0.4, poll_interval=0.05)
    try:
        r.kill_replica(0, "hang")
        futs = [r.submit_ids([2, 3, 4], deadline_ms=30_000)
                for _ in range(8)]
        assert all(f.result(timeout=30) is not None for f in futs)
        _wait_state(r, 0, "ejected")
    finally:
        r.stop(drain=False, timeout=5)


# ------------------------------------------------------------- rolling swap
def test_rolling_swap_and_corrupt_manifest_rollback(tmp_path):
    r, engines = _router(n=2)
    try:
        good = str(tmp_path / "good-cls.pt")
        ckpt.save(good, {"w": torch.ones(4)})
        report = r.swap_checkpoint(good)
        assert report["swapped"] == [0, 1] and not report["rolled_back"]
        assert all(e.checkpoint_path == good for e in engines)
        bad = str(tmp_path / "bad-cls.pt")
        ckpt.save(bad, {"w": torch.ones(4)})
        with open(bad, "r+b") as f:
            f.truncate(8)
        report = r.swap_checkpoint(bad)
        assert report["rolled_back"] == [0] and report["swapped"] == []
        assert "CorruptCheckpointError" in report["error"]
        assert all(e.checkpoint_path == good for e in engines)
        assert r.states == {0: "healthy", 1: "healthy"}
        assert r.metrics.swap_rollbacks_total.value == 1
        assert r.submit_ids([2, 3], deadline_ms=10_000)\
            .result(timeout=10) is not None
    finally:
        r.stop(drain=False, timeout=5)


# ------------------------------------------------------------------ hedging
def test_tail_hedging_first_completion_wins_one_terminal():
    slow, fast = FakeEngine(latency=0.3), FakeEngine()
    r, _ = _router(engines=[slow, fast], max_batch_size=2, max_wait_ms=1.0,
                   hedge_ms=30.0, stall_timeout=5.0, poll_interval=0.01,
                   tracer=Tracer(enabled=True))
    try:
        futs = [r.submit_ids([2, 3], deadline_ms=20_000) for _ in range(6)]
        for f in futs:
            f.result(timeout=30)
        report = validate_chains(r.tracer.records(), [f.rid for f in futs])
        assert report["incomplete"] == {}
        assert r.metrics.hedges_total.value >= 1
        assert report["hedged"] >= 1  # and still exactly one terminal
    finally:
        r.stop(drain=False, timeout=5)


def test_packed_eject_repacks_and_long_requests_ride_long_widths():
    """Packed router with chunked prefill: a kill re-packs the victim's
    queued requests (short and long) on the survivor under the same ids;
    long requests run at their long width, never hedged."""
    engines = [FakeEngine() for _ in range(2)]
    r, _ = _router(engines=engines, buckets=(32, 64, 128), max_batch_size=4,
                   max_wait_ms=1000.0, serve_pack="on",
                   long_widths=(256, 512), tracer=Tracer(enabled=True))
    try:
        warmed = [c for c in engines[0].calls if c[0] == "warm_packed"]
        assert warmed == [("warm_packed", 128, 4), ("warm_packed", 256, 2),
                          ("warm_packed", 512, 1)]
        assert r.max_request_tokens == 512
        reqs = [r.submit_ids([2, 5, 5, 3], deadline_ms=30_000)
                for _ in range(4)]
        reqs += [r.submit_ids([2] + [5] * 300 + [3], deadline_ms=30_000),
                 r.submit_ids([2] + [5] * 200 + [3], deadline_ms=30_000)]
        assert reqs[-2].bucket == 512 and reqs[-1].bucket == 256
        r.kill_replica(1, "crash")
        outs = [q.result(timeout=30) for q in reqs]
        assert outs[-2][0] == 512.0 and outs[-1][0] == 256.0
        report = validate_chains(r.tracer.records(), [q.rid for q in reqs])
        assert report["incomplete"] == {}
        assert report["repacked"] >= 1
        by_id = chains(r.tracer.records())
        admit = by_id[reqs[-2].rid][0]["attrs"]
        assert admit["hop"] == "admit" and admit["long_width"] == 512
    finally:
        r.stop(drain=False, timeout=5)


def test_long_width_validation_is_loud():
    with pytest.raises(ValueError, match="packed path"):
        _router(n=1, start=False, buckets=(128,), serve_pack="off",
                long_widths=(256,))
    with pytest.raises(ValueError, match="128"):
        _router(n=1, start=False, buckets=(128,), serve_pack="on",
                long_widths=(320,))
    with pytest.raises(ValueError, match="position table"):
        _router(n=1, start=False, buckets=(128,), serve_pack="on",
                long_widths=(1024,))


# ------------------------------------------------------ real bert-tiny pool
@pytest.fixture(scope="module")
def tiny_pool():
    """Two real bert-tiny-long engines on the CPU, the JAX engine's
    weights loaded into both, and that JAX engine."""
    import jax

    from pdnlp_tpu.data.tokenizer import WordPieceTokenizer as JaxTok
    from pdnlp_tpu.serve import InferenceEngine as JaxEngine
    from pdnlp_tpu.utils.config import Args as JaxArgs
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from pdnlp_tpu_torch.models import convert
    from pdnlp_tpu_torch.serve import InferenceEngine
    from pdnlp_tpu_torch.utils.config import Args

    texts = ["天地人你我", "好坏大小上下来去" * 5, "爱恨喜怒哀乐" * 15,
             "高兴悲伤", "讨厌愤怒来去" * 8]
    vocab = build_vocab(texts, size=128)
    jeng = JaxEngine(JaxArgs(model="bert-tiny-long", max_seq_len=128),
                     tokenizer=JaxTok(vocab), mesh=None)
    sd = convert.from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                        jeng.params))
    tok = WordPieceTokenizer(vocab)
    args = Args(model="bert-tiny-long", max_seq_len=128, device="cpu")

    def factory(i):
        e = InferenceEngine(args, tokenizer=tok)
        e.load_state(sd)
        return e

    return jeng, factory, texts


def test_real_engines_kill_relaunch_swap_zero_recaptures(tiny_pool,
                                                         tmp_path):
    jeng, factory, texts = tiny_pool
    r = ReplicaRouter([factory(0), factory(1)], engine_factory=factory,
                      buckets=(32, 64, 128), max_batch_size=4,
                      max_wait_ms=5.0, stall_timeout=2.0,
                      poll_interval=0.02).start()
    try:
        assert r.wait_ready(60)
        futs = [r.submit(t, deadline_ms=60_000) for t in texts * 4]
        r.kill_replica(0, "crash")
        outs = [f.result(timeout=60) for f in futs]
        ids = r.tokenizer.encode_ragged(texts, 128)
        want = np.concatenate([jeng.infer_ids([i], 128, rows=1)
                               for i in ids])
        np.testing.assert_allclose(np.stack(outs[: len(texts)]), want,
                                   atol=ATOL)
        assert r.retraces_post_warmup == 0
        _wait_state(r, 0, "ejected")
        r.relaunch(0)
        assert r.wait_ready(60)
        futs = [r.submit(t, deadline_ms=60_000) for t in texts * 4]
        assert all(f.result(timeout=60).shape == (6,) for f in futs)
        assert r.retraces_post_warmup == 0      # relaunch: baselined
        snap = r.snapshot()
        assert snap["replicas"]["0"]["retraces_post_warmup"] == 0
        assert snap["replicas"]["0"]["engine"]["compile_cache"]["retraces"] > 0
        # a good swap applies to both replicas, a corrupt one rolls back
        good = str(tmp_path / "good-cls.pt")
        ckpt.save_params(good, r.engine(1).state_dict(),
                         model_name="bert-tiny-long",
                         vocab_size=r.tokenizer.vocab_size)
        assert r.swap_checkpoint(good)["swapped"] == [0, 1]
        bad = str(tmp_path / "bad-cls.pt")
        ckpt.save_params(bad, r.engine(1).state_dict(),
                         model_name="bert-tiny-long",
                         vocab_size=r.tokenizer.vocab_size)
        with open(bad, "r+b") as f:
            f.truncate(64)
        assert r.swap_checkpoint(bad)["rolled_back"] == [0]
        assert r.engine(0).checkpoint_path == good
        assert r.retraces_post_warmup == 0
    finally:
        r.stop(drain=False, timeout=10)
