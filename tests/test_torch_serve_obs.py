"""The rest of the port's serving tier against the JAX package:

- chunked prefill (``DynamicBatcher(long_widths=)``): a long request served
  as one segment of a long-width packed batch equals a whole-request
  forward (the twin of ``tests/test_longcontext.py::
  test_chunked_prefill_parity_with_whole_request``, fp32 atol 2e-5) and
  the JAX engine's (atol 2e-4, the flash tests' end-to-end bound);
- batcher hop chains pass ``validate_chains`` (``tests/test_telemetry.py``
  twins), knobs, ``max_request_tokens``;
- the live exporter's ``/metrics`` names equal JAX's for the same
  snapshot, and the serving phase tables equal JAX's on the same records;
- the native WordPiece encoder equals the pure-Python one on a corpus and
  on adversarial Unicode;
- ``serve.cli --replicas 2`` as a subprocess drains on SIGTERM.

Every ``result``, ``stop`` and process wait is bounded.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from pdnlp_tpu_torch.obs.request import hop_chain, validate_chains
from pdnlp_tpu_torch.obs.trace import Tracer
from pdnlp_tpu_torch.serve import DynamicBatcher, ReplicaRouter
from pdnlp_tpu_torch.utils.config import Args

from tests.test_torch_serve_router import FakeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------- chunked prefill
@pytest.fixture(scope="module")
def long_serve():
    """bert-tiny-long (2048 positions) on the CPU with JAX's weights, a
    packed batcher at pack width 128 with long widths 256 and 512, and
    the JAX engine."""
    import jax

    from pdnlp_tpu.data.tokenizer import WordPieceTokenizer as JaxTok
    from pdnlp_tpu.serve import InferenceEngine as JaxEngine
    from pdnlp_tpu.utils.config import Args as JaxArgs
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer
    from pdnlp_tpu_torch.models import convert
    from pdnlp_tpu_torch.serve import InferenceEngine

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        [f"t{i}" for i in range(95)]

    jeng = JaxEngine(JaxArgs(model="bert-tiny-long", max_seq_len=512,
                             dropout=0.0, attn_dropout=0.0),
                     tokenizer=JaxTok(vocab), mesh=None)
    eng = InferenceEngine(Args(model="bert-tiny-long", max_seq_len=512,
                               device="cpu"),
                          tokenizer=WordPieceTokenizer(vocab))
    eng.load_state(convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jeng.params)))
    bat = DynamicBatcher(eng, buckets=(128,), max_batch_size=4,
                         max_wait_ms=10.0, max_queue=64, serve_pack="on",
                         pack_max_segments=8, long_widths=(256, 512)).start()
    bat.warmup()
    yield eng, bat, jeng
    bat.stop(drain=False)


def test_chunked_prefill_parity_with_whole_request(long_serve):
    eng, bat, jeng = long_serve
    assert (bat.long_rows, bat.long_segments) == ({256: 2, 512: 1},
                                                  {256: 16, 512: 32})
    r = np.random.RandomState(6)
    long_ids = [2] + list(r.randint(5, 90, 400)) + [3]
    mid_ids = [2] + list(r.randint(5, 90, 180)) + [3]
    shorts = [[2] + list(r.randint(5, 90, r.randint(3, 40))) + [3]
              for _ in range(8)]
    warm = eng.metrics.retraces.value
    futs = [bat.submit_ids(long_ids), bat.submit_ids(mid_ids)] \
        + [bat.submit_ids(s) for s in shorts]
    res = [f.result(timeout=60) for f in futs]
    assert eng.metrics.retraces.value == warm  # closed by warmup
    np.testing.assert_allclose(res[0], eng.infer_ids([long_ids], 512)[0],
                               atol=2e-5)
    np.testing.assert_allclose(res[1], eng.infer_ids([mid_ids], 256)[0],
                               atol=2e-5)
    np.testing.assert_allclose(res[0], jeng.infer_ids([long_ids], 512)[0],
                               atol=2e-4)
    assert all(x.shape == (6,) for x in res[2:])


def test_chunked_prefill_routing_and_truncation(long_serve):
    eng, bat, _ = long_serve
    assert bat.max_request_tokens == 512
    huge = [2] + [5 + i % 90 for i in range(700)]
    got = bat.submit_ids(huge).result(timeout=60)
    np.testing.assert_allclose(got, eng.infer_ids([huge[:512]], 512)[0],
                               atol=2e-5)


def test_long_width_validation_is_loud(long_serve):
    eng, _, _ = long_serve
    with pytest.raises(ValueError, match="position table"):
        DynamicBatcher(eng, buckets=(128,), serve_pack="on",
                       long_widths=(4096,))
    with pytest.raises(ValueError, match="128"):
        DynamicBatcher(eng, buckets=(128,), serve_pack="on",
                       long_widths=(320,))
    with pytest.raises(ValueError, match="packed path"):
        DynamicBatcher(eng, buckets=(128,), serve_pack="off",
                       long_widths=(256,))


# ------------------------------------------------------------- hop chains
def test_batcher_end_to_end_chain_and_deadline_terminal():
    eng = FakeEngine()
    eng.tracer = Tracer(enabled=True)
    with DynamicBatcher(eng, buckets=(32,), max_batch_size=2,
                        max_wait_ms=2.0) as b:
        futs = [b.submit_ids([2, 3, 4]) for _ in range(4)]
        for f in futs:
            f.result(timeout=10)
    report = validate_chains(eng.tracer.records(), [f.rid for f in futs])
    assert report["checked"] == 4 and report["complete"] == 4
    assert report["incomplete"] == {}
    chain = hop_chain(eng.tracer.records(), futs[0].rid)
    assert [r["attrs"]["hop"] for r in chain] == \
        ["admit", "dispatch", "complete"]
    assert chain[0]["attrs"]["bucket"] == 32

    slow = FakeEngine(latency=0.2)
    slow.tracer = Tracer(enabled=True)
    b = DynamicBatcher(slow, buckets=(32,), max_batch_size=8,
                       max_wait_ms=1.0).start()
    try:
        blocker = b.submit_ids([2, 3])
        time.sleep(0.05)
        doomed = b.submit_ids([2, 3], deadline_ms=5.0)
        with pytest.raises(Exception):
            doomed.result(timeout=10)
        blocker.result(timeout=10)
    finally:
        b.stop(drain=False)
    assert hop_chain(slow.tracer.records(),
                     doomed.rid)[-1]["attrs"]["hop"] == "deadline"


def test_batcher_knobs():
    b = DynamicBatcher(FakeEngine(), buckets=(32,), serve_pack="on")
    b.apply_knob("max_wait_ms", 7)
    b.apply_knob("max_queue", 3)
    assert b.knob_values() == {"max_wait_ms": 7.0, "max_queue": 3}
    assert b.max_queue_tokens == 3 * 32
    with pytest.raises(KeyError):
        b.apply_knob("hedge_ms", 1)


# ------------------------------------------------------------ exporter
def test_exporter_names_equal_jax_for_the_same_snapshot(tmp_path):
    """A real router snapshot (fake engines, traffic, a kill) rendered by
    both packages' ``prometheus_text``: the same lines.  The port's
    exporter serves them on ``/metrics`` with ``/healthz`` and a bounded
    flight recorder."""
    from pdnlp_tpu.obs.exporter import prometheus_text as jax_text
    from pdnlp_tpu_torch.obs.exporter import MetricsExporter, prometheus_text

    r = ReplicaRouter([FakeEngine(), FakeEngine()], buckets=(32, 64),
                      max_batch_size=2, max_wait_ms=2.0, stall_timeout=0.5,
                      poll_interval=0.02).start()
    try:
        assert r.wait_ready(10)
        futs = [r.submit_ids([2, 3, 4], deadline_ms=30_000)
                for _ in range(8)]
        r.kill_replica(1, "crash")
        for f in futs:
            f.result(timeout=30)
        snap = r.snapshot()
    finally:
        r.stop(drain=False, timeout=5)
    snaps = {"serve": snap, "memory": {"supported": False}}
    text = prometheus_text(snaps)
    assert text == jax_text(snaps)
    assert 'pdnlp_serve_replicas_batches_total{replica="0"}' in text
    assert "pdnlp_serve_router_completed_total 8" in text

    flight = str(tmp_path / "flight.jsonl")
    ex = MetricsExporter({"serve": lambda: snap}, port=0,
                         flight_path=flight, flight_interval_s=0.05,
                         flight_max_records=10).start()
    try:
        time.sleep(0.15)
        base = f"http://127.0.0.1:{ex.port}"
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=5).read().decode()
        hz = json.loads(urllib.request.urlopen(base + "/healthz",
                                               timeout=5).read())
        for _ in range(30):
            ex._flight_append()
    finally:
        ex.stop()
    assert "pdnlp_serve_router_completed_total 8" in body
    assert hz["status"] == "ok" and "serve" in hz["sources"]
    assert sum(1 for _ in open(flight)) <= 10


def test_serve_phase_tables_equal_jax():
    from pdnlp_tpu.obs.phases import StepBreakdown as JaxBreakdown
    from pdnlp_tpu_torch.obs.phases import StepBreakdown, format_table

    recs = []
    for rep, dur in ((0, 0.010), (0, 0.012), (1, 0.200)):
        recs.append({"name": "forward", "t0": 0.0, "dur": dur, "tid": 0,
                     "depth": 0, "attrs": {"replica": rep, "seq": 64,
                                           "fill": 0.5, "packed": True,
                                           "dtype": "int8",
                                           "hbm_peak": 4 << 30}})
    recs.append({"name": "queue_wait", "t0": 0.0, "dur": 0.005, "tid": 0,
                 "depth": 0, "attrs": {"replica": 1, "retry": 2}})
    recs.append({"name": "compile", "t0": 0.0, "dur": 0.5, "tid": 0,
                 "depth": 0, "attrs": {"replica": 0, "fill": 0.01}})
    ours, ref = StepBreakdown(), JaxBreakdown()
    for rec in recs:
        ours.feed(dict(rec))
        ref.feed(dict(rec))
    assert ours.summary() == ref.summary()
    s = ours.summary()["serve_by_replica"]
    assert s["1"]["retries"] == 2 and s["0"]["packed_batches"] == 2
    table = format_table(ours.summary())
    assert "replica 0" in table and "peak HBM 4.000 GB" in table


# ------------------------------------------------------ native tokenizer
ADVERSARIAL = [
    "", "   ", "Hello, World! ABC-def", "ＨＥＬＬＯ！，。；",
    "İstanbul ß Straße", "ΣΊΣΥΦΟΣ", "Σ", "ΑΣ ΒΣΓ Σ'Σ",
    "中文混合English字符", "​­zero​width",
    "\t tab\nnewline　ideographic space", "emoji😀mix中",
    "𐐀𐐁 DESERET", "\U000E0041tag\U000E007Fchars", "x" * 300,
    "００１２３",
]


@pytest.fixture(scope="module")
def tok_pair(corpus_path):
    from pdnlp_tpu_torch.data import native
    from pdnlp_tpu_torch.data.corpus import load_data
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab

    texts = [t for t, _ in load_data(corpus_path)[:2000]]
    vocab = build_vocab(texts + [t.lower() for t in ADVERSARIAL])
    py, nat = WordPieceTokenizer(vocab), WordPieceTokenizer(vocab)
    if not native.attach(nat):
        pytest.skip("g++ unavailable: the native encoder cannot be built")
    return py, nat, texts


@pytest.mark.parametrize("which", ["corpus", "adversarial"])
def test_native_encoder_equals_python(tok_pair, which):
    from pdnlp_tpu_torch.data import native

    py, nat, corpus = tok_pair
    texts = corpus if which == "corpus" else ADVERSARIAL
    for max_len in (16, 128):
        a, b = py.encode_batch(texts, max_len), nat.encode_batch(texts,
                                                                 max_len)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert py.encode_ragged(texts, max_len) == \
            nat.encode_ragged(texts, max_len)
    assert py.encode_ids(texts[-1], 512) == nat.encode_ids(texts[-1], 512)
    # the build is the checkout's own: under the port's build directory
    assert os.path.dirname(native.build()) == str(native.BUILD_DIR)


# ------------------------------------------------------------------- CLI
def test_cli_replicas_drain_on_sigterm(tmp_path, corpus_path):
    """``serve.cli --replicas 2`` with int8, tracing and the flight
    recorder: SIGTERM mid-stream drains every accepted line, flushes the
    snapshot, the spans and the flight record, and exits 0."""
    metrics_path = tmp_path / "m.json"
    flight = tmp_path / "flight.jsonl"
    env = dict(os.environ, PYTHONPATH=REPO, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--device",
         "cpu", "--model", "bert-tiny", "--buckets", "32", "--replicas",
         "2", "--serve_dtype", "int8", "--hedge_ms", "50",
         "--replica_stall_s", "30", "--data_path", str(corpus_path),
         "--vocab_path", str(tmp_path / "vocab.txt"),
         "--output_dir", str(tmp_path / "out"),
         "--metrics_path", str(metrics_path), "--flight_recorder",
         str(flight), "--trace", "true", "--trace_dir",
         str(tmp_path / "trace")],
        cwd=str(tmp_path), env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    err = []
    try:
        def pump():
            for line in proc.stderr:
                err.append(line)
                if "ready" in line:
                    return

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        t.join(180)
        assert any("ready" in x for x in err), "".join(err)[-2000:]
        assert any(x.startswith("encoder: ") for x in err)
        for text in ("天地人", "好坏大小", "高兴悲伤"):
            proc.stdin.write(text + "\n")
        proc.stdin.flush()
        time.sleep(1.0)
        proc.terminate()
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, stderr[-3000:]
    assert len([x for x in stdout.splitlines() if "\t" in x]) == 3, stdout
    snap = json.loads(metrics_path.read_text())
    assert snap["router"]["completed_total"] >= 3
    assert all(v["retraces_post_warmup"] == 0
               for v in snap["replicas"].values())
    assert snap["replicas"]["0"]["engine"]["compile_cache"]["retraces"] >= 1
    assert list((tmp_path / "trace").glob("trace_proc*.jsonl"))
    assert flight.exists() and json.loads(
        flight.read_text().splitlines()[-1])["serve"]["router"]
