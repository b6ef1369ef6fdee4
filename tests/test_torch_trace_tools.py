"""The port's trace tools on the CPU: ``pdnlp_tpu_torch.obs.merge`` (the
cross-rank merge) and ``python -m pdnlp_tpu_torch.tools.trace`` (the twin
of ``trace_tpu.py``) — the twins of ``tests/test_telemetry.py``'s four
merge tests and its ``request``/``merge``/``summarize`` CLI round trip,
with ``merge_traces`` held to JAX's on the same files (records and report
equal) — and the training loop's live exporter and flight recorder
(``train.single --metrics_port / --flight_recorder``, the twin of
``pdnlp_tpu/train/trainer.py``'s).
"""
import json
import os
import time

import pytest

from pdnlp_tpu.obs import merge as jmerge
from pdnlp_tpu_torch.obs import merge as pmerge
from pdnlp_tpu_torch.obs.phases import StepBreakdown, format_table
from pdnlp_tpu_torch.obs.regress import diff_breakdowns
from pdnlp_tpu_torch.obs.trace import Tracer
from pdnlp_tpu_torch.parallel.watchdog import Heartbeat
from pdnlp_tpu_torch.tools import trace as trace_cli


def _rank_trace(tmp_path, rank, t_base, wall_offset, n_steps=8,
                step_ms=10.0):
    """One rank's flushed trace: n steps of device_block at step_ms, with
    a clock domain starting at t_base and wall = mono + wall_offset."""
    tr = Tracer(str(tmp_path), enabled=True, process_index=rank,
                clock=lambda: _rank_trace.now)
    _rank_trace.now = t_base
    for i in range(n_steps):
        with tr.span("device_block", step=i + 1, n=1):
            _rank_trace.now += step_ms / 1e3
        _rank_trace.now += 0.001
    import pdnlp_tpu_torch.obs.trace as trace_mod
    real_time = trace_mod.time.time
    trace_mod.time.time = lambda: _rank_trace.now + wall_offset
    try:
        path = tr.flush()
    finally:
        trace_mod.time.time = real_time
    return path


def _merged_equal_jax(paths, **kw):
    """The port's merge of ``paths`` — records and report equal to JAX's."""
    got = pmerge.merge_traces(paths, **kw)
    assert got == jmerge.merge_traces(paths, **kw)
    return got


def test_merge_aligns_clocks_and_is_monotonic(tmp_path):
    p0 = _rank_trace(tmp_path, 0, t_base=5.0, wall_offset=100.0)
    p1 = _rank_trace(tmp_path / "r1", 1, t_base=1005.0,
                     wall_offset=-899.995)
    records, report = _merged_equal_jax([p0, p1])
    assert report["aligned"] and report["ranks"] == [0, 1]
    ts = [r["t0"] for r in records]
    assert ts == sorted(ts)
    assert {r["pid"] for r in records} == {0, 1}
    order = [r["pid"] for r in records]
    assert order != sorted(order)  # the ranks interleave once aligned
    assert pmerge.rank_of_path(p1) == jmerge.rank_of_path(p1) == 1


def test_merged_summary_per_rank_and_diff_matches_per_rank(tmp_path):
    p0 = _rank_trace(tmp_path, 0, t_base=0.0, wall_offset=50.0,
                     step_ms=10.0)
    p1 = _rank_trace(tmp_path / "r1", 1, t_base=500.0, wall_offset=-450.0,
                     step_ms=30.0)  # a 3x slower rank
    records, _ = _merged_equal_jax([p0, p1])
    summary = StepBreakdown.from_records(records).summary()
    assert summary["steps"] == 16
    by_rank = summary["by_rank"]
    assert set(by_rank) == {"0", "1"}
    m0 = by_rank["0"]["phases"]["device_block"]["mean_sec"]
    m1 = by_rank["1"]["phases"]["device_block"]["mean_sec"]
    assert m1 == pytest.approx(3 * m0, rel=0.05)
    assert "rank 1:" in format_table(summary)
    d = diff_breakdowns(summary, summary, threshold=0.05)
    assert d["regressions"] == []
    assert d["phases"]["device_block"]["delta_ratio"] == 0.0


def test_diff_on_merged_matches_per_rank_diff(tmp_path):
    base = [_rank_trace(tmp_path / "b0", 0, 0.0, 10.0, step_ms=10.0),
            _rank_trace(tmp_path / "b1", 1, 300.0, -290.0, step_ms=10.0)]
    cand = [_rank_trace(tmp_path / "c0", 0, 0.0, 10.0, step_ms=15.0),
            _rank_trace(tmp_path / "c1", 1, 300.0, -290.0, step_ms=15.0)]

    def summ(paths):
        records, _ = _merged_equal_jax(paths)
        return StepBreakdown.from_records(records).summary()

    merged = diff_breakdowns(summ(base), summ(cand), threshold=0.2)
    assert "device_block" in merged["regressions"]
    m_delta = merged["phases"]["device_block"]["delta_ratio"]
    for rank in (0, 1):
        per = diff_breakdowns(summ([base[rank]]), summ([cand[rank]]),
                              threshold=0.2)
        assert "device_block" in per["regressions"]
        assert per["phases"]["device_block"]["delta_ratio"] == \
            pytest.approx(m_delta, abs=0.02)


def test_merge_heartbeat_fallback(tmp_path):
    """A trace with no _clock_sync record aligns through the rank's beat
    payload (wall t + mono pair) — the port's watchdog writes it, and
    JAX's merge reads it the same way."""
    from pdnlp_tpu_torch.obs.export import write_jsonl

    hb = Heartbeat(str(tmp_path), 3, interval=0.0)
    hb.beat(force=True, step=7)
    off = pmerge._offset_from_heartbeat(str(tmp_path), 3)
    assert off is not None
    assert off == pytest.approx(time.time() - time.perf_counter(), abs=0.5)
    assert off == jmerge._offset_from_heartbeat(str(tmp_path), 3)
    path = os.path.join(str(tmp_path), "trace_proc3.jsonl")
    write_jsonl([{"name": "device_block", "t0": 1.0, "dur": 0.01,
                  "tid": 0, "depth": 0}], path, process_index=3)
    _, report = _merged_equal_jax([path], hb_dir=str(tmp_path))
    assert report["files"][0]["clock_source"] == "heartbeat"


def test_trace_cli_request_and_merge(tmp_path, capsys):
    """``tools.trace request`` prints a served request's chain (exit 1 on
    an unknown id), ``merge`` writes a Chrome trace that ``summarize``
    reads, and ``export`` converts a span log."""
    from tests.test_torch_serve_router import FakeEngine
    from pdnlp_tpu_torch.serve import DynamicBatcher

    eng = FakeEngine()
    eng.tracer = Tracer(str(tmp_path), enabled=True, process_index=0)
    b = DynamicBatcher(eng, buckets=(32,), max_batch_size=2,
                       max_wait_ms=1.0)
    b.start()
    try:
        futs = [b.submit_ids([2, 3, 4]) for _ in range(2)]
        for f in futs:
            f.result(timeout=10)
    finally:
        b.stop()
    path = eng.tracer.flush()

    assert trace_cli.main(["request", futs[0].rid, path]) == 0
    out = capsys.readouterr().out
    assert "admit" in out and "complete" in out and "chain: complete" in out
    assert trace_cli.main(["request", "r0-999999", path]) == 1
    capsys.readouterr()

    merged = str(tmp_path / "merged.trace.json")
    assert trace_cli.main(["merge", path, "-o", merged]) == 0
    doc = json.load(open(merged))
    assert doc["traceEvents"]
    assert trace_cli.main(["summarize", merged]) == 0
    assert trace_cli.main(["decisions", path]) == 0  # none recorded: clean
    assert "no decision records" in capsys.readouterr().out
    out_json = str(tmp_path / "exported.json")
    assert trace_cli.main(["export", path, "-o", out_json]) == 0
    assert json.load(open(out_json))["traceEvents"]


def test_train_single_metrics_port_and_flight_recorder(corpus_path,
                                                       tmp_path, capsys):
    """``train.single --metrics_port P --flight_recorder <f> --trace
    true`` on the CPU: the flags are taken, ``/metrics`` is served, the
    flight file holds the exporter's snapshots of the ``memory``,
    ``train`` and ``transport`` sources (JAX's trainer's), and the run
    trains and saves as without them."""
    import socket

    from pdnlp_tpu_torch.train import single
    from pdnlp_tpu_torch.utils.config import parse_cli

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    flight = tmp_path / "flight.jsonl"
    argv = single.refuse_not_ported([
        "--device", "cpu", "--model", "bert-tiny", "--data_path",
        corpus_path, "--vocab_path", str(tmp_path / "vocab.txt"),
        "--output_dir", str(tmp_path / "out"), "--data_limit", "120",
        "--train_batch_size", "16", "--trace", "true", "--metrics_port",
        str(port), "--flight_recorder", str(flight)])
    args = parse_cli(argv)
    assert args.flight_recorder == str(flight) and args.metrics_port == port
    single.main(args)
    assert f"/metrics + /healthz on http://127.0.0.1:{port}" in \
        capsys.readouterr().out
    lines = [json.loads(x) for x in flight.read_text().splitlines()]
    assert lines, "no flight-recorder line"
    assert {"memory", "train", "transport"} <= set(lines[-1])
    assert lines[-1]["train"]["steps"] > 0
    assert os.path.exists(args.ckpt_path())
