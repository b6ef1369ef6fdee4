"""The port's telemetry (``pdnlp_tpu_torch.obs``) on the CPU — the twins of
the jax-free cases of ``tests/test_obs.py`` (tracer, breakdown,
percentiles, thread safety, regression detector, ``diff_breakdowns``,
export round trips, the eight-phase vocabulary) and of
``tests/test_telemetry.py:407-417`` (``MemorySampler``), plus a traced
``train.single`` end to end whose span file the JAX package's own reader
(``pdnlp_tpu.obs.export.load_records`` + ``StepBreakdown.from_records``)
folds into the same phases as the port's.  Synthetic records go through
the code paths the trainer feeds, so the math is exact, not timed.
"""
import json
import threading
import time

import pytest
import torch

from pdnlp_tpu.obs import StepBreakdown as JStepBreakdown
from pdnlp_tpu.obs import PHASES as JPHASES
from pdnlp_tpu.obs.export import load_records as jload_records
from pdnlp_tpu_torch.obs import (
    PHASES, MemorySampler, RegressionDetector, StepBreakdown, Tracer,
    diff_breakdowns, format_table, memory_snapshot,
)
from pdnlp_tpu_torch.obs.export import (
    from_chrome_trace, load_records, to_chrome_trace, write_chrome_trace,
    write_jsonl,
)
from pdnlp_tpu_torch.obs.trace import CLOCK_SYNC, configure_from_args


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: bit-for-bit comparisons need it (the CPU
    backward with several threads differs run to run in the last bit),
    and bert-tiny needs no more beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _rec(name, dur, **attrs):
    r = {"name": name, "t0": 0.0, "dur": dur, "tid": 0, "depth": 0}
    if attrs:
        r["attrs"] = attrs
    return r


# --------------------------------------------------------------- tracer


def test_span_records_name_duration_and_attrs():
    t = {"now": 0.0}
    tr = Tracer(enabled=True, clock=lambda: t["now"])
    with tr.span("step_dispatch", step=7, n=2):
        t["now"] += 0.25
    (rec,) = tr.records()
    assert rec["name"] == "step_dispatch"
    assert rec["dur"] == pytest.approx(0.25)
    assert rec["attrs"] == {"step": 7, "n": 2} and rec["depth"] == 0


def test_span_nesting_tracks_depth_and_set_updates_attrs():
    tr = Tracer(enabled=True)
    with tr.span("outer") as outer:
        with tr.span("inner"):
            pass
        outer.set(bytes=128)
    inner, outer = tr.records()
    assert (inner["name"], inner["depth"]) == ("inner", 1)
    assert (outer["name"], outer["depth"]) == ("outer", 0)
    assert outer["attrs"] == {"bytes": 128}


def test_disabled_tracer_records_nothing_and_shares_one_null_span():
    tr = Tracer(enabled=False)
    s1, s2 = tr.span("a", x=1), tr.span("b")
    assert s1 is s2
    with s1:
        pass
    x = torch.ones(3)
    assert tr.block(x) is x and s1.block(x) is x   # no barrier, passthrough
    assert tr.records() == [] and tr.flush() is None


def test_wrap_iter_times_each_next_and_preserves_items():
    tr = Tracer(enabled=True)
    assert list(tr.wrap_iter("data_wait", iter([1, 2, 3]))) == [1, 2, 3]
    assert [r["name"] for r in tr.records()] == ["data_wait"] * 4


def test_record_explicit_timestamps():
    tr = Tracer(enabled=True)
    tr.record("h2d_put", 10.0, 10.5, bucket=64)
    (rec,) = tr.records()
    assert rec["dur"] == pytest.approx(0.5) and rec["attrs"] == {"bucket": 64}


def test_ring_buffer_caps_history():
    tr = Tracer(enabled=True, capacity=8)
    for i in range(20):
        with tr.span("log", i=i):
            pass
    recs = tr.records()
    assert len(recs) == 8 and recs[-1]["attrs"]["i"] == 19


def test_listener_sees_every_record_and_can_be_removed():
    tr = Tracer(enabled=True)
    seen = []
    tr.add_listener(seen.append)
    with tr.span("eval"):
        pass
    tr.remove_listener(seen.append)
    with tr.span("eval"):
        pass
    assert len(seen) == 1 and seen[0]["name"] == "eval"


def test_span_block_records_child_device_block():
    """``block`` waits in its own child span (on the CPU the value is
    ready; on the card it is an event synchronized on the current
    stream)."""
    tr = Tracer(enabled=True)
    with tr.span("step_dispatch") as sp:
        sp.block({"loss": torch.ones(4), "n": [torch.zeros(1)]}, step=1)
    block, dispatch = tr.records()
    assert (block["name"], block["depth"]) == ("device_block", 1)
    assert block["attrs"] == {"step": 1}
    assert (dispatch["name"], dispatch["depth"]) == ("step_dispatch", 0)


def test_configure_from_args_resets_and_defaults_the_dir(tmp_path):
    from pdnlp_tpu_torch.utils.config import Args

    on = configure_from_args(Args(trace=True, output_dir=str(tmp_path)))
    assert on.enabled and on.out_dir == str(tmp_path / "trace")
    assert configure_from_args(Args(trace=True,
                                    output_dir=str(tmp_path))) is on
    assert not configure_from_args(Args()).enabled


# ------------------------------------------------------------ breakdown


def test_breakdown_aggregates_phases_per_step():
    bd = StepBreakdown()
    for step in (1, 2):
        bd.feed(_rec("data_wait", 0.010))
        bd.feed(_rec("h2d_put", 0.002))
        bd.feed(_rec("h2d_put", 0.001))
        bd.feed(_rec("step_dispatch", 0.001))
        bd.feed(_rec("device_block", 0.100, step=step))
    bd.feed(_rec("not_a_phase", 9.9))
    bd.close()
    s = bd.summary()
    assert s["steps"] == 2 and s["groups"] == 2
    put = s["phases"]["h2d_put"]
    assert put["count"] == 2 and put["total_sec"] == pytest.approx(0.006)
    assert sum(p["share"] for p in s["phases"].values()) == \
        pytest.approx(1.0, abs=1e-3)


def test_breakdown_fused_groups_count_n_steps():
    bd = StepBreakdown()
    bd.feed(_rec("step_dispatch", 0.004))
    bd.feed(_rec("device_block", 0.050, step=4, n=4, bucket=32))
    bd.close()
    s = bd.summary()
    assert s["steps"] == 4 and s["groups"] == 1
    assert s["by_bucket"]["32"]["steps"] == 4


def test_breakdown_percentiles():
    bd = StepBreakdown()
    for ms in range(1, 101):
        bd.record("data_wait", ms / 1e3)
        bd.end_step()
    s = bd.summary()["phases"]["data_wait"]
    assert s["p50_sec"] == pytest.approx(0.0505)
    assert s["p95_sec"] == pytest.approx(0.09505)


def test_breakdown_counts_nested_phase_spans_once():
    t = {"now": 0.0}
    tr = Tracer(enabled=True, clock=lambda: t["now"])
    bd = StepBreakdown()
    tr.add_listener(bd.feed)
    with tr.span("data_wait"):
        t["now"] += 0.002
        with tr.span("h2d_put"):
            t["now"] += 0.010
        t["now"] += 0.001
    with tr.span("device_block"):
        t["now"] += 0.050
    bd.close()
    s = bd.summary()["phases"]
    assert s["h2d_put"]["total_sec"] == pytest.approx(0.010)
    assert s["data_wait"]["total_sec"] == pytest.approx(0.003)


def test_breakdown_feed_is_thread_safe():
    bd = StepBreakdown()
    n = 400

    def worker():
        for _ in range(n):
            bd.feed(_rec("h2d_put", 0.001))

    t = threading.Thread(target=worker)
    t.start()
    for _ in range(n):
        bd.feed(_rec("step_dispatch", 0.001))
        bd.feed(_rec("device_block", 0.001))
    t.join()
    bd.close()
    s = bd.summary()["phases"]
    assert sum(p["total_sec"] for p in s.values()) == pytest.approx(n * 3e-3)


def test_breakdown_on_step_fires_with_phase_dict():
    steps = []
    bd = StepBreakdown(on_step=lambda step, phases, wall:
                       steps.append((step, dict(phases), wall)))
    bd.feed(_rec("data_wait", 0.2))
    bd.feed(_rec("device_block", 0.3, step=17))
    (step, phases, wall), = steps
    assert step == 17 and phases == {"data_wait": 0.2, "device_block": 0.3}
    assert wall == pytest.approx(0.5)


def test_format_table_lists_every_phase():
    bd = StepBreakdown()
    bd.feed(_rec("data_wait", 0.2))
    bd.feed(_rec("device_block", 0.3))
    bd.close()
    table = format_table(bd.summary())
    assert "data_wait" in table and "device_block" in table
    assert "steps: 1" in table


def test_phase_vocabulary_is_the_documented_eight():
    assert PHASES == ("data_wait", "h2d_put", "step_dispatch",
                      "device_block", "eval", "ckpt_save", "ckpt_wait",
                      "log")
    assert PHASES == JPHASES


# --------------------------------------------------------------- export


def test_chrome_trace_required_keys_and_units(tmp_path):
    tr = Tracer(enabled=True)
    with tr.span("step_dispatch", step=1):
        time.sleep(0.001)
    doc = to_chrome_trace(tr.records(), process_index=3)
    for ev in doc["traceEvents"]:
        for key in ("name", "ph", "ts", "pid", "tid"):
            assert key in ev
        assert ev["ph"] == "X" and ev["pid"] == 3 and ev["dur"] >= 1000
    path = str(tmp_path / "t.json")
    write_chrome_trace(tr.records(), path)
    assert json.load(open(path))["traceEvents"]


def test_jsonl_roundtrip_and_chrome_roundtrip(tmp_path):
    recs = [_rec("data_wait", 0.01), _rec("device_block", 0.09, step=1)]
    jl = str(tmp_path / "trace_proc0.jsonl")
    write_jsonl(recs, jl, process_index=2)
    back = load_records(jl)
    assert [r["name"] for r in back] == ["data_wait", "device_block"]
    assert all(r["pid"] == 2 for r in back)
    back2 = from_chrome_trace(to_chrome_trace(recs))
    assert back2[1]["attrs"] == {"step": 1}
    assert back2[1]["dur"] == pytest.approx(0.09)
    cj = str(tmp_path / "t.json")
    write_chrome_trace(recs, cj)
    assert [r["name"] for r in load_records(cj)] == ["data_wait",
                                                      "device_block"]


def test_tracer_flush_writes_per_process_jsonl(tmp_path):
    tr = Tracer(str(tmp_path), enabled=True, process_index=1)
    with tr.span("eval"):
        pass
    path = tr.flush()
    assert path.endswith("trace_proc1.jsonl")
    recs = load_records(path)
    assert recs[0]["name"] == "eval"
    assert recs[-1]["name"] == CLOCK_SYNC and "wall" in recs[-1]["attrs"]
    assert tr.records()                       # a snapshot, not a drain


# -------------------------------------------------- regression detector


def _observe_steps(det, n, phases, start=1):
    for i in range(n):
        det.observe(start + i, dict(phases), sum(phases.values()))


def test_regress_flags_sustained_slowdown_once():
    det = RegressionDetector(warmup=3, sustain=3, slow_ratio=1.3)
    _observe_steps(det, 10, {"data_wait": 0.010})
    assert det.events == []
    _observe_steps(det, 10, {"data_wait": 0.020}, start=11)
    assert [e["kind"] for e in det.events].count("slowdown") == 1
    assert det.events[0]["sustained_steps"] >= 3


def test_regress_flags_one_off_stall_without_poisoning_baseline():
    det = RegressionDetector(warmup=3, sustain=3, spike_ratio=3.0)
    _observe_steps(det, 10, {"device_block": 0.100})
    det.observe(11, {"device_block": 1.0}, 1.0)
    (ev,) = det.events
    assert ev["kind"] == "stall" and ev["ratio"] >= 3.0
    det.observe(12, {"device_block": 0.100}, 0.1)
    assert len(det.events) == 1


def test_regress_quiet_on_steady_phases():
    det = RegressionDetector(warmup=3, sustain=3)
    _observe_steps(det, 50, {"data_wait": 0.010, "device_block": 0.100})
    assert det.events == []


def test_heartbeat_payload_carries_step_and_smoothed_rate():
    det = RegressionDetector()
    assert det.heartbeat_payload() == {}
    for i in range(1, 6):
        det.observe(i, {"device_block": 0.5}, 0.5)
    p = det.heartbeat_payload()
    assert p["step"] == 5 and p["steps_per_sec"] == pytest.approx(2.0,
                                                                  abs=0.01)


def test_diff_breakdowns_flags_only_above_threshold_and_noise_floor():
    def summary(mean):
        return {"phases": {"data_wait": {"mean_sec": mean, "count": 30},
                           "log": {"mean_sec": 1e-9, "count": 30}}}

    d = diff_breakdowns(summary(0.010), {"phases": {
        "data_wait": {"mean_sec": 0.013, "count": 30},
        "log": {"mean_sec": 1e-7, "count": 30}}}, threshold=0.2)
    assert d["regressions"] == ["data_wait"]
    assert diff_breakdowns(summary(0.010), summary(0.011),
                           threshold=0.2)["regressions"] == []


def test_diff_breakdowns_min_count_guards_amortized_phases():
    base = {"phases": {"h2d_put": {"mean_sec": 0.0008, "count": 2}}}
    cand = {"phases": {"h2d_put": {"mean_sec": 0.0016, "count": 2}}}
    assert diff_breakdowns(base, cand)["regressions"] == []
    base["phases"]["h2d_put"]["count"] = 50
    cand["phases"]["h2d_put"]["count"] = 50
    assert diff_breakdowns(base, cand)["regressions"] == ["h2d_put"]


def test_diff_breakdowns_ckpt_save_budget_gate():
    cand = {"phases": {"ckpt_save": {"mean_sec": 0.004, "p95_sec": 0.009,
                                     "count": 12}}}
    assert diff_breakdowns({"phases": {}}, cand,
                           ckpt_save_budget=0.010)["regressions"] == []
    bad = diff_breakdowns({"phases": {}}, cand, ckpt_save_budget=0.005)
    assert "ckpt_save(p95-budget)" in bad["regressions"]


# ------------------------------------------------------------- memory


def test_memory_sampler_unsupported_is_noop():
    """On the CPU the first sample flips ``supported`` off for good
    (``tests/test_telemetry.py:407``)."""
    sampler = MemorySampler()
    assert sampler.sample() is None or sampler.supported
    if not sampler.supported:
        assert sampler.snapshot() == {"supported": False}
        assert sampler.beat_payload() == {}
        assert memory_snapshot() == {"supported": False}


def test_memory_sampler_tracks_phase_peaks_and_feeds_trace():
    """Phase-boundary samples: per-phase peaks, the summed and the
    per-card peak, and ``hbm`` records the breakdown turns into its
    memory row (``tests/test_telemetry.py:417``)."""
    devs = [{"device": 0, "bytes_in_use": 1 << 30,
             "peak_bytes_in_use": 2 << 30, "bytes_limit": 16 << 30},
            {"device": 1, "bytes_in_use": 1 << 30,
             "peak_bytes_in_use": 3 << 30, "bytes_limit": 16 << 30}]
    tr = Tracer(enabled=True)
    sampler = MemorySampler(tracer=tr,
                            stats=lambda: [dict(d) for d in devs])
    tr.add_listener(sampler.feed)
    with tr.span("device_block", step=1, n=1):
        pass
    devs[0]["peak_bytes_in_use"] = 5 << 30
    with tr.span("eval", step=1):
        pass
    snap = sampler.snapshot(sample=False)
    assert snap["supported"] and snap["peak_bytes_in_use"] == 8 << 30
    assert snap["device_peak_bytes"] == 5 << 30
    assert set(snap["per_phase"]) == {"device_block", "eval"}
    assert sampler.beat_payload()["hbm_peak"] == 8 << 30
    s = StepBreakdown.from_records(tr.records()).summary()
    assert s["memory"]["peak_bytes"] == 8 << 30
    assert "peak HBM" in format_table(s)


# ----------------------------------------------------------- end to end


def test_traced_train_single_end_to_end(corpus_path, tmp_path, capsys):
    """``train.single --trace true`` on the CPU with dev, resume snapshots
    and ``--fuse_steps 2``: the span file holds all eight phases, the
    table prints, and the JAX package's reader folds the port's file into
    the same phases and step counts as the port's (twin of
    ``tests/test_obs.py:488``)."""
    from pdnlp_tpu_torch.obs import trace
    from pdnlp_tpu_torch.train import single
    from pdnlp_tpu_torch.utils.config import Args

    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                vocab_path=str(tmp_path / "vocab.txt"),
                output_dir=str(tmp_path / "out"), data_limit=150,
                train_batch_size=16, dev=True, eval_step=4, log_every=2,
                resume_every=4, fuse_steps=2, trace=True)
    try:
        single.main(args)
    finally:
        tracer = trace.get_tracer()
        trace.configure(enabled=False)
    out = capsys.readouterr().out
    assert "[obs] phase breakdown" in out and "device_block" in out
    path = tracer.trace_path()
    assert path == str(tmp_path / "out" / "trace" / "trace_proc0.jsonl")
    port = StepBreakdown.from_records(load_records(path)).summary()
    ref = JStepBreakdown.from_records(jload_records(path)).summary()
    assert set(port["phases"]) == set(PHASES)
    assert set(ref["phases"]) == set(PHASES)
    assert (ref["steps"], ref["groups"]) == (port["steps"], port["groups"])
    assert port["steps"] == 9 and port["groups"] == 5   # 4 pairs + 1 single
    for phase in PHASES:
        assert ref["phases"][phase]["count"] == \
            port["phases"][phase]["count"], phase
    assert tracer._listeners == []


def test_a_raising_run_detaches_and_flushes(corpus_path, tmp_path):
    """A train() that raises still detaches its listeners and writes its
    spans (the crash-path flush)."""
    from pdnlp_tpu_torch.train.setup import setup_data, setup_model
    from pdnlp_tpu_torch.train.steps import build_eval_step, build_train_step
    from pdnlp_tpu_torch.train.trainer import Trainer
    from pdnlp_tpu_torch.utils.config import Args

    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                vocab_path=str(tmp_path / "vocab.txt"), data_limit=60,
                train_batch_size=16, output_dir=str(tmp_path))
    loader, _, tok = setup_data(args)
    cfg, state = setup_model(args, tok.vocab_size)
    tracer = Tracer(str(tmp_path / "tr"), enabled=True)
    cpu = torch.device("cpu")

    def boom(state, batch):
        raise RuntimeError("boom")

    t = Trainer(args, cfg, state, boom, build_eval_step(args), cpu,
                tracer=tracer)
    with pytest.raises(RuntimeError, match="boom"):
        t.train(loader)
    assert tracer._listeners == []
    names = {r["name"] for r in load_records(tracer.trace_path())}
    assert "data_wait" in names and CLOCK_SYNC in names
    ok = Trainer(args, cfg, state, build_train_step(args, cpu),
                 build_eval_step(args), cpu, tracer=tracer)
    ok.train(loader)
    assert ok.trace_summary["steps"] == len(loader)


def test_tracing_overhead_smoke():
    off = Tracer(enabled=False)
    on = Tracer(enabled=True, capacity=10_000)

    def loop(tr, n=500):
        t0 = time.perf_counter()
        acc = 0
        for i in range(n):
            with tr.span("step_dispatch", step=i):
                acc += sum(range(5000))
            tr.block(None)
        return time.perf_counter() - t0

    base = min(loop(off) for _ in range(5))
    traced = min(loop(on) for _ in range(5))
    assert traced < base * 2.0, (traced, base)
