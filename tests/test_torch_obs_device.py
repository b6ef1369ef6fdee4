"""The tracer's device spans (``pdnlp_tpu_torch.obs.device``) and its host
spans on the profiler's clock.

On the CPU a stand-in ring (:class:`FakeRing`: the card's ring semantics,
slot = counter mod capacity, entries written as the stream would run the
marks) drives the tracer's log, drain and decoder, and the model's marks
run through a real train step.  The ``cuda`` tests run the mark kernel on
the card: captured groups, the ring against the profiler, a traced run of
the benchmark's first group.  Nothing here imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_obs_device.py
"""
import json

import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.obs import StepBreakdown
from pdnlp_tpu_torch.obs import trace as trace_mod
from pdnlp_tpu_torch.obs.trace import CLOCK_SYNC, DEVICE_RING, Tracer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the CPU backward is bit for bit only so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


class FakeRing:
    """The card's ring on the host: ``launch`` writes ``(time, code)`` at
    slot counter mod capacity, each mark 1 us after the last; under a
    "capture" a launch writes nothing until :meth:`run` replays it."""

    def __init__(self, capacity=64):
        self.capacity = capacity
        self.ring = np.zeros((capacity, 2), np.int64)
        self.counter = 0
        self.offset_s = 0.0
        self.capture = False
        self.t = 0
        self._copy = None

    def capturing(self):
        return self.capture

    def launch(self, code):
        if not self.capture:
            self._write(code)

    def _write(self, code):
        self.t += 1000
        self.ring[self.counter & (self.capacity - 1)] = (self.t, code)
        self.counter += 1

    def run(self, rec):
        """One replay of the graph ``rec`` recorded."""
        for code, _step in rec.marks:
            self._write(code)

    def start_copy(self, first, count):
        idx = [(first + i) & (self.capacity - 1) for i in range(count)]
        self._copy = (self.counter, self.ring[idx].copy())

    def ready(self):
        return True

    def wait(self):
        pass

    def copied(self):
        return self._copy


def _device_records(tr):
    return [r for r in tr.records() if r.get("device")]


def _spans(tr, name):
    return [r for r in _device_records(tr) if r["name"] == name]


# ------------------------------------------------------------ off: no-op


def test_disabled_or_cpu_device_span_is_the_noop_and_allocates_nothing():
    from pdnlp_tpu_torch.ops import cuda_lib

    for tr in (Tracer(enabled=False, device="cuda"),
               Tracer(enabled=True, device="cpu"), Tracer(enabled=True)):
        assert not tr.device_spans
        assert tr.device_span("step", step=0) is trace_mod._NULL_SPAN
        tr.device_mark("attn.bwd", True, layer=0)
        with tr.device_capture(0) as rec:
            assert rec is None
        tr.device_replay(rec, 0)
        assert tr.drain_device() is None
        assert tr._dev is None and tr.records() == []
    assert "trace_mark" not in cuda_lib._LOADED
    assert "trace_mark" not in cuda_lib.SOURCES


# ---------------------------------------------------------- the decoder


def _step(tr, step, layers=2):
    with tr.device_span("step", step=step):
        with tr.device_span("embed.fwd"):
            pass
        for i in range(layers):
            with tr.device_span("attn.fwd", layer=i):
                pass
        with tr.device_span("optimizer"):
            pass


def test_decoder_follows_eager_steps_replays_and_a_leftover():
    ring = FakeRing(capacity=64)
    tr = Tracer(enabled=True, ring=ring)
    _step(tr, 0)                                    # an eager step
    ring.capture = True                             # a group of 2, captured
    with tr.device_capture(1) as rec:
        _step(tr, 1)
        _step(tr, 2)
    ring.capture = False
    assert len(rec.marks) == 2 * 10
    for first in (1, 3):                            # two replays
        tr.device_replay(rec, first)
        ring.run(rec)
    _step(tr, 5)                                    # the eager leftover
    stats = tr.drain_device()
    assert stats == {"marks": 10 * 6, "spans": 5 * 6, "overflow": 0,
                     "mismatched": 0}
    steps = _spans(tr, "step")
    assert [r["attrs"]["step"] for r in steps] == [0, 1, 2, 3, 4, 5]
    # 10 marks a step, each 1 us after the last: begin to end 9 us
    assert all(r["dur"] == pytest.approx(9e-6) for r in steps)
    attn = _spans(tr, "attn.fwd")
    assert [(r["attrs"]["step"], r["attrs"]["layer"]) for r in attn] == [
        (s, i) for s in range(6) for i in range(2)]
    assert all(r["dur"] == pytest.approx(1e-6) and r["device"]
               and r["depth"] == 1 for r in attn)
    for s in steps:                # every span lies inside its step's
        inner = [r for r in tr.records() if r.get("device")
                 and r["attrs"].get("step") == s["attrs"]["step"]]
        assert len(inner) == 5
        assert all(s["t0"] <= r["t0"] and r["t0"] + r["dur"]
                   <= s["t0"] + s["dur"] + 1e-12 for r in inner)


def test_overflow_is_counted_and_the_tail_still_decodes(tmp_path):
    ring = FakeRing(capacity=8)
    tr = Tracer(str(tmp_path), enabled=True, ring=ring, process_index=0)
    ring.capture = True
    with tr.device_capture(0) as rec:
        _step(tr, 0)
        _step(tr, 1)
    ring.capture = False
    tr.device_replay(rec, 0)
    ring.run(rec)                 # 20 marks into 8 slots before a read
    _step(tr, 2)
    stats = tr.drain_device()
    # 20 replayed marks and the eager step's first before the first read:
    # 13 overwritten, 8 left: step 1's from its attention on, whose
    # spans keep their step; the eager step after them decodes whole
    assert stats["overflow"] == 13 and stats["mismatched"] == 0
    assert [(r["name"], r["attrs"].get("step")) for r in tr.records()] == [
        ("attn.fwd", 1), ("attn.fwd", 1), ("optimizer", 1), ("embed.fwd", 2),
        ("attn.fwd", 2), ("attn.fwd", 2), ("optimizer", 2), ("step", 2)]
    path = tr.flush()
    with open(path) as f:
        meta = [json.loads(line) for line in f]
    ring_rec = [r for r in meta if r["name"] == DEVICE_RING]
    assert ring_rec and ring_rec[0]["attrs"]["overflow"] == 13
    sync = [r for r in meta if r["name"] == CLOCK_SYNC]
    assert sync and "profiler_ns" in sync[0]["attrs"]


def test_suspended_marks_and_foreign_captures_stay_out_of_the_log():
    ring = FakeRing()
    tr = Tracer(enabled=True, ring=ring)
    with tr.device_suspended():
        _step(tr, 0)
    ring.capture = True           # someone else's capture: no recording
    _step(tr, 0)
    ring.capture = False
    assert ring.counter == 0
    _step(tr, 0)
    assert tr.drain_device()["spans"] == 5


def test_step_breakdown_ignores_device_records():
    bd = StepBreakdown()
    for name in ("device_block", "h2d_put", "step"):
        bd.feed({"name": name, "t0": 0.0, "dur": 1.0, "tid": -1,
                 "depth": 0, "attrs": {"step": 3, "n": 1},
                 "device": True})
    assert bd.steps == 0 and bd.groups == 0
    bd.feed({"name": "device_block", "t0": 0.0, "dur": 1.0, "tid": 0,
             "depth": 0})
    assert bd.steps == 1


# ------------------------------------------------- the model's own marks


def _batches(n, B=4, S=32, seed=0, vocab=120):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.zeros((B, S), np.int32)
        for b in range(B):
            mask[b, : rng.randint(4, S + 1)] = 1
        out.append({
            "input_ids": torch.from_numpy(
                (rng.randint(5, vocab, (B, S)) * mask).astype(np.int32)),
            "token_type_ids": torch.zeros((B, S), dtype=torch.int32),
            "attention_mask": torch.from_numpy(mask),
            "label": torch.from_numpy(rng.randint(0, 6, B).astype(np.int32)),
            "example_weight": torch.ones(B)})
    return out


def _two_steps(model):
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step
    from pdnlp_tpu_torch.utils.config import Args

    args = Args(model=model, device="cpu", dropout=0.1, attn_dropout=0.0,
                learning_rate=1e-3, fuse_steps=1)
    _, state = setup_model(args, 120)
    step = build_train_step(args, "cpu")
    out = []
    for b in _batches(2):
        m = step(state, b)
        out.append((m["loss"].clone(),
                    {n: p.grad.clone() for n, p in
                     state.model.named_parameters() if p.grad is not None}))
    return out


@pytest.mark.parametrize("model", ["bert-tiny", "bert-tiny-moe"])
def test_model_marks_leave_loss_and_gradients_bit_identical(
        model, monkeypatch):
    plain = _two_steps(model)
    tr = Tracer(enabled=True, ring=FakeRing(capacity=1 << 12))
    monkeypatch.setattr(trace_mod, "_default", tr)
    traced = _two_steps(model)
    for (la, ga), (lb, gb) in zip(plain, traced):
        assert torch.equal(la, lb)
        assert ga.keys() == gb.keys()
        assert all(torch.equal(ga[n], gb[n]) for n in ga)
    stats = tr.drain_device()
    assert stats["overflow"] == stats["mismatched"] == 0
    layers = 2
    names = ["step", "optimizer", "embed.fwd", "embed.bwd"]
    want = {n: 2 for n in names}
    want.update({"attn.fwd": 2 * layers, "attn.bwd": 2 * layers})
    if model.endswith("moe"):
        want.update({"moe.fwd": 2 * layers, "moe.bwd": 2 * layers})
    got = {}
    for r in _device_records(tr):
        got[r["name"]] = got.get(r["name"], 0) + 1
    assert got == want
    assert stats["spans"] == sum(want.values())
    for r in _device_records(tr):
        assert r["attrs"]["step"] in (0, 1)
        if r["name"].startswith(("attn", "moe")):
            assert r["attrs"]["layer"] in range(layers)
    # the backward spans lie after the forward's, inside the step
    for s in (0, 1):
        one = {r["name"] + str(r["attrs"].get("layer", "")): r
               for r in _device_records(tr) if r["attrs"]["step"] == s}
        assert one["embed.fwd"]["t0"] < one["attn.fwd1"]["t0"] \
            < one["attn.bwd1"]["t0"] < one["attn.bwd0"]["t0"] \
            < one["embed.bwd"]["t0"] < one["optimizer"]["t0"]


# ------------------------------------------- host spans on the profiler


def test_spans_open_profiler_ranges_only_under_a_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer(str(tmp_path), enabled=True, process_index=0)
    with tr.span("lr_rows") as sp:
        assert sp._range is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("graph_replay"):
            with tr.span("outputs"):
                pass
    events = {e.name: e for e in prof.events()}
    assert "pdnlp.graph_replay" in events and "pdnlp.outputs" in events
    assert "pdnlp.lr_rows" not in events
    # the flush's anchor puts the tracer's clock on the profiler's
    path = tr.flush()
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    sync = next(r for r in recs if r["name"] == CLOCK_SYNC)
    span = next(r for r in recs if r["name"] == "graph_replay")
    start_ns = sync["attrs"]["profiler_ns"] \
        + (span["t0"] - sync["t0"]) * 1e9
    kin = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "pdnlp.graph_replay"]
    assert abs(kin[0].start_ns() - start_ns) < 5e6


# ------------------------------------------------------- on the card


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the mark kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cuda_batches(n, B=8, S=64):
    return [{k: v.to("cuda") for k, v in b.items()}
            for b in _batches(n, B, S)]


def _captured(model, tracer, monkeypatch, keep_graph=False):
    """A captured group of 4 replayed twice, then one eager step, with
    ``tracer`` as the process's tracer."""
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_multi_step, build_train_step
    from pdnlp_tpu_torch.utils.config import Args

    monkeypatch.setattr(trace_mod, "_default", tracer)
    if keep_graph:
        monkeypatch.setattr(
            torch.cuda, "CUDAGraph",
            lambda: torch.cuda.graphs.CUDAGraph(keep_graph=True))
    args = Args(model=model, device="cuda", dropout=0.1, attn_dropout=0.0,
                learning_rate=1e-3, fuse_steps=4, dtype="bfloat16")
    _, state = setup_model(args, 120, total_steps=9)
    step = build_train_step(args, "cuda")
    multi = build_multi_step(step, "cuda")
    b = _cuda_batches(9)
    for g in (b[:4], b[4:8]):
        multi(state, {k: torch.stack([x[k] for x in g]) for k in g[0]})
    step(state, b[8])
    torch.cuda.synchronize()
    return state, multi


@pytest.mark.cuda
@pytest.mark.parametrize("model,layers", [("bert-base", 12),
                                          ("bert-tiny-moe", 2)])
def test_captured_group_gives_k_step_spans_and_a_span_per_layer(
        cuda_device, monkeypatch, model, layers):
    tr = Tracer(enabled=True, device="cuda")
    _captured(model, tr, monkeypatch)
    stats = tr.drain_device()
    assert stats["overflow"] == stats["mismatched"] == 0
    steps = _spans(tr, "step")
    assert [r["attrs"]["step"] for r in steps] == list(range(9))
    for name in ("attn.fwd", "attn.bwd") + (
            ("moe.fwd", "moe.bwd") if model.endswith("moe") else ()):
        recs = _spans(tr, name)
        assert sorted((r["attrs"]["step"], r["attrs"]["layer"])
                      for r in recs) == [(s, i) for s in range(9)
                                         for i in range(layers)]
        assert all(r["dur"] > 0 for r in recs)
    for name in ("embed.fwd", "embed.bwd", "optimizer"):
        assert [r["attrs"]["step"] for r in _spans(tr, name)] \
            == list(range(9))
    for s in steps:
        inner = [r for r in _device_records(tr) if r["name"] != "step"
                 and r["attrs"]["step"] == s["attrs"]["step"]]
        assert sum(r["dur"] for r in inner) < s["dur"]
        assert all(s["t0"] - 2e-6 <= r["t0"] and r["t0"] + r["dur"]
                   <= s["t0"] + s["dur"] + 2e-6 for r in inner)


def _graph_nodes(graph) -> int:
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                               None, ctypes.byref(n))
    assert err == 0, err
    return n.value


@pytest.mark.cuda
def test_untraced_capture_is_the_parents_graph(cuda_device, monkeypatch):
    from pdnlp_tpu_torch.ops import cuda_lib

    bind = cuda_lib.bind

    def untraced_bind(name, fns):
        assert name != "trace_mark", "an untraced capture loads the marks"
        return bind(name, fns)

    runs = []
    for on in (False, True, False):
        tr = Tracer(enabled=on, device="cuda")
        monkeypatch.setattr(cuda_lib, "bind", bind if on else untraced_bind)
        _, multi = _captured("bert-tiny", tr, monkeypatch, keep_graph=True)
        (g,) = multi.graphs.values()
        runs.append((g.launches, _graph_nodes(g.graph),
                     0 if g.marks is None else len(g.marks.marks)))
        assert (g.marks is None and tr._dev is None) is not on
    off, on, off_again = runs
    assert off == off_again and off[2] == 0
    assert on[0] == off[0]                     # the kernels' launches
    # 16 marks a step: step, optimizer, embed and 2 layers' attention
    assert on[1] == off[1] + on[2] and on[2] == 4 * 16


@pytest.mark.cuda
def test_ring_durations_agree_with_the_profiler(cuda_device, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer(enabled=True, device="cuda")
    state, multi = _captured("bert-tiny", tr, monkeypatch)
    tr.drain_device()
    n0 = len(_device_records(tr))
    (g,) = multi.graphs.values()
    b = _cuda_batches(4)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        multi(state, {k: torch.stack([x[k] for x in b]) for k in b[0]})
        torch.cuda.synchronize()
    tr.drain_device()
    kin = sorted((e.start_ns(), e.end_ns()) for e in
                 prof.profiler.kineto_results.events()
                 if "trace_mark_kernel" in e.name())
    assert len(kin) == len(g.marks.marks)
    # the replay's marks, in slot order, and its spans by begin and end
    codes = [c for c, _ in g.marks.marks]
    at = {}
    for i, code in enumerate(codes):
        at.setdefault(code, []).append(kin[i][0])
    recs = _device_records(tr)[n0:]
    seen = {}
    dev = tr._dev
    for r in recs:
        key = (r["name"], tuple(sorted((k, v) for k, v in r["attrs"].items()
                                       if k != "step")))
        sid = dev._codes[key]
        i = seen.get(sid, 0)
        seen[sid] = i + 1
        prof_s = (at[2 * sid + 1][i] - at[2 * sid][i]) / 1e9
        assert abs(r["dur"] - prof_s) <= 2e-6 + 0.01 * prof_s, r


@pytest.mark.cuda
def test_traced_first_group_still_passes_the_benchmark_check(
        cuda_device, monkeypatch):
    from gpubench import harness
    from gpubench.tests import tiny

    port_args = harness.port_args

    def traced(*a, **kw):
        args = port_args(*a, **kw)
        args.trace = True
        args.trace_dir = str(args.output_dir) + "/trace"
        return args

    monkeypatch.setattr(harness, "port_args", traced)
    monkeypatch.setattr(trace_mod, "_default", trace_mod._default)
    for name in tiny.cells():
        r = harness.run(tiny.cell(name), 2 ** 31 + 93, 0.5, trace=False,
                        device="cuda")
        assert r["correct"] is True, r["checks"]
        tr = trace_mod.get_tracer()
        assert tr.device_spans
        tr.drain_device()
        assert _spans(tr, "step")
