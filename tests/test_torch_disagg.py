"""The port's disaggregated prefill/decode pools and their KV handoff, held
against the JAX package on the CPU: the twins of ``tests/test_disagg.py``
(parity of the split pools with interleaved decode over the ``local`` and
``socket`` transports, the staged page custody, the wire framing, the
handoff chain rule, the live re-split, a decode engine's death mid-storm)
on three warmed bert-tiny paged engines shared by the module; the export
payloads against JAX's engine on the same weights, the frames across the
two packages byte for byte, the split pools' tokens against JAX's router,
the int8 KV handoff, and ``serve.cli --decode --disagg``.  The
controller's split law (``test_split_law_*``) runs the same scripted fake
router through JAX's ``ServeController`` and the port's: the same
actuations and outcomes (``tests.test_torch_controller.twin``).  The
split router's ``control_snapshot()`` key tree is JAX's.

Tolerance: payloads at 2e-5 in fp32, int8 codes equal; tokens equal."""
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from pdnlp_tpu.serve import DecodeBatcher as JaxBatcher
from pdnlp_tpu.serve import handoff as jhandoff
from pdnlp_tpu.serve.decode import DecodeStream as JaxStream
from pdnlp_tpu.serve.decode import DisaggDecodeRouter as JaxDisagg
from pdnlp_tpu_torch.data.tokenizer import (
    WordPieceTokenizer, build_vocab, save_vocab,
)
from pdnlp_tpu_torch.obs.request import chain_issues, validate_chains
from pdnlp_tpu_torch.obs.trace import Tracer
from pdnlp_tpu_torch.serve import (
    DecodeBatcher, DecodeEngine, DecodeStream, DisaggDecodeRouter,
    PagedDecodeEngine, PrefillWorker,
)
from pdnlp_tpu_torch.serve.handoff import (
    ACK_ERR, HandoffChannel, HandoffError, HandoffServer, decode_frame,
    encode_frame,
)
from pdnlp_tpu_torch.serve.kvpage import handoff_owner
from pdnlp_tpu_torch.utils.config import Args

from tests.test_torch_speculate import jax_engine, jax_weights, port_engine  # noqa: F401,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["天地人你我", "好坏大小上下来去" * 5, "爱恨喜怒哀乐" * 15]
BUCKETS = (16, 32)
ATOL = 2e-5


@pytest.fixture(scope="module")
def vocab():
    return build_vocab(TEXTS, size=128)


@pytest.fixture(scope="module")
def tok(vocab):
    return WordPieceTokenizer(vocab)


def make_args(**kw):
    base = dict(model="bert-tiny", decode_slots=4, decode_max_len=48,
                max_new_tokens=8, kv_page_sz=8, device="cpu")
    base.update(kw)
    return Args(**base)


def prompts(tok, n=8, seed=3, lo=4, hi=14):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n)
    return [rng.integers(5, tok.vocab_size, int(k)).tolist() for k in lens]


@pytest.fixture(scope="module")
def fleet(tok):
    """Three warmed paged engines on one tracer (1 + 2 or 2 + 1); each
    test builds its own router, only the programs are shared."""
    tr = Tracer(enabled=True)
    engines = [PagedDecodeEngine(make_args(), tokenizer=tok,
                                 buckets=BUCKETS, tracer=tr)
               for _ in range(3)]
    for e in engines:
        e.warmup_decode()
        e.warmup_handoff()
    return engines


def disagg(fleet, **kw):
    kw.setdefault("prefill_engines", 1)
    kw.setdefault("max_waiting", 32)
    router = DisaggDecodeRouter(fleet, **kw).start()
    for u in router._units:
        u.eos_id = -1  # never stop early: deterministic lengths
    return router


def storm(router, ps, max_new=8, timeout=120):
    streams = [router.submit_ids(p, max_new_tokens=max_new) for p in ps]
    return streams, [s.result(timeout=timeout) for s in streams]


@pytest.fixture(scope="module")
def ref_outs(fleet, tok):
    """Interleaved (one batcher) greedy tokens of the module's prompts."""
    b = DecodeBatcher(fleet[0], max_waiting=32).start()
    b.eos_id = -1
    outs = [s.result(timeout=120) for s in
            [b.submit_ids(p, max_new_tokens=8) for p in prompts(tok)]]
    b.stop()
    return outs


def _leak_free(*engines):
    for e in engines:
        lk = e.leak_check()
        assert lk["ok"] and not lk["stream_owners"], lk


# --------------------------------------------------- twins of test_disagg

def test_disagg_bitwise_parity_zero_retrace(fleet, ref_outs, tok):
    """A storm through the split pools emits interleaved decode's tokens
    bit for bit, every stream crosses one handoff, no engine creates a
    program after warmup, and every allocator drains to zero."""
    r0 = sum(e.metrics.retraces.value for e in fleet)
    m0 = sum(e.metrics.cache_misses.value for e in fleet)
    router = disagg(fleet)
    streams, outs = storm(router, prompts(tok))
    hs = router.health_summary()
    snap = router.control_snapshot()
    router.stop()
    assert outs == ref_outs
    assert sum(e.metrics.retraces.value for e in fleet) == r0
    assert sum(e.metrics.cache_misses.value for e in fleet) == m0
    assert hs["handoffs"] == len(outs) and hs["handoff_failures"] == 0
    assert hs["by_pool"]["prefill"]["engines"] == 1
    assert hs["by_pool"]["decode"]["engines"] == 2
    assert snap["knobs"] == {"prefill_share": 0.333333,
                             "prefill_share_step": 0.333333}
    assert snap["latency"]["ttft_p99_ms"] is not None
    assert snap["latency"]["inter_token_p99_ms"] is not None
    assert {r["pool"] for r in snap["replicas"].values()} \
        == {"prefill", "decode"}
    report = validate_chains(fleet[0].tracer.records(),
                             [s.rid for s in streams])
    assert report["incomplete"] == {}
    assert report["complete"] == len(streams)
    assert report["handed_off"] == len(streams)
    assert report["streamed"] == len(streams)
    _leak_free(*fleet)


def test_disagg_socket_transport_parity(fleet, ref_outs, tok):
    """Every payload crosses the framed loopback socket: parity, the acks
    and the ``transport`` attr on each handoff hop."""
    router = disagg(fleet, transport="socket")
    streams, outs = storm(router, prompts(tok))
    servers = list(router._servers.values())
    router.stop()
    assert outs == ref_outs
    assert sum(s.frames_ok for s in servers) == len(outs)
    assert sum(s.frames_err for s in servers) == 0
    rids = {s.rid for s in streams}
    hops = [r["attrs"] for r in fleet[0].tracer.records()
            if r.get("name") == "hop"
            and (r.get("attrs") or {}).get("request_id") in rids
            and (r.get("attrs") or {}).get("hop") == "handoff"]
    assert len(hops) == len(outs)
    for h in hops:
        assert h["transport"] == "socket"
        assert h["pages"] >= 1 and h["bytes"] > 0
    report = validate_chains(fleet[0].tracer.records(), sorted(rids))
    assert report["incomplete"] == {}
    assert report["handed_off"] == len(outs)
    _leak_free(*fleet)


def test_handoff_custody_round_trip(fleet):
    """Export -> stage (references move to the ``#handoff`` owner, the
    slot frees at once) -> discharge; the importer seats the payload in a
    cold reservation and both ledgers reconcile; the geometry is checked
    before anything writes."""
    a, b = fleet[0], fleet[1]
    stream = DecodeStream([7, 9, 11, 13, 15, 17], max_new_tokens=8)
    a.attach_stream(0, stream, share=False)
    pk, pv = a.export_pages(0, request_ids=[stream.rid])
    staged, pages = a.begin_handoff(0)
    assert staged == handoff_owner(stream.rid)
    assert len(pages) >= 1
    lk = a.leak_check()
    assert staged in lk["stream_owners"]
    a.allocator.release_owner(staged)
    _leak_free(a)
    b.attach_stream(2, stream, share=False)
    b.import_pages(2, pk, pv, request_ids=[stream.rid])
    b.detach_slot(2)
    _leak_free(b)
    with pytest.raises(HandoffError, match="page geometry"):
        b.import_pages(b.slots, pk[:, :1], pv[:, :1])
    with pytest.raises(HandoffError, match="page geometry"):
        b.import_pages(b.slots, pk.to(torch.bfloat16), pv)
    with pytest.raises(ValueError, match="empty slot"):
        a.begin_handoff(0)


def test_disagg_ctor_validation(fleet, tok):
    with pytest.raises(ValueError, match=">= 2 engines"):
        DisaggDecodeRouter([fleet[0]])
    with pytest.raises(ValueError, match="transport"):
        DisaggDecodeRouter(fleet, transport="carrier-pigeon")
    slot_eng = DecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS)
    with pytest.raises(ValueError, match="PAGED"):
        DisaggDecodeRouter([fleet[0], slot_eng])
    with pytest.raises(ValueError, match="PAGED"):
        PrefillWorker(slot_eng, dispatch=lambda *a: None)


def test_handoff_frame_round_trip_and_torn_payloads():
    meta = {"rid": "r-1", "pos": 7, "next_token": 42, "n_pages": 2}
    k = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    v = (torch.arange(24, dtype=torch.int8) - 5).reshape(2, 3, 4)
    frame = encode_frame(meta, k, v)
    m2, k2, v2 = decode_frame(frame)
    assert m2 == meta
    assert k2.dtype == torch.float32 and torch.equal(k2, k)
    assert v2.dtype == torch.int8 and torch.equal(v2, v)
    with pytest.raises(HandoffError, match="bad magic"):
        decode_frame(b"HTTP" + frame[4:])
    with pytest.raises(HandoffError, match="torn handoff payload"):
        decode_frame(frame[:-3])
    flipped = bytearray(frame)
    flipped[len(frame) // 2] ^= 0xFF
    with pytest.raises(HandoffError, match="torn handoff payload"):
        decode_frame(bytes(flipped))


def test_handoff_socket_server_acks_and_refusals():
    got = []
    k = torch.ones((1, 2, 2))
    v = torch.zeros((1, 2, 2))
    with HandoffServer(
            lambda m, pk, pv: got.append((m, pk.clone(), pv.clone()))) as srv:
        with HandoffChannel(srv.address) as ch:
            ch.send({"rid": "a"}, k, v)
            ch.send({"rid": "b"}, k, v)
        assert srv.frames_ok == 2 and srv.frames_err == 0
        with socket.create_connection(srv.address, timeout=5) as raw:
            raw.sendall(b"JUNKJUNKJUNK")
            assert raw.recv(2) == ACK_ERR
    assert [m["rid"] for m, _, _ in got] == ["a", "b"]
    assert torch.equal(got[0][1], k)

    def refuse(m, pk, pv):
        raise RuntimeError("no seat")

    with HandoffServer(refuse) as srv:
        with HandoffChannel(srv.address) as ch:
            with pytest.raises(HandoffError, match="rejected"):
                ch.send({"rid": "c"}, k, v)
        assert srv.frames_err == 1


def H(hop, **kw):
    return {"attrs": {"hop": hop, **kw}}


def test_chain_rules_catch_handoff_violations():
    ok = [H("admit"), H("prefill"), H("handoff", pages=3), H("decode"),
          H("complete")]
    assert chain_issues(ok) == []
    recovery = [H("admit"), H("prefill"), H("handoff"), H("decode"),
                H("requeue"), H("prefill"), H("handoff"), H("decode"),
                H("complete")]
    assert chain_issues(recovery) == []
    bad = [H("admit"), H("handoff"), H("decode"), H("complete")]
    assert any("'handoff' hop with no earlier 'prefill'" in i
               for i in chain_issues(bad))


def test_live_resplit_rebalances_and_preserves_parity(fleet, ref_outs, tok):
    """``set_prefill_share`` re-roles engines on a live router: the split
    moves, a storm after it still gives the oracle's tokens, and nothing
    is captured again."""
    router = disagg(fleet)
    _, outs1 = storm(router, prompts(tok))
    assert outs1 == ref_outs
    applied = router.set_prefill_share(0.666666)
    assert applied == 0.666666
    assert router.knob_values()["prefill_share"] == 0.666666
    for u in router._units:
        u.eos_id = -1  # rebuilt units come back with the real sep id
    hs = router.health_summary()
    assert hs["by_pool"]["prefill"]["engines"] == 2
    assert hs["by_pool"]["decode"]["engines"] == 1
    r0 = sum(e.metrics.retraces.value for e in fleet)
    m0 = sum(e.metrics.cache_misses.value for e in fleet)
    _, outs2 = storm(router, prompts(tok))
    assert outs2 == ref_outs
    assert sum(e.metrics.retraces.value for e in fleet) == r0
    assert sum(e.metrics.cache_misses.value for e in fleet) == m0
    assert router.set_prefill_share(0.9) == 0.666666
    assert router.set_prefill_share(0.1) == 0.333333
    with pytest.raises(ValueError, match="unknown disagg knob"):
        router.apply_knob("draft_k", 3)
    router.stop()
    _leak_free(*fleet)


def test_decode_kill_mid_storm_recovers(fleet, tok):
    """A decode-role engine dies mid-storm: its orphans re-enter the front
    door, re-prefill, hand off again to the survivor, and every stream's
    tokens stay the oracle's (none lost or duplicated); chains validate and
    the survivors drain clean."""
    ps = prompts(tok, n=12, seed=7)
    b = DecodeBatcher(fleet[0], max_waiting=32).start()
    b.eos_id = -1
    refs = [s.result(timeout=120)
            for s in [b.submit_ids(p, max_new_tokens=16) for p in ps]]
    b.stop()
    router = disagg(fleet)
    streams = [router.submit_ids(p, max_new_tokens=16) for p in ps]
    victim = router._units[1]
    deadline = time.monotonic() + 60
    while victim.metrics.tokens_out_total.value < 10 \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    router.kill(1, RuntimeError("chaos: decode engine evicted"))
    outs = [s.result(timeout=180) for s in streams]
    router.stop()
    assert victim.dead
    assert outs == refs, "kill recovery duplicated or lost tokens"
    report = validate_chains(fleet[0].tracer.records(),
                             [s.rid for s in streams])
    assert report["incomplete"] == {}
    assert report["complete"] == len(streams)
    assert report["handed_off"] == len(streams)
    _leak_free(fleet[0], fleet[2])
    # the victim's ledger died with its worker; clear it for later tests
    fleet[1].reset_cache()


def test_no_live_prefill_fails_loudly(fleet):
    router = disagg(fleet)
    router.kill(0)  # the only prefill-role unit
    deadline = time.monotonic() + 10
    while not router._units[0].dead and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="no live prefill"):
        router.submit_ids([5, 6, 7])
    router.stop()


# ------------------------------------------------------ held against JAX

@pytest.mark.parametrize("kv", ["auto", "int8"], ids=["fp32", "int8"])
def test_export_pages_match_jax(tok, jax_weights, kv):
    """The same streams seated and prefilled in the port's engine and
    JAX's: each slot's exported payload agrees (int8 codes exactly), past
    the stream's pages too (the zero page against JAX's fill), and an
    import into another engine reproduces the pages."""
    ps = prompts(tok, n=3, seed=17, lo=9, hi=30)
    payloads = {}
    for name, mk, stream_cls in (("port", port_engine, DecodeStream),
                                 ("jax", jax_engine, JaxStream)):
        eng = mk(tok, jax_weights, kv)
        for i, p in enumerate(ps):
            eng.attach_stream(i, stream_cls(p, 8))
        eng.prefill_ids(ps, [0, 1, 2])
        payloads[name] = [eng.export_pages(i) for i in range(3)]
    for (pk, pv), (jk, jv) in zip(payloads["port"], payloads["jax"]):
        assert tuple(pk.shape) == np.shape(jk)
        if kv == "int8":
            assert pk.dtype == torch.int8
            np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
            np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
        else:
            np.testing.assert_allclose(pk.numpy(), np.asarray(jk), atol=ATOL)
            np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=ATOL)
    # import into a fresh engine and export again: the same bytes
    other = port_engine(tok, jax_weights, kv)
    stream = DecodeStream(ps[1], 8)
    other.attach_stream(3, stream, share=False)
    other.import_pages(3, *payloads["port"][1])
    back = other.export_pages(3)
    assert torch.equal(back[0], payloads["port"][1][0])
    assert torch.equal(back[1], payloads["port"][1][1])
    assert not other._cache_k[:, other.n_pages].any()   # the zero page


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_handoff_frames_cross_packages(dtype):
    """A frame either package encodes decodes in the other to the same
    values, and both encode the same bytes."""
    import ml_dtypes

    rng = np.random.default_rng(4)
    meta = {"rid": "r-9", "pos": 33, "next_token": 7, "prompt_len": 30,
            "n_pages": 3}
    raw = rng.standard_normal((2, 4, 8, 2, 64)).astype(np.float32)
    if dtype == "int8":
        jk = (raw * 40).clip(-127, 127).astype(np.int8)
        tk = torch.from_numpy(jk)
    elif dtype == "bfloat16":
        jk = raw.astype(ml_dtypes.bfloat16)
        tk = torch.from_numpy(raw).to(torch.bfloat16)
    else:
        jk, tk = raw, torch.from_numpy(raw)
    jv, tv = jk[::-1].copy(), tk.flip(0).contiguous()
    jframe = jhandoff.encode_frame(meta, jk, jv)
    tframe = encode_frame(meta, tk, tv)
    assert jframe == tframe
    m, k, v = decode_frame(jframe)
    assert m == meta and str(k.dtype) == f"torch.{dtype}"
    assert torch.equal(k, tk) and torch.equal(v, tv)
    m, k, v = jhandoff.decode_frame(tframe)
    assert m == meta and k.dtype.name == dtype
    np.testing.assert_array_equal(k.view(np.uint8), jk.view(np.uint8))
    np.testing.assert_array_equal(v.view(np.uint8), jv.view(np.uint8))


def test_disagg_tokens_match_jax(tok, jax_weights):
    """The port's split pools and JAX's, three engines each on the same
    weights, emit the same tokens as each package's interleaved batcher."""
    ps = prompts(tok, n=6, seed=29)
    outs = {}
    for name, mk, batcher_cls, router_cls in (
            ("port", port_engine, DecodeBatcher, DisaggDecodeRouter),
            ("jax", jax_engine, JaxBatcher, JaxDisagg)):
        engines = [mk(tok, jax_weights) for _ in range(3)]
        b = batcher_cls(engines[0]).start()
        b.eos_id = -1
        ref = [s.result(timeout=120) for s in
               [b.submit_ids(p, max_new_tokens=8) for p in ps]]
        b.stop()
        router = router_cls(engines, prefill_engines=1)
        router.warmup()
        router.start()
        for u in router._units:
            u.eos_id = -1
        outs[name] = [s.result(timeout=120) for s in
                      [router.submit_ids(p, max_new_tokens=8) for p in ps]]
        router.stop()
        assert outs[name] == ref
    assert outs["port"] == outs["jax"]


def test_int8_kv_handoff_same_scale_tables_and_parity(tok):
    """Two int8-KV engines on the same weights calibrate the same scale
    tables (the raw-code payload relies on it), the split pools give the
    interleaved int8 tokens, and tables that differ are refused at
    warmup."""
    engines = [PagedDecodeEngine(make_args(kv_dtype="int8"), tokenizer=tok,
                                 buckets=BUCKETS) for _ in range(3)]
    router = DisaggDecodeRouter(engines, prefill_engines=1)
    router.warmup()
    for e in engines[1:]:
        assert torch.equal(e._kv_scales[0], engines[0]._kv_scales[0])
        assert torch.equal(e._kv_scales[1], engines[0]._kv_scales[1])
    ps = prompts(tok, n=6, seed=31)
    b = DecodeBatcher(engines[0]).start()
    b.eos_id = -1
    ref = [s.result(timeout=120) for s in
           [b.submit_ids(p, max_new_tokens=8) for p in ps]]
    b.stop()
    router.start()
    for u in router._units:
        u.eos_id = -1
    _, outs = storm(router, ps)
    router.stop()
    assert outs == ref
    _leak_free(*engines)
    engines[2]._kv_scales[0].mul_(2.0)
    with pytest.raises(HandoffError, match="scale tables"):
        DisaggDecodeRouter(engines, prefill_engines=1).warmup()


@pytest.mark.parametrize("mode", ["local", "socket"])
def test_cli_disagg_gives_plain_decode_tokens(vocab, tmp_path, mode):
    """``serve.cli --decode --disagg <mode> --prefill_engines 1
    --decode_engines 2`` streams the plain ``--decode`` run's tokens."""
    import json

    vocab_path = str(tmp_path / "vocab.txt")
    save_vocab(vocab, vocab_path)

    def run(*extra):
        metrics = str(tmp_path / f"m{len(extra)}.json")
        r = subprocess.run(
            [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--decode",
             "--device", "cpu", "--model", "bert-tiny", "--vocab_path",
             vocab_path, "--decode_slots", "4", "--decode_max_len", "64",
             "--max_new_tokens", "6", "--metrics_path", metrics, *extra],
            input="天地人\n好坏大小\n爱恨喜怒哀乐\n天地人你我\n",
            capture_output=True, text=True, timeout=180, cwd=str(tmp_path),
            env={**os.environ, "PYTHONPATH": REPO})
        assert r.returncode == 0, r.stderr
        with open(metrics) as f:
            return r.stdout, json.load(f)

    plain, _ = run()
    split, snap = run("--disagg", "on" if mode == "local" else mode,
                      "--prefill_engines", "1", "--decode_engines", "2")
    assert split == plain
    assert snap["transport"] == mode and len(snap["replicas"]) == 3
    assert snap["replicas"]["0"]["pool"] == "prefill"
    assert snap["replicas"]["0"]["decode"]["handoffs_total"] == 4


# ---------------------------------------------- controller split law

class FakeDisaggRouter:
    """Router-shaped double exposing exactly what the pool-split law
    consumes: the ``prefill_share`` knob pair, the per-pool backlogs and
    the two latency signals, quantized like the real router
    (``tests/test_disagg.py:FakeDisaggRouter``, with the tracer of
    package ``P``)."""

    def __init__(self, P, n=3):
        self.n = n
        self.k = 1
        self.pb = 0.0
        self.db = 0.0
        self.ttft = 40.0
        self.itok = 12.0
        self.applied = []
        self.tracer = P.Tracer(enabled=True)

    @property
    def _step(self):
        return round(1.0 / self.n, 6)

    def knob_values(self):
        return {"prefill_share": round(self.k * self._step, 6),
                "prefill_share_step": self._step}

    def apply_knob(self, name, value):
        if name != "prefill_share":
            raise KeyError(name)
        self.k = max(1, min(self.n - 1, int(round(float(value) * self.n))))
        self.applied.append((name, round(self.k * self._step, 6)))

    def control_snapshot(self):
        return {
            "router": {"requests_total": 0, "deadline_expired_total": 0,
                       "queue_depth": 0.0, "admission": {}},
            "active": 1, "standby": 0,
            "knobs": self.knob_values(),
            "latency": {"ttft_p50_ms": self.ttft,
                        "ttft_p99_ms": self.ttft,
                        "inter_token_p50_ms": self.itok,
                        "inter_token_p99_ms": self.itok},
            "by_pool": {"prefill": {"backlog": self.pb},
                        "decode": {"backlog": self.db}},
        }


def _split_controller(P, n=3, **kw):
    from tests.test_elastic import FakeClock

    r = FakeDisaggRouter(P, n=n)
    clk = FakeClock()
    kw.setdefault("eval_window_s", 5.0)
    c = P.ServeController(r, clock=clk, tracer=r.tracer, **kw)
    assert c.step() is None  # first tick only primes the counter deltas
    clk.advance(1.0)
    return c, r, clk


def _split_tick(c, r, clk, pb=0.0, db=0.0, dt=1.0):
    r.pb, r.db = pb, db
    s = c.step()
    clk.advance(dt)
    return s


def _split_grows_and_shrinks(P):
    c, r, clk = _split_controller(P, n=3)
    _split_tick(c, r, clk, pb=5.0)   # flapping pressure: no verdict
    _split_tick(c, r, clk)
    _split_tick(c, r, clk, pb=5.0)
    _split_tick(c, r, clk)
    assert r.applied == []
    _split_tick(c, r, clk, pb=5.0)   # two consecutive: one quantum
    _split_tick(c, r, clk, pb=5.0)
    assert r.applied == [("prefill_share", 0.666666)]
    assert r.knob_values()["prefill_share"] == 0.666666
    clk.advance(11.0)
    _split_tick(c, r, clk, db=5.0)
    _split_tick(c, r, clk, db=5.0)
    assert r.applied[-1] == ("prefill_share", 0.333333)
    clk.advance(6.0)
    for _ in range(2):
        _split_tick(c, r, clk)
    c.stop()
    rep = P.decision.validate_decisions(r.tracer.records())
    assert rep["incomplete"] == {}
    assert rep["by_knob"].get("prefill_share", 0) >= 2
    return [(c, r)]


def test_split_law_grows_and_shrinks_on_sustained_backlog():
    from tests.test_torch_controller import twin

    log = twin(_split_grows_and_shrinks)
    acts = [(a["old"], a["new"], a["signal"]) for a in log[0][0]
            if a["phase"] == "action"]
    assert acts == [(0.333333, 0.666666, "inter_token_p99_ms"),
                    (0.666666, 0.333333, "ttft_p99_ms")]


def _split_never_empties(P):
    c, r, clk = _split_controller(P, n=2)
    for _ in range(5):
        _split_tick(c, r, clk, pb=9.0)
    assert r.applied == []
    return [(c, r)]


def test_split_law_never_empties_a_pool():
    from tests.test_torch_controller import twin

    twin(_split_never_empties)


def test_disagg_control_snapshot_keys_match_jax(fleet, tok, jax_weights):
    """``DisaggDecodeRouter.control_snapshot()`` has JAX's key tree — the
    split law reads ``latency.ttft_p99_ms`` / ``inter_token_p99_ms`` and
    ``by_pool.<pool>.backlog`` there — and the same knobs."""
    from tests.test_torch_controller import key_tree

    ours = DisaggDecodeRouter(fleet, prefill_engines=1)
    ref = JaxDisagg([jax_engine(tok, jax_weights) for _ in range(3)],
                    prefill_engines=1)
    got, want = ours.control_snapshot(), ref.control_snapshot()
    assert key_tree(got) == key_tree(want)
    assert {"ttft_p99_ms", "inter_token_p99_ms"} <= set(got["latency"])
    assert "backlog" in got["by_pool"]["prefill"]
    assert ours.knob_values() == ref.knob_values()
