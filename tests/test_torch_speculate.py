"""The port's speculative decoding (draft-k / verify-1), held against the JAX
package on the CPU: the twins of ``tests/test_speculate.py``'s engine,
batcher, chain and router tests on the port's paged engines (bert-tiny,
one warmed primary + drafter pair shared by the module), the verify
window's logits against JAX's engine on the same weights, the speculative
tokens against JAX's speculating batcher, a rejected round followed by an
accepted one, and ``serve.cli --decode --speculate``.  The controller's
speculation law (``test_law_*``) runs the same scripted fake router through
JAX's ``ServeController`` and the port's: the same actuations and
outcomes (``tests.test_torch_controller.twin``).  The decode router's
``control_snapshot()`` key tree is JAX's.

Tolerance: verify logits at 2e-5 in fp32 (int8 KV: the same bound on the
same int8 codes); tokens equal."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pdnlp_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import decoder as jdec
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.serve import DecodeBatcher as JaxBatcher
from pdnlp_tpu.serve import PagedDecodeEngine as JaxPagedEngine
from pdnlp_tpu.serve.decode import DecodeStream as JaxStream
from pdnlp_tpu.train import checkpoint as jckpt
from pdnlp_tpu.utils.config import Args as JaxArgs
from pdnlp_tpu_torch.data.tokenizer import (
    WordPieceTokenizer, build_vocab, save_vocab,
)
from pdnlp_tpu_torch.obs.decision import validate_decisions
from pdnlp_tpu_torch.obs.exporter import prometheus_lines
from pdnlp_tpu_torch.obs.request import chain_issues, validate_chains
from pdnlp_tpu_torch.obs.trace import Tracer
from pdnlp_tpu_torch.serve import (
    DecodeBatcher, DecodeEngine, DecodeRouter, DecodeStream,
    PagedDecodeEngine,
)
from pdnlp_tpu_torch.utils.config import Args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["天地人你我", "好坏大小上下来去" * 5, "爱恨喜怒哀乐" * 15]
BUCKETS = (16, 32)
DRAFT_K = 4
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


def jax_args(**kw):
    base = dict(model="bert-tiny", decode_slots=4, decode_max_len=48,
                max_new_tokens=8, kv_page_sz=8)
    base.update(kw)
    return JaxArgs(**base)


def prompts(tok, n=8, seed=3, lo=4, hi=14):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n)
    return [rng.integers(5, tok.vocab_size, int(k)).tolist() for k in lens]


@pytest.fixture(scope="module")
def spair(tok):
    """ONE warmed primary + drafter pair (identical seeded weights: the
    acceptance ceiling) shared by the batcher tests; stream state lives on
    each fresh batcher.  One in-memory tracer spans the pair."""
    tr = Tracer(enabled=True)
    eng = PagedDecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS,
                            tracer=tr)
    dr = PagedDecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS,
                           tracer=tr, prefix_share=False)
    DecodeBatcher(eng, drafter=dr, draft_k=DRAFT_K).warmup()
    return eng, dr


def spec_batcher(spair, **kw):
    eng, dr = spair
    kw.setdefault("draft_k", DRAFT_K)
    return DecodeBatcher(eng, max_waiting=16, drafter=dr, **kw).start()


def run_streams(batcher, ps, max_new=8, eos=-1, timeout=120):
    batcher.eos_id = eos  # -1: never stop early (deterministic lengths)
    streams = [batcher.submit_ids(p, max_new_tokens=max_new) for p in ps]
    return streams, [s.result(timeout=timeout) for s in streams]


@pytest.fixture(scope="module")
def ref_outs(spair, tok):
    """Plain greedy tokens of the module's prompts: the oracle every
    speculative storm is held to."""
    eng, _ = spair
    b = DecodeBatcher(eng, max_waiting=16).start()
    _, outs = run_streams(b, prompts(tok))
    b.stop()
    return outs


# ------------------------------------------------ twins of test_speculate

def test_speculative_bitwise_parity(spair, ref_outs, tok):
    """Draft-k / verify-1 emits plain greedy's tokens bit for bit, with no
    new program after warmup on either engine and no leaked page."""
    eng, dr = spair
    b = spec_batcher(spair)
    r0 = eng.metrics.retraces.value + dr.metrics.retraces.value
    m0 = eng.metrics.cache_misses.value + dr.metrics.cache_misses.value
    _, outs = run_streams(b, prompts(tok))
    snap = b.spec_snapshot()
    b.stop()
    assert outs == ref_outs
    assert eng.metrics.retraces.value + dr.metrics.retraces.value == r0
    assert eng.metrics.cache_misses.value \
        + dr.metrics.cache_misses.value == m0
    assert snap["enabled"] and snap["draft_k"] == DRAFT_K
    assert snap["rounds"] > 0 and snap["draft_tokens"] > 0
    assert snap["accept_rate"] > 0.9
    assert set(snap["by_model"]) == {"bert-tiny", "bert-tiny-draft"}
    for e in (eng, dr):
        lk = e.leak_check()
        assert lk["ok"] and not lk["stream_owners"], lk


def test_drafter_kill_mid_storm_degrades(spair, ref_outs, tok):
    """The drafter dies mid-storm: the pair degrades to plain decode, no
    stream stalls or is lost, the tokens stay plain greedy's, the
    drafter's pages come home, and the degrade is decision-recorded."""
    eng, dr = spair
    b = spec_batcher(spair)
    b.eos_id = -1
    streams = [b.submit_ids(p, max_new_tokens=8) for p in prompts(tok)]
    b.kill_drafter(RuntimeError("chaos: drafter OOM"))
    outs = [s.result(timeout=120) for s in streams]
    deaths = b.metrics.drafter_deaths_total.value
    b.stop()
    assert outs == ref_outs
    assert b.drafter is None
    assert deaths >= 1
    lk = dr.leak_check()
    assert lk["ok"] and not lk["stream_owners"], lk
    rep = validate_decisions(eng.tracer.records())
    assert rep["incomplete"] == {}
    assert rep["by_knob"].get("draft_k", 0) >= 1


def test_set_draft_k_clamps_pause_resume(spair, ref_outs, tok):
    """``set_draft_k`` clamps to ``[0, DRAFT_K_MAX]``; 0 pauses speculation
    (plain rounds, tokens unchanged) and a resume speculates again."""
    b = spec_batcher(spair)
    b.set_draft_k(99)
    assert b.draft_k == b.DRAFT_K_MAX
    b.set_draft_k(-3)
    assert b.draft_k == 0
    rounds0 = b.spec_snapshot()["rounds"]
    _, outs = run_streams(b, prompts(tok))
    assert outs == ref_outs
    assert b.spec_snapshot()["rounds"] == rounds0
    b.set_draft_k(DRAFT_K)
    _, outs = run_streams(b, prompts(tok))
    assert outs == ref_outs
    assert b.spec_snapshot()["rounds"] > rounds0
    b.stop()


def test_draft_verify_chains_round_trip(spair, tok):
    """Every speculated stream's chain validates: draft hops carry k and
    the drafter's model, verify hops ``matched <= k`` and a monotone
    ``accepted``; ``validate_chains`` counts them speculated."""
    eng, _ = spair
    b = spec_batcher(spair)
    streams, _ = run_streams(b, prompts(tok, n=4, seed=11))
    b.stop()
    rids = [s.rid for s in streams]
    records = eng.tracer.records()
    report = validate_chains(records, rids)
    assert report["incomplete"] == {}
    assert report["complete"] == len(rids)
    assert report["speculated"] == len(rids)
    assert report["accept_rate"] is not None
    hops = [r.get("attrs") or {} for r in records
            if (r.get("attrs") or {}).get("request_id") in set(rids)]
    drafts = [a for a in hops if a.get("hop") == "draft"]
    verifies = [a for a in hops if a.get("hop") == "verify"]
    assert drafts and len(drafts) == len(verifies)
    for a in drafts:
        assert a["k"] == DRAFT_K
        assert a["drafter_model"] == "bert-tiny"
    for a in verifies:
        assert 0 <= a["matched"] <= a["k"]
        assert a["accepted"] >= a["matched"]


def H(hop, **kw):
    return {"attrs": {"hop": hop, **kw}}


def test_chain_rules_catch_spec_violations():
    ok = [H("admit"), H("prefill"),
          H("draft", k=4), H("verify", k=4, matched=2, accepted=2),
          H("draft", k=4), H("verify", k=4, matched=4, accepted=6),
          H("complete")]
    assert chain_issues(ok) == []
    bad = [H("admit"), H("prefill"), H("verify", accepted=1),
           H("complete")]
    assert any("not immediately preceded" in i for i in chain_issues(bad))
    bad = [H("admit"), H("prefill"), H("draft", k=4), H("complete")]
    assert any("not immediately followed" in i for i in chain_issues(bad))
    bad = [H("admit"), H("draft", k=4), H("verify", accepted=1),
           H("complete")]
    assert any("no earlier 'prefill'" in i for i in chain_issues(bad))
    bad = [H("admit"), H("prefill"),
           H("draft", k=4), H("verify", accepted=4),
           H("draft", k=4), H("verify", accepted=2), H("complete")]
    assert any("monotone" in i for i in chain_issues(bad))


def test_router_spec_knob_and_exporter_labels(spair):
    """The router's ``draft_k`` knob (present only when a pair
    speculates), the ``/healthz`` block and the per-model labels."""
    eng, dr = spair
    router = DecodeRouter([eng], drafters=[dr], draft_k=DRAFT_K)
    assert router.knob_values() == {"draft_k": DRAFT_K}
    router.apply_knob("draft_k", 2)
    assert router.batchers[0].draft_k == 2
    with pytest.raises(ValueError):
        router.apply_knob("hedge_ms", 1.0)
    router.apply_knob("draft_k", DRAFT_K)
    hs = router.health_summary()
    assert hs["speculating"] == 1 and hs["draft_k"] == DRAFT_K
    assert {"alive", "replicas", "accept_rate", "drafter_deaths"} <= set(hs)
    snap = router.control_snapshot()
    assert "by_model" in snap["speculation"]
    text = "\n".join(prometheus_lines("decode", snap))
    assert 'model="bert-tiny-draft"' in text
    assert DecodeRouter([eng]).knob_values() == {}


def test_batcher_rejects_bad_drafter_pairings(spair, tok):
    """The four refusals: a slot engine on either side, a drafter of
    other geometry, a prefix-sharing drafter, another vocab."""
    eng, dr = spair
    slot_eng = DecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS)
    with pytest.raises(ValueError, match="PAGED"):
        DecodeBatcher(eng, drafter=slot_eng)
    with pytest.raises(ValueError, match="prefix_share"):
        DecodeBatcher(eng, drafter=eng)
    short = PagedDecodeEngine(make_args(decode_max_len=32), tokenizer=tok,
                              buckets=BUCKETS, prefix_share=False)
    with pytest.raises(ValueError, match="geometry"):
        DecodeBatcher(eng, drafter=short)
    other = WordPieceTokenizer(build_vocab(TEXTS + ["金木水火土"], size=128))
    assert other.vocab_size != tok.vocab_size
    foreign = PagedDecodeEngine(make_args(), tokenizer=other,
                                buckets=BUCKETS, prefix_share=False)
    with pytest.raises(ValueError, match="tokenizer"):
        DecodeBatcher(eng, drafter=foreign)


# ------------------------------------------------------ held against JAX

@pytest.fixture(scope="module")
def jax_weights(tok, tmp_path_factory):
    """JAX's seeded params and LM head, and the files the port loads them
    from."""
    from flax import serialization

    cfg = jax_get_config("bert-tiny", vocab_size=tok.vocab_size,
                         num_labels=6)
    params = jax.tree_util.tree_map(
        np.asarray, jbert.init_params(jax.random.key(0), cfg))
    head = jax.tree_util.tree_map(
        np.asarray, jdec.init_lm_head(jax.random.key(1), cfg))
    d = tmp_path_factory.mktemp("jaxspec")
    path = str(d / "gen-cls.msgpack")
    jckpt.save(path, params)
    head_path = str(d / "gen-head.msgpack")
    jckpt.publish(head_path, serialization.to_bytes(head))
    ks, vs = jdec.calibrate_kv_scales(params, cfg)
    scales_path = str(d / "jax.kvscales.msgpack")
    jckpt.publish(scales_path, serialization.to_bytes(
        {"k_scale": np.asarray(ks), "v_scale": np.asarray(vs)}))
    return params, head, path, head_path, scales_path, \
        (np.asarray(ks), np.asarray(vs))


def port_engine(tok, jax_weights, kv="auto", **kw):
    _, _, path, head_path, scales_path, _ = jax_weights
    eng = PagedDecodeEngine(make_args(kv_dtype=kv), tokenizer=tok,
                            buckets=BUCKETS, **kw)
    eng.load_checkpoint(path)
    eng.load_lm_head(head_path)
    if kv == "int8":
        eng.load_kv_scales(scales_path)
    return eng


def jax_engine(tok, jax_weights, kv="auto", **kw):
    import jax.numpy as jnp

    params, head, _, _, _, scales = jax_weights
    eng = JaxPagedEngine(jax_args(kv_dtype=kv),
                         tokenizer=JaxTokenizer(tok.vocab_list), mesh=None,
                         buckets=BUCKETS, **kw)
    eng.params = jax.device_put(params)
    eng.head = jax.device_put(head)
    if kv == "int8":
        eng._kv_scales = (jnp.asarray(scales[0]), jnp.asarray(scales[1]))
    return eng


@pytest.mark.parametrize("kv", ["auto", "int8"], ids=["fp32", "int8"])
def test_verify_ids_logits_match_jax(tok, jax_weights, kv):
    """The same streams seated in the port's engine and JAX's (the same
    page tables), then one ``[slots, k+1]`` verify window with a dead row:
    the live rows' logits at every window offset agree."""
    ps = prompts(tok, n=3, seed=5)
    got = {}
    for name, eng, stream_cls in (
            ("port", port_engine(tok, jax_weights, kv), DecodeStream),
            ("jax", jax_engine(tok, jax_weights, kv), JaxStream)):
        for i, p in enumerate(ps):
            eng.attach_stream(i, stream_cls(p, 8))
        first = np.asarray(eng.prefill_ids(ps, [0, 1, 2]))
        rng = np.random.default_rng(9)
        window = rng.integers(5, tok.vocab_size,
                              (eng.slots, DRAFT_K + 1)).astype(np.int32)
        window[:3, 0] = first.argmax(-1)
        pos = np.asarray([len(p) for p in ps] + [0], np.int32)
        nreal = np.asarray([DRAFT_K + 1] * 3 + [0], np.int32)
        got[name] = (np.asarray(eng._table).copy(),
                     np.asarray(eng.verify_ids(window, pos, nreal, live=3)))
    np.testing.assert_array_equal(got["port"][0], got["jax"][0])
    assert got["port"][1].shape == (4, DRAFT_K + 1, tok.vocab_size)
    np.testing.assert_allclose(got["port"][1][:3], got["jax"][1][:3],
                               atol=ATOL)


def test_speculative_tokens_match_jax(tok, jax_weights):
    """The port's speculating batcher and JAX's, each an identical pair on
    the same weights, emit the same tokens, which are plain greedy's."""
    ps = prompts(tok, n=6, seed=13)
    outs = {}
    for name, mk, batcher_cls in (("port", port_engine, DecodeBatcher),
                                  ("jax", jax_engine, JaxBatcher)):
        eng = mk(tok, jax_weights)
        dr = mk(tok, jax_weights, prefix_share=False)
        plain = batcher_cls(eng).start()
        _, ref = run_streams(plain, ps)
        plain.stop()
        b = batcher_cls(eng, drafter=dr, draft_k=DRAFT_K)
        b.warmup()
        b.start()
        _, outs[name] = run_streams(b, ps)
        assert b.spec_snapshot()["rounds"] > 0
        b.stop()
        assert outs[name] == ref
    assert outs["port"] == outs["jax"]


def test_rejected_round_then_accepted_round_keep_greedy_tokens(tok, spair):
    """The drafter's first k drafts are all wrong (a = 0: the round writes
    k + 1 positions and commits one), then it drafts right (a = k): the
    rejected K/V stays behind the position mask and is overwritten, so the
    stream is plain greedy's."""
    eng, dr = spair
    p = prompts(tok, n=1, seed=21)[0]
    plain = DecodeBatcher(eng).start()
    _, ref = run_streams(plain, [p], max_new=12)
    plain.stop()
    calls = {"n": 0}
    orig = dr.decode_batch

    def wrong_first_round(tokens, pos, live, request_ids=None):
        logits = orig(tokens, pos, live, request_ids=request_ids)
        calls["n"] += 1
        if calls["n"] <= DRAFT_K:   # round 1: shift every argmax by one
            logits = np.roll(logits, 1, axis=-1)
        return logits

    dr.decode_batch = wrong_first_round
    try:
        b = spec_batcher(spair)
        streams, outs = run_streams(b, [p], max_new=12)
        b.stop()
    finally:
        del dr.decode_batch
    assert outs == ref
    matched = [r["attrs"]["matched"] for r in eng.tracer.records()
               if (r.get("attrs") or {}).get("request_id") == streams[0].rid
               and r["attrs"].get("hop") == "verify"]
    assert matched[0] == 0 and matched[1] == DRAFT_K, matched
    for e in (eng, dr):
        assert e.leak_check()["ok"]


def test_cli_speculate_gives_plain_decode_tokens(vocab, tmp_path):
    """``serve.cli --decode --speculate bert-tiny=`` (a seeded drafter of
    the primary's architecture: identical weights) streams the tokens the
    plain ``--decode`` run streams, and reports its speculation block."""
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
            return r.stdout, json.load(f)["replicas"]["0"]

    plain, _ = run()
    spec, snap = run("--speculate", "bert-tiny=", "--draft_k", "3")
    assert spec == plain
    assert snap["speculation"]["draft_k"] == 3
    assert snap["speculation"]["rounds"] > 0
    assert snap["drafter"]["kv"]["layout"] == "paged"


# ------------------------------------------------- the speculation law

class FakeSpecRouter:
    """Router-shaped double exposing exactly what the speculation law
    consumes: a ``draft_k`` knob and cumulative draft/accept counters the
    test scripts per tick (``tests/test_speculate.py:FakeSpecRouter``,
    with the tracer of package ``P``)."""

    def __init__(self, P, k=6):
        self.knobs = {"draft_k": k}
        self.drafted = 0
        self.accepted = 0
        self.applied = []
        self.tracer = P.Tracer(enabled=True)

    def feed(self, rate, n=1000):
        self.drafted += n
        self.accepted += int(n * rate)

    def knob_values(self):
        return dict(self.knobs)

    def apply_knob(self, name, value):
        if name != "draft_k":
            raise KeyError(name)
        self.knobs[name] = value
        self.applied.append((name, value))

    def control_snapshot(self):
        return {
            "router": {"requests_total": 0, "deadline_expired_total": 0,
                       "queue_depth": 0.0, "admission": {}},
            "active": 1, "standby": 0,
            "knobs": dict(self.knobs),
            "speculation": {"draft_tokens": self.drafted,
                            "accepted_tokens": self.accepted},
        }


def _spec_controller(P, k=6, **kw):
    from tests.test_elastic import FakeClock

    r = FakeSpecRouter(P, k=k)
    clk = FakeClock()
    kw.setdefault("eval_window_s", 5.0)
    c = P.ServeController(r, clock=clk, tracer=r.tracer, **kw)
    assert c.step() is None  # first tick only primes the counter deltas
    clk.advance(1.0)
    return c, r, clk


def _spec_tick(c, r, clk, rate=None, dt=1.0):
    if rate is not None:
        r.feed(rate)
    s = c.step()
    clk.advance(dt)
    return s


def _law_halves(P):
    c, r, clk = _spec_controller(P, k=6)
    _spec_tick(c, r, clk, rate=0.20)
    assert r.knobs["draft_k"] == 6  # one low tick is not a verdict
    _spec_tick(c, r, clk, rate=0.20)
    assert r.knobs["draft_k"] == 3
    clk.advance(6.0)  # clear the knob cooldown
    _spec_tick(c, r, clk, rate=0.20)
    _spec_tick(c, r, clk, rate=0.20)
    assert r.knobs["draft_k"] == 1
    clk.advance(6.0)
    _spec_tick(c, r, clk, rate=0.10)  # < floor/2: catastrophic
    _spec_tick(c, r, clk, rate=0.10)
    assert r.knobs["draft_k"] == 0
    c.stop()
    rep = P.decision.validate_decisions(r.tracer.records())
    assert rep["incomplete"] == {}
    assert rep["by_knob"].get("draft_k", 0) >= 3
    return [(c, r)]


def test_law_halves_then_disables_on_low_acceptance():
    from tests.test_torch_controller import twin

    log = twin(_law_halves)
    assert [(a["old"], a["new"]) for a in log[0][0]
            if a["phase"] == "action"] == [(6, 3), (3, 1), (1, 0)]


def _law_deepens(P):
    c, r, clk = _spec_controller(P, k=6)
    _spec_tick(c, r, clk, rate=0.95)
    assert r.knobs["draft_k"] == 7
    _spec_tick(c, r, clk, rate=0.95)  # cooldown holds: no double-step
    assert r.knobs["draft_k"] == 7
    clk.advance(6.0)
    _spec_tick(c, r, clk, rate=0.95)
    assert r.knobs["draft_k"] == 8
    clk.advance(6.0)
    _spec_tick(c, r, clk, rate=0.95)  # at the ceiling: the law stands still
    assert r.knobs["draft_k"] == 8
    c.stop()
    assert P.decision.validate_decisions(r.tracer.records())[
        "incomplete"] == {}
    return [(c, r)]


def test_law_deepens_on_high_acceptance_capped():
    from tests.test_torch_controller import twin

    twin(_law_deepens)


def _law_dormant(P):
    c, r, clk = _spec_controller(P, k=6)
    for _ in range(4):
        _spec_tick(c, r, clk)  # no feed: accept_rate is None
    assert r.applied == []
    c2, r2, clk2 = _spec_controller(P, k=0)
    for _ in range(4):
        _spec_tick(c2, r2, clk2, rate=0.10)  # counters move, but k=0
    assert r2.applied == []
    return [(c, r), (c2, r2)]


def test_law_dormant_without_drafting():
    from tests.test_torch_controller import twin

    twin(_law_dormant)


def _law_reverts(P):
    c, r, clk = _spec_controller(P, k=0)
    _spec_tick(c, r, clk, rate=0.90)  # baseline sense: spec_waste 0.1
    assert c.inject("draft_k", 6, "test revert probe")
    assert r.knobs["draft_k"] == 6
    for _ in range(8):  # mid-band rate: law silent, waste regresses
        _spec_tick(c, r, clk, rate=0.50)
    assert r.knobs["draft_k"] == 0
    assert c.reverts_total >= 1
    c.stop()
    rep = P.decision.validate_decisions(r.tracer.records())
    assert rep["incomplete"] == {}
    assert rep["reverted"] >= 1
    return [(c, r)]


def test_law_auto_reverts_regressing_reenable():
    from tests.test_torch_controller import twin

    twin(_law_reverts)


def test_decode_router_control_snapshot_keys_match_jax(spair, tok,
                                                       jax_weights):
    """``DecodeRouter.control_snapshot()`` of a speculating pair has JAX's
    key tree — the speculation law reads ``speculation.draft_tokens`` /
    ``accepted_tokens`` and the knobs there — and a plain router's knobs
    are JAX's (none)."""
    from pdnlp_tpu.serve import DecodeRouter as JaxRouter
    from tests.test_torch_controller import key_tree

    eng, dr = spair
    ours = DecodeRouter([eng], drafters=[dr], draft_k=DRAFT_K)
    jeng = jax_engine(tok, jax_weights)
    jdr = jax_engine(tok, jax_weights, prefix_share=False)
    ref = JaxRouter([jeng], drafters=[jdr], draft_k=DRAFT_K)
    got, want = ours.control_snapshot(), ref.control_snapshot()
    assert key_tree(got) == key_tree(want)
    assert {"draft_tokens", "accepted_tokens"} <= set(got["speculation"])
    assert ours.knob_values() == ref.knob_values() == {"draft_k": DRAFT_K}
    assert DecodeRouter([eng]).knob_values() == \
        JaxRouter([jeng]).knob_values() == {}
