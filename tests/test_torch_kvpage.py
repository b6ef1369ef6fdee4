"""The port's paged KV cache: the allocator and prefix index
(``serve/kvpage.py``, a copy of the JAX module, held to JAX's unit tests
and to JAX's own objects on the same calls), paged-vs-slot token parity
(cold, full-hit, partial-hit and copy-on-write streams all continue as the
slot cache does), page-unit capacity under ``--kv_hbm_mb``, zero new
programs after warmup, pool exhaustion without deadlock, prefix-hit hops,
kill recovery re-attaching shared pages, the telemetry blocks, and the
guard page that takes every sentinel write — twins of
``tests/test_kvpage.py`` on the port's engines, on the CPU.
"""
import time

import numpy as np
import pytest
import torch

from pdnlp_tpu.serve import kvpage as jkvpage
from pdnlp_tpu_torch.models import decoder
from pdnlp_tpu_torch.serve import kvpage as tkvpage
from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab
from pdnlp_tpu_torch.obs.exporter import prometheus_lines
from pdnlp_tpu_torch.obs.memory import KVBudgetExceeded
from pdnlp_tpu_torch.obs.request import validate_chains
from pdnlp_tpu_torch.serve import (
    DecodeBatcher, DecodeEngine, DecodeRouter, KVPagesExhausted,
    PagedDecodeEngine,
)
from pdnlp_tpu_torch.serve.kvpage import (
    INDEX_OWNER, PageAllocator, PrefixIndex, pages_needed,
)
from pdnlp_tpu_torch.utils.config import Args

TEXTS = ["天地人你我", "好坏大小上下来去" * 5, "爱恨喜怒哀乐" * 15]
BUCKETS = (16, 32)


@pytest.fixture(scope="module")
def tok():
    return WordPieceTokenizer(build_vocab(TEXTS, size=128))


def make_args(**kw):
    base = dict(model="bert-tiny", decode_slots=4, decode_max_len=48,
                max_new_tokens=8, device="cpu")
    base.update(kw)
    return Args(**base)


def prompts(n=6, seed=3, lo=4, hi=14, vocab=120):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi, n)
    return [rng.integers(5, vocab, int(k)).tolist() for k in lens]


def paged_engine(tok, page_sz=16, **kw):
    return PagedDecodeEngine(make_args(**kw), tokenizer=tok, buckets=BUCKETS,
                             page_sz=page_sz)


@pytest.fixture(scope="module")
def pag(tok):
    """ONE warmed paged engine shared by the engine-level tests; each test
    drains its streams, and the prompt seeds are disjoint."""
    eng = paged_engine(tok, trace=True)
    eng.warmup_decode()
    return eng


@pytest.fixture(scope="module")
def slot_eng(tok):
    eng = DecodeEngine(make_args(), tokenizer=tok, buckets=BUCKETS)
    eng.warmup_decode()
    return eng


def drive_serial(eng, plist, max_new=6):
    """One stream at a time through a fresh batcher each — the
    order-independent reference drive."""
    outs = []
    for p in plist:
        b = DecodeBatcher(eng, replica=0)
        b.eos_id = -1
        b.start()
        outs.append(b.submit_ids(p, max_new_tokens=max_new)
                    .result(timeout=120))
        b.stop()
    return outs


# ------------------------------------------------------------- allocator

def test_pages_needed():
    assert [pages_needed(n, 16) for n in (0, 1, 16, 17)] == [0, 1, 1, 2]


def test_allocator_and_index_match_jax_module():
    """The copied module behaves as JAX's on the same call sequence:
    page ids, refcounts, hits, evictions and snapshots."""
    snaps = []
    for mod in (jkvpage, tkvpage):
        a = mod.PageAllocator(10, 4, page_bytes=64)
        idx = mod.PrefixIndex(a, 4)
        a.reclaimer = idx.evict
        p1 = a.alloc(3, "r1")
        idx.register(list(range(10)), p1, first_token=7)
        a.share(p1[:2], "r2")
        hits = [idx.lookup(list(range(10))).kind,
                idx.lookup(list(range(8)) + [99]).kind,
                idx.lookup([1, 1, 1, 1]).kind]
        a.release_owner("r1")
        p3 = a.alloc(7, "r3")
        a.count_cow()
        snaps.append((p1, p3, hits, a.snapshot(), idx.snapshot(),
                      a.leak_check()))
    assert snaps[0] == snaps[1]


def test_allocator_alloc_share_release_roundtrip():
    a = PageAllocator(8, 16, page_bytes=1024)
    p1 = a.alloc(3, "r1")
    assert len(p1) == 3 and a.free_pages == 5
    a.share(p1[:2], "r2")
    assert a.used_pages == 3
    assert a.release_owner("r1") == 1
    assert a.free_pages == 6
    assert a.release_owner("r2") == 2
    assert a.free_pages == 8
    lk = a.leak_check()
    assert lk["ok"] and lk["leaked_pages"] == 0


def test_allocator_exhaustion_is_loud_and_counted():
    a = PageAllocator(4, 16, page_bytes=1024)
    a.alloc(3, "r1")
    with pytest.raises(KVPagesExhausted) as e:
        a.alloc(2, "r2")
    assert "page" in str(e.value)
    assert isinstance(e.value, KVBudgetExceeded)
    assert a.alloc_failures == 1
    assert a.used_pages == 3 and "r2" not in a.owners()


def test_allocator_leak_check_flags_mismatch():
    a = PageAllocator(4, 16)
    a.alloc(2, "r1")
    lk = a.leak_check()
    assert lk["ok"] and lk["owners"] == 1
    a._owned["ghost"] = {0: 1}
    assert not a.leak_check()["ok"]
    assert a.leak_check()["refcount_mismatches"] == 1


def test_allocator_reclaimer_is_called_on_shortfall():
    calls = []

    def reclaim(short):
        calls.append(short)
        return 0

    a = PageAllocator(2, 16)
    a.reclaimer = reclaim
    a.alloc(2, "r1")
    with pytest.raises(KVPagesExhausted):
        a.alloc(1, "r2")
    assert calls == [1]


def test_prefix_index_full_and_partial_hits():
    a = PageAllocator(16, 4)
    idx = PrefixIndex(a, 4)
    toks = list(range(10))
    pages = a.alloc(3, "r1")
    idx.register(toks, pages, first_token=77)
    full = idx.lookup(toks)
    assert full.kind == "full" and full.first_token == 77
    assert list(full.pages) == pages
    part = idx.lookup(toks[:8] + [99, 98])
    assert part.kind == "partial" and list(part.pages) == pages[:2]
    assert idx.lookup([5, 5, 5, 5]).kind == "miss"
    a.release_owner("r1")
    assert a.used_pages == 3 and a.owners() == [INDEX_OWNER]
    assert idx.evict(need_pages=16) == 3
    assert a.free_pages == 16


def test_prefix_index_peek_has_no_side_effects():
    a = PageAllocator(8, 4)
    idx = PrefixIndex(a, 4)
    idx.register(list(range(8)), a.alloc(2, "r"), first_token=1)
    before = idx.snapshot()
    assert idx.lookup(list(range(8)), count=False).kind == "full"
    assert idx.snapshot() == before


def test_prefix_index_eviction_is_lru():
    a = PageAllocator(8, 4)
    idx = PrefixIndex(a, 4)
    idx.register([1] * 4, a.alloc(1, "x"), first_token=1)
    idx.register([2] * 4, a.alloc(1, "y"), first_token=2)
    a.release_owner("x")
    a.release_owner("y")
    idx.lookup([1] * 4)
    idx.evict(need_pages=1)
    assert idx.lookup([1] * 4).kind == "full"
    assert idx.lookup([2] * 4).kind == "miss"
    assert a.evictions >= 1


# ------------------------------------------------- engine: parity + hits

def test_paged_cold_streams_match_slot_engine(tok, pag, slot_eng):
    ps = prompts(6, seed=3, vocab=tok.vocab_size)
    assert drive_serial(pag, ps) == drive_serial(slot_eng, ps)
    assert pag.leak_check()["ok"]
    pag.prefix.clear()
    assert pag.allocator.free_pages == pag.n_pages


def test_full_prefix_hit_skips_prefill_and_matches(tok, pag):
    p = prompts(1, seed=11, lo=18, hi=20, vocab=tok.vocab_size)[0]
    b = DecodeBatcher(pag, replica=0)
    b.eos_id = -1
    b.start()
    cold = b.submit_ids(p, max_new_tokens=6).result(timeout=120)
    before = b.metrics.prefills_total.value
    hit = b.submit_ids(p, max_new_tokens=6).result(timeout=120)
    assert b.metrics.prefills_total.value == before, \
        "full hit must not run a prefill forward"
    assert hit == cold
    assert pag.prefix.snapshot()["hits_full"] >= 1
    assert pag.allocator.cow_copies >= 1   # p % page_sz != 0 -> COW
    b.stop()
    assert pag.leak_check()["ok"]


def test_partial_prefix_hit_matches_cold_reference(tok, pag, slot_eng):
    base = prompts(1, seed=5, lo=20, hi=22, vocab=tok.vocab_size)[0]
    va, vb = base + [7, 8, 9], base + [3, 4, 5]
    ref = drive_serial(slot_eng, [vb])[0]
    b = DecodeBatcher(pag, replica=0)
    b.eos_id = -1
    b.start()
    b.submit_ids(va, max_new_tokens=6).result(timeout=120)
    got = b.submit_ids(vb, max_new_tokens=6).result(timeout=120)
    b.stop()
    assert got == ref
    assert pag.prefix.snapshot()["hits_partial"] >= 1
    assert pag.leak_check()["ok"]


def test_admit_and_prefill_hops_carry_prefix_hit(pag):
    b = DecodeBatcher(pag, replica=0)
    b.eos_id = -1
    b.start()
    p = [5, 6, 7, 8, 9]
    b.submit_ids(p, max_new_tokens=3).result(timeout=120)
    s = b.submit_ids(p, max_new_tokens=3)
    s.result(timeout=120)
    b.stop()
    hops = [r["attrs"] for r in pag.tracer.records()
            if r.get("name") == "hop"
            and (r.get("attrs") or {}).get("request_id") == s.rid]
    admit = next(h for h in hops if h["hop"] == "admit")
    pre = next(h for h in hops if h["hop"] == "prefill")
    assert admit["prefix_hit"] == "full" and pre["prefix_hit"] == "full"
    assert pre["cached_tokens"] == len(p)
    assert validate_chains(pag.tracer.records(), [s.rid])["complete"] == 1


def test_guard_pages_take_sentinel_reads_and_writes(tok, pag):
    """Filler rows, padding and dead decode rows write into the sink (JAX
    drops those writes) and read the zero page (JAX's fill reads 0.0):
    live pages never move and the zero page stays zero."""
    b = DecodeBatcher(pag, replica=0)
    b.eos_id = -1
    b.start()
    b.submit_ids(prompts(1, seed=31, vocab=tok.vocab_size)[0],
                 max_new_tokens=4).result(timeout=60)
    b.stop()
    assert pag.allocator.used_pages >= 1      # the index holds its pages
    before = (pag._cache_k[:, :pag.n_pages].clone(),
              pag._cache_v[:, :pag.n_pages].clone())
    pag.warmup_decode()                # sentinel tables everywhere
    assert torch.equal(pag._cache_k[:, :pag.n_pages], before[0])
    assert torch.equal(pag._cache_v[:, :pag.n_pages], before[1])
    zero, sink = pag.n_pages, pag.n_pages + 1
    assert pag._cache_k.shape[1] == pag.n_pages + 2
    assert not pag._cache_k[:, zero].any() and not pag._cache_v[:, zero].any()
    assert pag._cache_k[:, sink].any()                 # it took the writes
    pag.prefix.clear()


# ------------------------------------------------------ capacity / budget

def test_paged_layout_admits_more_streams_at_equal_hbm(tok, pag):
    slot_mb = (pag.token_bytes * pag.max_len) / 2**20
    budget = 2.2 * slot_mb
    capped_slot = DecodeEngine(make_args(kv_hbm_mb=budget), tokenizer=tok,
                               buckets=BUCKETS)
    assert capped_slot.slots == 1          # the guard slot paid first
    capped_pag = paged_engine(tok, kv_hbm_mb=budget, decode_slots=8)
    assert capped_pag.slots == 8
    per_stream = pages_needed(8, capped_pag.page_sz)
    assert capped_pag.n_pages // per_stream > capped_slot.slots


def test_pool_exhaustion_queues_without_deadlock(tok):
    probe = paged_engine(tok)
    # the floor: one maximum-length stream's pages and the guard pages
    floor_mb = (probe.page_bytes * (probe.pages_per_stream
                                    + decoder.GUARD_PAGES)) / 2**20
    tight = paged_engine(tok, kv_hbm_mb=1.05 * floor_mb)
    assert tight.n_pages == tight.pages_per_stream
    b = DecodeBatcher(tight, replica=0)
    b.eos_id = -1
    b.start()
    ps = prompts(6, seed=9, lo=18, hi=22, vocab=tok.vocab_size)
    outs = [s.result(timeout=180)
            for s in [b.submit_ids(p, max_new_tokens=8) for p in ps]]
    b.stop()
    assert all(len(o) == 8 for o in outs)
    assert tight.leak_check()["ok"]
    tight.prefix.clear()
    assert tight.allocator.free_pages == tight.n_pages


def test_oversized_stream_refused_in_page_units(tok):
    eng = paged_engine(tok, kv_hbm_mb=64)
    with pytest.raises(KVBudgetExceeded) as e:
        eng.check_stream_admissible(40, 40)
    assert "pages" in str(e.value)


# ------------------------------------------------------------ zero retrace

def test_paged_decode_path_creates_no_program_after_warmup(tok, pag):
    baseline = pag.metrics.cache_misses.value
    retr = pag.metrics.retraces.value
    b = DecodeBatcher(pag, replica=0)
    b.eos_id = -1
    b.start()
    ps = prompts(8, seed=21, vocab=tok.vocab_size)
    streams = [b.submit_ids(p, max_new_tokens=6) for p in ps]
    # re-submit the first two: full hits and COW flushes run no new shape
    streams += [b.submit_ids(p, max_new_tokens=6) for p in ps[:2]]
    for s in streams:
        s.result(timeout=180)
    b.stop()
    assert pag.metrics.cache_misses.value == baseline
    assert pag.metrics.retraces.value == retr


# --------------------------------------------------------- kill recovery

def test_paged_router_kill_reattaches_shared_pages(tok, pag):
    args = make_args(trace=True)
    shared = prompts(1, seed=2, lo=18, hi=20, vocab=tok.vocab_size)[0]
    tails = prompts(12, seed=4, lo=2, hi=6, vocab=tok.vocab_size)
    ps = [shared + t for t in tails] + prompts(6, seed=8,
                                               vocab=tok.vocab_size)
    refs = drive_serial(pag, ps, max_new=16)
    engines = [pag, PagedDecodeEngine(args, tokenizer=tok, buckets=BUCKETS,
                                      page_sz=16)]
    tracer = engines[0].tracer
    engines[1].tracer = tracer
    router = DecodeRouter(engines).start()
    for b in router.batchers:
        b.eos_id = -1
    router.warmup()
    streams = [router.submit_ids(p, max_new_tokens=16) for p in ps]
    deadline = time.monotonic() + 60
    while (router.batchers[0].metrics.tokens_out_total.value < 40
           and time.monotonic() < deadline):
        time.sleep(0.002)
    router.kill(0)
    outs = [s.result(timeout=300) for s in streams]
    router.stop()
    assert router.batchers[0].dead and not router.batchers[1].dead
    assert outs == refs, "paged kill recovery duplicated or lost tokens"
    report = validate_chains(tracer.records(), [s.rid for s in streams])
    assert report["incomplete"] == {}
    assert report["complete"] == len(streams)
    assert report["requeued"] >= 1
    survivor = router.batchers[1].engine
    lk = survivor.leak_check()
    assert lk["ok"] and lk["stream_owners"] == []
    hits = survivor.prefix.snapshot()
    assert hits["hits_full"] + hits["hits_partial"] >= 1
    survivor.prefix.clear()
    assert survivor.allocator.free_pages == survivor.n_pages


def test_retire_hands_back_live_and_waiting_streams(tok):
    """``retire`` stops the worker without failing its streams: live and
    waiting streams come back unfinished, their pages released."""
    eng = paged_engine(tok, decode_slots=2)
    b = DecodeBatcher(eng, replica=0)
    b.eos_id = -1
    b.start()
    streams = [b.submit_ids(p, max_new_tokens=30)
               for p in prompts(5, seed=41, vocab=tok.vocab_size)]
    deadline = time.monotonic() + 30
    while b.metrics.tokens_out_total.value < 2 and \
            time.monotonic() < deadline:
        time.sleep(0.001)
    back = b.retire()
    assert {s.rid for s in back} == {s.rid for s in streams if not s.done()}
    assert back and not any(s.done() for s in back)
    assert eng.leak_check()["ok"]
    assert b.load == 0


# ------------------------------------------------------------- telemetry

def test_control_snapshot_aggregates_and_exports(pag):
    router = DecodeRouter([pag]).start()
    router.batchers[0].eos_id = -1
    p = [5, 6, 7, 8, 9, 10]
    router.submit_ids(p, max_new_tokens=4).result(timeout=120)
    router.submit_ids(p, max_new_tokens=4).result(timeout=120)
    snap = router.control_snapshot()
    router.stop()
    agg = snap["pages"]
    assert agg["pages_total"] == pag.n_pages
    assert agg["hits_full"] >= 1
    assert 0.0 < agg["prefix_hit_rate"] <= 1.0
    rep = snap["replicas"]["0"]
    assert rep["layout"] == "paged"
    assert rep["prefix"]["entries"] >= 1
    assert rep["peak_live_streams"] >= 1
    lines = prometheus_lines("decode_control", snap)
    for leaf in ("prefix_hit_rate", "pages_live", "cow_copies"):
        assert any(leaf in ln for ln in lines)


def test_decode_metrics_page_gauges(pag):
    b = DecodeBatcher(pag, replica=0)
    b.eos_id = -1
    b.start()
    b.submit_ids([5, 6, 7, 8], max_new_tokens=4).result(timeout=120)
    b.stop()
    snap = b.metrics.snapshot()
    assert snap["peak_live_streams"] >= 1
    assert snap["kv_pages_free"] + snap["kv_pages_live"] == pag.n_pages
