"""The PyTorch port's serving path: engine logits against the JAX
``InferenceEngine`` on the same (bridged) weights, the batcher's flush,
backpressure and deadline behaviour, packed-vs-padded parity, and the CLI.

Tolerance: fp32 logits atol 2e-4 (``tests/test_flash.py``'s end-to-end
bound).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from pdnlp_tpu.data.packing import pack_id_lists as jax_pack_id_lists
from pdnlp_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from pdnlp_tpu.serve import InferenceEngine as JaxEngine
from pdnlp_tpu.serve import score_texts as jax_score_texts
from pdnlp_tpu.utils.config import Args as JaxArgs
from pdnlp_tpu_torch.data.tokenizer import (
    WordPieceTokenizer, build_vocab, save_vocab,
)
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.serve import (
    DeadlineExceeded, DynamicBatcher, InferenceEngine, QueueFullError,
    resolve_serve_pack, score_texts,
)
from pdnlp_tpu_torch.utils.config import Args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = (32, 64, 128)
TEXTS = ["天地人你我", "好坏大小上下来去" * 5, "爱恨喜怒哀乐" * 15,
         "高兴悲伤", "讨厌愤怒来去" * 8]
ATOL = 2e-4


@pytest.fixture(scope="module")
def vocab():
    return build_vocab(TEXTS, size=128)


@pytest.fixture(scope="module")
def engines(vocab):
    """(JAX engine, port engine on the CPU with the JAX engine's weights)."""
    jeng = JaxEngine(JaxArgs(model="bert-tiny"),
                     tokenizer=JaxTokenizer(vocab), mesh=None)
    eng = InferenceEngine(Args(model="bert-tiny", device="cpu"),
                          tokenizer=WordPieceTokenizer(vocab))
    eng.load_state(convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jeng.params)))
    return jeng, eng


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


@pytest.mark.parametrize("seq", BUCKETS)
def test_engine_infer_matches_jax(engines, seq):
    jeng, eng = engines
    ids = eng.tokenizer.encode_ragged(TEXTS, seq)
    want = jeng.infer_ids(ids, seq, rows=8)
    got = eng.infer_ids(ids, seq, rows=8)
    assert got.shape == (len(TEXTS), eng.cfg.num_labels)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_engine_infer_packed_matches_jax(engines):
    jeng, eng = engines
    ids = eng.tokenizer.encode_ragged(TEXTS * 3, 128)
    batch, placements = jax_pack_id_lists(ids, 128, 4, 16)
    want = jeng.infer_packed(batch)
    got = eng.infer_packed(batch)
    assert got.shape == (4, 16, eng.cfg.num_labels)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_offline_scoring_matches_jax(engines):
    jeng, eng = engines
    jp, jl = jax_score_texts(jeng, TEXTS, buckets=BUCKETS, batch_size=2)
    p, l = score_texts(eng, TEXTS, buckets=BUCKETS, batch_size=2)
    np.testing.assert_allclose(l, jl, atol=ATOL)
    np.testing.assert_array_equal(p, jp)
    preds, logits = eng.classify_texts(TEXTS)
    np.testing.assert_allclose(logits, l, atol=ATOL)


def test_shape_cache_counts(vocab):
    eng = InferenceEngine(Args(model="bert-tiny", device="cpu"),
                          tokenizer=WordPieceTokenizer(vocab))
    eng.warmup(BUCKETS, rows=4)
    assert eng.metrics.cache_misses.value == len(BUCKETS)
    ids = eng.tokenizer.encode_ragged(TEXTS, 32)
    for _ in range(3):
        eng.infer_ids([ids[0]], 32, rows=4)
    assert eng.metrics.cache_hits.value == 3
    snap = eng.metrics.snapshot()
    # JAX's snapshot keys; on the CPU a first-seen shape is a retrace
    assert snap["compile_cache"] == {"hits": 3, "misses": 3, "retraces": 3}


def test_engine_refusals(vocab, tmp_path):
    tok = WordPieceTokenizer(vocab)
    with pytest.raises(ValueError, match="serve_dtype"):
        InferenceEngine(Args(model="bert-tiny", device="cpu",
                             serve_dtype="int4"), tokenizer=tok)
    with pytest.raises(ValueError, match="device"):
        InferenceEngine(Args(model="bert-tiny", device="meta"), tokenizer=tok)
    eng = InferenceEngine(Args(model="bert-tiny", device="cpu"), tokenizer=tok)
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    path = str(tmp_path / "base.pt")
    small = {k: v[:1] for k, v in eng.state_dict().items()}
    ckpt.save_params(path, small, model_name="bert-tiny", vocab_size=1)
    with pytest.raises(ValueError, match="does not match"):
        eng.load_checkpoint(path)


# ------------------------------------------------------------------- batcher
def test_batcher_flushes_on_size(engine):
    with DynamicBatcher(engine, buckets=BUCKETS, max_batch_size=2,
                        max_wait_ms=60_000, serve_pack="off") as b:
        futs = [b.submit(TEXTS[0]), b.submit(TEXTS[3])]
        outs = [f.result(timeout=30) for f in futs]
    assert all(o.shape == (engine.cfg.num_labels,) for o in outs)


@pytest.mark.parametrize("serve_pack", ["off", "on"])
def test_batcher_flushes_on_timeout(engine, serve_pack):
    with DynamicBatcher(engine, buckets=BUCKETS, max_batch_size=64,
                        max_wait_ms=30, serve_pack=serve_pack) as b:
        out = b.submit(TEXTS[0]).result(timeout=30)
    assert out.shape == (engine.cfg.num_labels,)


@pytest.mark.parametrize("serve_pack", ["off", "on"])
def test_batcher_full_queue_rejects_not_blocks(engine, serve_pack):
    b = DynamicBatcher(engine, buckets=BUCKETS, max_batch_size=64,
                       max_wait_ms=60_000, max_queue=1 if serve_pack == "on"
                       else 3, serve_pack=serve_pack).start()
    rejected = b.metrics.rejected_total.value   # the engine's, shared
    try:
        n = 0
        with pytest.raises(QueueFullError):
            for n in range(1, 200):
                b.submit(TEXTS[1])
        assert b.metrics.rejected_total.value == rejected + 1
        # padded: 3 requests; packed: one 128-token row's worth of tokens
        assert n == (4 if serve_pack == "off" else
                     1 + 128 // len(engine.tokenizer.encode_ids(TEXTS[1])))
    finally:
        b.stop(drain=False)


@pytest.mark.parametrize("serve_pack", ["off", "on"])
def test_batcher_deadline_expires_instead_of_stalling(engine, serve_pack):
    with DynamicBatcher(engine, buckets=BUCKETS, max_batch_size=64,
                        max_wait_ms=60_000, serve_pack=serve_pack) as b:
        fut = b.submit(TEXTS[0], deadline_ms=1.0)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        assert b.metrics.deadline_expired_total.value >= 1


def test_packed_and_padded_batchers_agree(engine):
    texts = TEXTS * 4
    outs = {}
    for mode in ("off", "on"):
        with DynamicBatcher(engine, buckets=BUCKETS, max_batch_size=4,
                            max_wait_ms=20, serve_pack=mode) as b:
            assert b.packed == (mode == "on")
            futs = [b.submit(t) for t in texts]
            outs[mode] = np.stack([f.result(timeout=60) for f in futs])
    np.testing.assert_allclose(outs["on"], outs["off"], atol=ATOL)
    assert engine.metrics.batches_total.value > 0


def test_resolve_serve_pack():
    assert resolve_serve_pack("auto", "cuda") is True
    assert resolve_serve_pack("auto", "cpu") is False
    assert resolve_serve_pack("on", "cpu") is True
    assert resolve_serve_pack("off", "cuda") is False
    with pytest.raises(ValueError):
        resolve_serve_pack("sometimes", "cpu")


def test_submit_before_start_and_empty_requests_raise(engine):
    b = DynamicBatcher(engine, buckets=BUCKETS)
    with pytest.raises(RuntimeError):
        b.submit(TEXTS[0])
    with b:
        with pytest.raises(ValueError, match="empty"):
            b.submit_ids([])


# ----------------------------------------------------------------------- CLI
def _cli(args, stdin, tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", *args],
        input=stdin, capture_output=True, text=True, timeout=240,
        cwd=str(tmp_path), env=env)


def test_cli_online_stdin_and_offline_file(vocab, tmp_path):
    vpath = str(tmp_path / "vocab.txt")
    save_vocab(vocab, vpath)
    common = ["--device", "cpu", "--model", "bert-tiny", "--vocab_path",
              vpath, "--max_wait_ms", "10"]
    r = _cli(common + ["--metrics_path", str(tmp_path / "m.json")],
             "\n".join(TEXTS) + "\n\n", tmp_path)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == len(TEXTS) and not any("ERROR" in x for x in lines)
    assert all(x.split("\t")[0].isdigit() for x in lines)
    assert os.path.exists(tmp_path / "m.json")
    inp = tmp_path / "in.txt"
    inp.write_text("\n".join(TEXTS), encoding="utf-8")
    r = _cli(common + ["--input", str(inp), "--output",
                       str(tmp_path / "out.txt")], "", tmp_path)
    assert r.returncode == 0, r.stderr
    out = (tmp_path / "out.txt").read_text(encoding="utf-8").splitlines()
    assert [x.split("\t")[2] for x in out] == TEXTS
    r = _cli(common + ["--controller", "on"], "", tmp_path)
    assert r.returncode != 0 and "ROADMAP A9b" in r.stderr
