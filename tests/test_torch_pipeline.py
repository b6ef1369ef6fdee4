"""The PyTorch port's input pipelines (``pdnlp_tpu_torch.data.pipeline``)
on the CPU, the twins of ``tests/test_pipeline.py``: resident batches are
the host loader's bytes in every length mode, with no in-loop upload;
sync, prefetch and resident feed bert-tiny the same per-step losses bit
for bit over two epochs; prefetch keeps at most one batch in flight,
passes exceptions on and stops its worker when left early;
``build_pipeline`` chooses and refuses as JAX's does; ``TransportStats``
counts what JAX's counts.  The pipelines run with ``device cpu`` here;
their side-stream upload is checked on the card
(``tests/test_torch_cuda.py``).
"""
import threading
import time

import numpy as np
import pytest
import torch

from pdnlp_tpu.data import collate as jcollate
from pdnlp_tpu.data import loader as jloader
from pdnlp_tpu.data import pipeline as jpipeline
from pdnlp_tpu.data import sampler as jsampler
from pdnlp_tpu.data import tokenizer as jtok
from pdnlp_tpu.utils import metrics as jmetrics
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.data import collate, loader, pipeline, sampler, tokenizer
from pdnlp_tpu_torch.train import setup, steps
from pdnlp_tpu_torch.train.trainer import Trainer
from pdnlp_tpu_torch.utils import metrics
from pdnlp_tpu_torch.utils.config import Args

SEQ = 32
BATCH = 8
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def corpus():
    """118 examples of 4-35 chars: the last 8-row batch of an epoch holds
    6 real rows and 2 filler rows, so the padding path is in every
    comparison."""
    rng = np.random.RandomState(7)
    chars = "天地人你我他好大小上下来去爱乐高兴悲伤"
    return [("".join(rng.choice(list(chars))
                     for _ in range(int(rng.randint(4, SEQ + 4)))),
             int(rng.randint(0, 6))) for _ in range(118)]


@pytest.fixture(scope="module")
def tok(corpus):
    return tokenizer.WordPieceTokenizer(
        tokenizer.build_vocab((t for t, _ in corpus), size=256))


def make_loader(corpus, tok, mode="full", encoded=True, prefetch=0):
    """A train loader of ``--length_mode mode`` (buckets 16 and 32)."""
    col = collate.Collator(tok, SEQ)
    if not encoded:
        return loader.DataLoader(
            corpus, col, BATCH,
            sampler=sampler.DistributedShardSampler(len(corpus), seed=5),
            prefetch=prefetch)
    args = Args(model="bert-tiny", max_seq_len=SEQ, length_mode=mode,
                length_buckets="16,32", pack_max_segments=4, seed=5,
                prefetch=prefetch)
    return setup.build_length_train_loader(
        args, corpus, col, collate.EncodedDataset(corpus, tok, SEQ),
        batch_size=BATCH)


# ------------------------------------------------------------ data parity


@pytest.mark.parametrize("mode", ["full", "bucket", "pack"])
def test_resident_batches_bitwise_equal_host_loader(corpus, tok, mode):
    """Resident batches are the host loader's batches key for key, bit for
    bit, for two epochs, with no upload inside the loop."""
    host_loader = make_loader(corpus, tok, mode)
    pipe = pipeline.DeviceResidentPipeline(make_loader(corpus, tok, mode),
                                           CPU)
    widths = set()
    for epoch in range(2):
        host_loader.set_epoch(epoch)
        pipe.set_epoch(epoch)
        host = list(host_loader)
        dev = list(pipe.macro_batches(1))
        assert len(dev) == len(host) == len(host_loader)
        for hb, (db, n, fused, ex) in zip(host, dev):
            assert (n, fused) == (1, False)
            assert ex == int(hb["example_weight"].sum())
            assert set(db) == set(hb)
            for k in hb:
                got = db[k].numpy()
                assert got.dtype == hb[k].dtype and \
                    np.array_equal(got, hb[k]), k
            widths.add(hb["input_ids"].shape[1])
        assert host[-1]["example_weight"].min() == 0.0   # filler rows
    assert widths == ({16, 32} if mode == "bucket" else {SEQ})
    snap = pipe.stats.snapshot()
    assert snap["puts_in_loop"] == 0
    assert snap["bytes_uploaded_in_loop"] == 0
    assert snap["bytes_per_step"] == 0.0
    assert snap["bytes_uploaded_total"] > 0       # residency, permutations
    assert snap["steps"] == 2 * len(host_loader)


def test_macro_batches_never_stack_mixed_widths(corpus, tok):
    """Fused groups never stack mixed widths: under bucket mode every
    pipeline's ``macro_batches(3)`` cuts the epoch as JAX's
    ``host_macro_batches`` does (a width change flushes a partial run as
    single steps), each fused group is the host loader's three batches
    stacked, bit for bit, and it lands in the stage's buffers."""
    host_loader = make_loader(corpus, tok, "bucket")
    host_loader.set_epoch(1)
    host = list(host_loader)
    want = [(n, fused, int(b["input_ids"].shape[-1])) for b, n, fused, _ in
            jpipeline.host_macro_batches(host, 3)]
    assert any(f for _, f, _ in want) and any(not f for _, f, _ in want)
    for cls in (pipeline.SyncPipeline, pipeline.DevicePrefetchPipeline,
                pipeline.DeviceResidentPipeline):
        pipe = cls(make_loader(corpus, tok, "bucket"), CPU)
        pipe.set_epoch(1)
        stage = pipeline.DeviceStage(CPU)
        got, i = [], 0
        for b, n, fused, ex in pipe.macro_batches(3, stage):
            got.append((n, fused, int(b["input_ids"].shape[-1])))
            part = host[i:i + n]
            i += n
            assert ex == sum(int(h["example_weight"].sum()) for h in part)
            if fused:
                assert b["input_ids"] is stage.like(b)["input_ids"]
                for k in part[0]:
                    assert np.array_equal(b[k].numpy(),
                                          np.stack([h[k] for h in part])), k
        assert got == want, cls.__name__


# --------------------------------------------------------- losses, stats


@pytest.fixture
def one_thread():
    """One intra-op thread while the losses are compared bit for bit: the
    CPU backward with several threads gives run-to-run differences in the
    last bit (two sync runs of the same batches differ by up to 2.4e-7)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _losses(pipe, args, vocab_size, epochs=2):
    _, state = setup.setup_model(args, vocab_size)
    step = steps.build_train_step(args, CPU)
    out = []
    for epoch in range(epochs):
        pipe.set_epoch(epoch)
        for batch, _n, _fused, _ex in pipe.macro_batches(1):
            out.append(step(state, batch)["loss"])
    return torch.stack(out)


@pytest.mark.parametrize("mode", ["full", "bucket", "pack"])
def test_pipelines_give_the_same_losses_bit_for_bit(corpus, tok, mode,
                                                   one_thread):
    """sync, prefetch and resident feed bert-tiny (dropout 0) the same
    per-step losses over two epochs, bit for bit."""
    args = Args(device="cpu", model="bert-tiny", max_seq_len=SEQ,
                dropout=0.0, attn_dropout=0.0, learning_rate=1e-3)
    losses = {}
    for cls in (pipeline.SyncPipeline, pipeline.DevicePrefetchPipeline,
                pipeline.DeviceResidentPipeline):
        pipe = cls(make_loader(corpus, tok, mode, prefetch=2), CPU)
        losses[cls.mode] = _losses(pipe, args, tok.vocab_size)
    assert torch.isfinite(losses["sync"]).all()
    assert torch.equal(losses["sync"], losses["prefetch"])
    assert torch.equal(losses["sync"], losses["resident"])


def test_trainer_runs_each_pipeline_to_the_same_lines(corpus, tok, tmp_path,
                                                      capsys, one_thread):
    """``Trainer(pipeline=)`` consumes the pipeline that wraps its train
    loader: the printed 【train】 lines are the same in every mode."""
    lines = {}
    for mode in ("sync", "prefetch", "resident"):
        args = Args(device="cpu", model="bert-tiny", max_seq_len=SEQ,
                    dropout=0.0, attn_dropout=0.0, learning_rate=1e-3,
                    epochs=2, output_dir=str(tmp_path / mode),
                    length_mode="pack", pipeline=mode)
        ld = make_loader(corpus, tok, "pack")
        pipe = pipeline.build_pipeline(args, ld)
        assert pipe.mode == mode
        cfg, state = setup.setup_model(args, tok.vocab_size)
        tr = Trainer(args, cfg, state, steps.build_train_step(args, CPU),
                     steps.build_eval_step(args), CPU, pipeline=pipe)
        tr.train(ld)
        out = capsys.readouterr().out.splitlines()
        lines[mode] = [ln for ln in out if ln.startswith("【train】")]
        assert len(lines[mode]) == 2 * len(ld)
        assert pipe.stats.steps == 2 * len(ld)
    assert lines["sync"] == lines["prefetch"] == lines["resident"]


def test_transport_stats_match_jax(corpus, tok):
    """The sync pipelines of both packages over the same bucket loader
    count the same steps, rows, tokens and per-bucket waste."""
    jt = jtok.WordPieceTokenizer(tok.vocab_list)
    ld = make_loader(corpus, tok, "bucket")
    jsmp = jsampler.LengthGroupedSampler(
        jcollate.EncodedDataset(corpus, jt, SEQ).lengths(), BATCH,
        buckets=jsampler.parse_buckets("16,32", SEQ), seed=5)
    jld = jloader.DataLoader(corpus, jcollate.Collator(jt, SEQ), BATCH,
                             sampler=jsmp, prefetch=0,
                             encoded=jcollate.EncodedDataset(corpus, jt, SEQ))
    port = pipeline.SyncPipeline(ld, CPU)
    ref = jpipeline.SyncPipeline(jld, put=lambda b: b)
    list(port.macro_batches(1))
    list(ref.macro_batches(1))
    a, b = port.stats.snapshot(), ref.stats.snapshot()
    for snap in (a, b):
        snap.pop("put_wait_sec")
    assert a == b
    assert set(a["by_bucket"]) == {"16", "32"}
    full = collate.EncodedDataset(corpus, tok, SEQ).arrays["attention_mask"]
    assert a["padding_waste_tokens"] < 1.0 - full.sum() / full.size


def test_transport_stats_counters_match_jax():
    calls = [("record_upload", (100, 0.5), {}),
             ("record_upload", (40, 0.25), {"in_loop": False}),
             ("record_batch", (1, 32, 30), {"seq_len": 64, "tokens": 2048,
                                            "tokens_real": 900}),
             ("record_batch", (1, 32, 32), {}),
             ("put_started", (), {}), ("put_started", (), {}),
             ("put_delivered", (), {})]
    a, b = metrics.TransportStats(), jmetrics.TransportStats()
    for s in (a, b):
        for name, args, kw in calls:
            getattr(s, name)(*args, **kw)
    assert a.snapshot() == b.snapshot()
    assert (a.bytes_per_step, a.padding_waste, a.padding_waste_tokens) == \
        (b.bytes_per_step, b.padding_waste, b.padding_waste_tokens)


# --------------------------------------------------------------- prefetch


def test_prefetch_at_most_one_batch_in_flight(corpus, tok):
    """The worker never runs more than one uploaded, undelivered batch
    ahead, and it does run ahead: the upload of k+1 lands while the
    consumer holds k."""
    puts = [0]
    lock = threading.Lock()

    def put(b):
        with lock:
            puts[0] += 1
        return pipeline.to_device(b, CPU)

    pipe = pipeline.DevicePrefetchPipeline(make_loader(corpus, tok), CPU,
                                           put=put)
    consumed = 0
    leads = []
    for _batch, _, _, _ in pipe.macro_batches(1):
        consumed += 1
        time.sleep(0.01)       # the worker uploads the next batch meanwhile
        with lock:
            leads.append(puts[0] - consumed)
    assert consumed == len(pipe.loader)
    assert pipe.stats.in_flight_max == 1
    assert max(leads) == 1


def test_prefetch_put_exception_propagates(corpus, tok):
    calls = {"n": 0}

    def bad_put(b):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("upload failed")
        return b

    pipe = pipeline.DevicePrefetchPipeline(make_loader(corpus, tok), CPU,
                                           put=bad_put)
    with pytest.raises(RuntimeError, match="upload failed"):
        list(pipe.macro_batches(1))


def test_prefetch_abandonment_stops_worker(corpus, tok):
    before = set(threading.enumerate())
    pipe = pipeline.DevicePrefetchPipeline(
        make_loader(corpus, tok, prefetch=2), CPU)
    gen = pipe.macro_batches(1)
    next(gen)
    started = set(threading.enumerate()) - before
    assert started
    gen.close()              # an early break: one bounded join
    for t in started:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in started)


# --------------------------------------------------------- mode selection


def test_build_pipeline_auto_and_refusals(corpus, tok):
    args = Args(device="cpu")
    jargs = JArgs()
    chosen = lambda p: type(p).__name__  # noqa: E731
    # eligible: resident, as in JAX
    got = pipeline.build_pipeline(args, make_loader(corpus, tok))
    assert isinstance(got, pipeline.DeviceResidentPipeline)
    # no EncodedDataset (a collator may change batches per epoch)
    plain = make_loader(corpus, tok, encoded=False)
    assert isinstance(pipeline.build_pipeline(args, plain),
                      pipeline.DevicePrefetchPipeline)
    with pytest.raises(ValueError, match="EncodedDataset"):
        pipeline.build_pipeline(args.replace(pipeline="resident"), plain)
    # over the budget
    tiny = args.replace(pipeline_hbm_mb=0)
    assert isinstance(pipeline.build_pipeline(tiny, make_loader(corpus, tok)),
                      pipeline.DevicePrefetchPipeline)
    with pytest.raises(ValueError, match="budget"):
        pipeline.build_pipeline(tiny.replace(pipeline="resident"),
                                make_loader(corpus, tok))
    # named modes are forced; unknown ones refused
    for mode, cls in (("sync", pipeline.SyncPipeline),
                      ("prefetch", pipeline.DevicePrefetchPipeline)):
        assert isinstance(pipeline.build_pipeline(
            args.replace(pipeline=mode), make_loader(corpus, tok)), cls)
    with pytest.raises(ValueError, match="unknown pipeline"):
        pipeline.build_pipeline(args.replace(pipeline="nope"),
                                make_loader(corpus, tok))
    # JAX's choice on the same kinds of loader
    jt = jtok.WordPieceTokenizer(tok.vocab_list)
    jplain = jloader.DataLoader(corpus, jcollate.Collator(jt, SEQ), BATCH,
                                prefetch=0)
    assert chosen(jpipeline.build_pipeline(jargs, jplain)) == \
        chosen(pipeline.build_pipeline(args, plain))


@pytest.mark.parametrize("mode", ["full", "pack"])
def test_resident_budget_counts_what_the_card_holds(corpus, tok, mode):
    """``--pipeline_hbm_mb`` is held against the resident arrays' bytes,
    counted from the shapes without building them: the split, one filler
    row per channel, and a weight per example where the split has none."""
    enc = make_loader(corpus, tok, mode).encoded
    held = pipeline.resident_arrays(enc)
    assert pipeline.resident_nbytes(enc) == sum(v.nbytes
                                                for v in held.values())


def test_multi_width_packing_falls_back_to_prefetch(tok):
    """A multi-width packed split has no single rectangular encoding:
    ``auto`` takes prefetch, and forcing resident names the reason."""
    rng = np.random.RandomState(1)
    chars = list("天地人你我他好大小上下来去爱乐高兴悲伤")
    data = [("".join(rng.choice(chars) for _ in range(
        int(rng.randint(4, 40)) if i % 10 else int(rng.randint(130, 250)))),
        0) for i in range(100)]
    args = Args(device="cpu", model="bert-tiny-long", max_seq_len=256,
                length_mode="pack", length_buckets="128,256", prefetch=0)
    ld = setup.build_length_train_loader(
        args, data, collate.Collator(tok, 256),
        collate.EncodedDataset(data, tok, 256), batch_size=4)
    pipe = pipeline.build_pipeline(args, ld)
    assert isinstance(pipe, pipeline.DevicePrefetchPipeline)
    assert {b["input_ids"].shape[1] for b, *_ in pipe.macro_batches(1)} == \
        {128, 256}
    with pytest.raises(ValueError, match="multi-width"):
        pipeline.build_pipeline(args.replace(pipeline="resident"), ld)
