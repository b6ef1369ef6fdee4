"""Length-aware training in the PyTorch port against the JAX package
(``--length_mode bucket|pack``): the bucket parsing and checks, the
length-grouped sampler, the single- and multi-width packers, the loader's
bucket and pack batches, the packed forward, and three packed train steps
and the packed eval step, on the CPU with bert-tiny.

Tolerances: the data path is compared byte for byte (same dtype, same
values); a packed segment's logits equal its unpacked example's within
1e-4 (fp32 sums over other key sets, the JAX test's bound); three packed
bert-tiny train steps from the same weights at dropout 0 hold the losses to
1e-5 and the params to 2e-6, the bounds of ``tests/test_torch_train.py``'s
padded steps.
"""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.data import collate as jcollate
from pdnlp_tpu.data import packing as jpacking
from pdnlp_tpu.data import sampler as jsampler
from pdnlp_tpu.data import tokenizer as jtok
from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.train import optim as joptim
from pdnlp_tpu.train import setup as jsetup
from pdnlp_tpu.train import steps as jsteps
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.data import collate, loader, packing, sampler, tokenizer
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.train import setup, steps
from pdnlp_tpu_torch.train.trainer import Trainer
from pdnlp_tpu_torch.utils.config import Args

S = 128
BATCH = 8


@pytest.fixture(scope="module")
def corpus():
    """Mostly short examples with mid and long tails, so every bucket of
    32/64/128 is populated (the JAX test's corpus)."""
    rng = np.random.RandomState(11)
    chars = "天地人你我他好坏大小上下来去爱恨喜怒哀乐"
    data = []
    for _ in range(180):
        n = int(rng.choice([4, 7, 11, 16, 24, 40, 70, 100],
                           p=[.2, .2, .2, .1, .1, .1, .05, .05]))
        data.append(("".join(rng.choice(list(chars)) for _ in range(n)),
                     int(rng.randint(0, 6))))
    return data


@pytest.fixture(scope="module")
def toks(corpus):
    vocab = tokenizer.build_vocab((t for t, _ in corpus), size=128)
    return tokenizer.WordPieceTokenizer(vocab), jtok.WordPieceTokenizer(vocab)


@pytest.fixture(scope="module")
def encs(corpus, toks):
    tok, jt = toks
    return (collate.EncodedDataset(corpus, tok, S),
            jcollate.EncodedDataset(corpus, jt, S))


def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


# ------------------------------------------------------- parse and check


@pytest.mark.parametrize("spec,max_len", [
    ("32,64,128", 128), ("32,64,128", 64), ("16", 32), (" 64 ,32,", 128),
    ("128,256,512", 512), ("512,128", 128), ("32,x", 128), ("1,32", 128)])
def test_parse_buckets_matches_jax(spec, max_len):
    def run(fn):
        try:
            return fn(spec, max_len)
        except ValueError:
            return "ValueError"

    assert run(sampler.parse_buckets) == run(jsampler.parse_buckets)


@pytest.mark.parametrize("widths,mode,max_len", [
    ((32, 64, 128), "bucket", 128), ((64, 512, 1024), "bucket", 1024),
    ((128, 256), "pack", 256), ((128, 2048), "pack", 128),
    ((128,), "pack", 513)])
def test_validate_length_buckets_refuses_as_jax_does(widths, mode, max_len):
    """The same widths pass and the same raise at setup, before any
    gather: an index past the position table is a device-side assert on
    CUDA (JAX clamps it)."""
    outcomes = []
    for fn in (sampler.validate_length_buckets,
               jsampler.validate_length_buckets):
        try:
            fn(widths, max_position=512, model="bert-base", mode=mode,
               max_seq_len=max_len)
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append("ValueError")
            if fn is sampler.validate_length_buckets:
                assert "device-side assert" in str(e) or \
                    "past the table" in str(e)
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("mode", ["auto", "full", "bucket", "pack", "typo"])
def test_resolve_length_mode_matches_jax(mode):
    def run(fn, args):
        try:
            return fn(args)
        except ValueError:
            return "ValueError"

    assert run(sampler.resolve_length_mode, Args(length_mode=mode)) == \
        run(jsampler.resolve_length_mode, JArgs(length_mode=mode))
    assert sampler.resolve_length_mode(Args()) == "full"


def test_args_defaults_match_jax():
    for name in ("length_mode", "length_buckets", "pipeline",
                 "pipeline_hbm_mb", "pack_max_segments"):
        assert getattr(Args(), name) == getattr(JArgs(), name), name


# --------------------------------------------------------------- sampler


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_length_sampler_matches_jax(encs, shards, drop_last):
    """The same global batches (indices and bucket) for two epochs, the
    same per-shard chunks, lengths and batch counts."""
    enc, _ = encs
    buckets = sampler.parse_buckets("32,64,128", S)
    for shard in range(shards):
        a = sampler.LengthGroupedSampler(
            enc.lengths(), batch_size=4, buckets=buckets, num_shards=shards,
            shard_id=shard, seed=5, drop_last=drop_last)
        b = jsampler.LengthGroupedSampler(
            enc.lengths(), batch_size=4, buckets=buckets, num_shards=shards,
            shard_id=shard, seed=5, drop_last=drop_last)
        assert a.batches_per_epoch == b.batches_per_epoch
        assert len(a) == len(b)
        for epoch in range(2):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            ga, gb = a.global_batches(), b.global_batches()
            assert len(ga) == len(gb) == a.batches_per_epoch
            for (ia, ba), (ib, bb) in zip(ga, gb):
                assert ba == bb and np.array_equal(ia, ib)
            assert list(a.chunks()) == list(b.chunks())
            assert list(a) == list(b)
            assert len(list(a)) == len(a)


def test_length_sampler_covers_shards_and_keeps_its_structure(encs):
    """Across two shards every example once, the same bucket at every
    step, members within their bucket; the per-bucket batch counts are the
    same every epoch while the order reshuffles."""
    enc, _ = encs
    buckets = sampler.parse_buckets("32,64,128", S)
    shards = [sampler.LengthGroupedSampler(enc.lengths(), batch_size=4,
                                           buckets=buckets, num_shards=2,
                                           shard_id=i, seed=5)
              for i in range(2)]
    seqs = [list(s.chunks()) for s in shards]
    assert [b for _, b in seqs[0]] == [b for _, b in seqs[1]]
    assert sorted(i for sq in seqs for c, _ in sq for i in c) == \
        list(range(len(enc)))
    L = enc.lengths()
    assert all(L[i] <= b for sq in seqs for c, b in sq for i in c)
    s = shards[0]
    s.set_epoch(1)
    e1 = list(s.chunks())
    assert Counter(b for _, b in e1) == Counter(b for _, b in seqs[0])
    assert [c for c, _ in e1] != [c for c, _ in seqs[0]]


def test_loader_refuses_drop_last_with_a_batching_sampler(corpus, toks,
                                                           encs):
    """The sampler owns the global chunking: a loader-level drop_last would
    drop by shard-local chunk length and desync the processes' steps."""
    tok, _ = toks
    enc, _ = encs
    smp = sampler.LengthGroupedSampler(enc.lengths(), batch_size=4)
    with pytest.raises(ValueError, match="sampler"):
        loader.DataLoader(corpus, collate.Collator(tok, S), 4, sampler=smp,
                          drop_last=True, prefetch=0)
    ok = sampler.LengthGroupedSampler(enc.lengths(), batch_size=4,
                                      drop_last=True)
    ld = loader.DataLoader(corpus, collate.Collator(tok, S), 4, sampler=ok,
                           drop_last=True, prefetch=0, encoded=enc)
    assert len(list(ld)) == len(ld) == ok.batches_per_epoch
    assert all(b["example_weight"].min() == 1.0 for b in ld)


# --------------------------------------------------------------- packing


@pytest.mark.parametrize("cap", [2, 8, 16])
def test_packed_dataset_matches_jax(encs, cap):
    enc, jenc = encs
    a = packing.pack_classification(enc, max_segments=cap)
    b = jpacking.pack_classification(jenc, max_segments=cap)
    _same_arrays(a.arrays, b.arrays)
    assert a.source_rows == b.source_rows
    assert (a.n, a.num_examples, a.max_segments) == \
        (b.n, b.num_examples, b.max_segments)
    assert a.stats() == b.stats()
    np.testing.assert_array_equal(a.lengths(), b.lengths())
    # every example once, under its own label, at a [CLS] at position 0
    w = a.arrays["example_weight"] > 0
    assert int(w.sum()) == len(enc)
    assert a.arrays["segment_ids"].max() <= cap
    assert sorted(i for r in a.source_rows for i in r) == list(range(len(enc)))
    cls = a.arrays["input_ids"][0, 0]
    rows, slots = np.nonzero(w)
    cp = a.arrays["cls_positions"][rows, slots]
    assert (a.arrays["input_ids"][rows, cp] == cls).all()
    assert (a.arrays["position_ids"][rows, cp] == 0).all()


def test_packed_take_keeps_per_segment_weights(encs):
    """``take`` adds a per-row weight only where the arrays have none: a
    packed dataset keeps its ``[N, M]`` per-segment weights, and filler
    rows get zeros."""
    enc, jenc = encs
    a = packing.pack_classification(enc, max_segments=8)
    b = jpacking.pack_classification(jenc, max_segments=8)
    got = a.take([1, 0], pad_to=4)
    _same_arrays(got, b.take([1, 0], pad_to=4))
    assert got["example_weight"].shape == (4, 8)
    np.testing.assert_array_equal(got["example_weight"][:2],
                                  a.arrays["example_weight"][[1, 0]])
    assert not got["example_weight"][2:].any()


@pytest.fixture(scope="module")
def long_encs(toks):
    """Short examples and documents of 129-500 tokens, encoded at 512."""
    tok, jt = toks
    rng = np.random.RandomState(3)
    chars = list("天地人你我他好坏大小上下来去爱恨喜怒哀乐")
    data = []
    for i in range(150):
        n = (int(rng.randint(4, 60)) if i % 5 else
             int(rng.choice([rng.randint(127, 254), rng.randint(255, 498)])))
        data.append(("".join(rng.choice(chars) for _ in range(n)),
                     int(rng.randint(0, 6))))
    return (data, collate.EncodedDataset(data, tok, 512),
            jcollate.EncodedDataset(data, jt, 512))


def test_multi_width_packed_dataset_matches_jax(long_encs):
    _, enc, jenc = long_encs
    a = packing.MultiWidthPackedDataset(enc, (128, 256, 512), max_segments=16)
    b = jpacking.MultiWidthPackedDataset(jenc, (128, 256, 512),
                                         max_segments=16)
    assert a.widths == b.widths and sorted(a.groups) == sorted(b.groups)
    assert len(a.groups) == 3
    for w in a.groups:
        _same_arrays(a.groups[w].arrays, b.groups[w].arrays)
        assert a.groups[w].source_rows == b.groups[w].source_rows
        assert a.groups[w].max_segments == packing.segment_cap(w, 16)
    np.testing.assert_array_equal(a.row_width_table(), b.row_width_table())
    np.testing.assert_array_equal(a.lengths(), b.lengths())
    assert a.stats() == b.stats()
    covered = sorted(i for g in a.groups.values()
                     for r in g.source_rows for i in r)
    assert covered == list(range(len(enc)))
    _same_arrays(a.take([0, 1], pad_to=4, seq_len=128),
                 b.take([0, 1], pad_to=4, seq_len=128))
    with pytest.raises(ValueError, match="mixes widths"):
        a.take([0, a.n - 1], seq_len=128)


# ---------------------------------------------------------------- loader


def _loaders(args, data, encs_, toks_, batch):
    (tok, jt), (enc, jenc) = toks_, encs_
    jargs = JArgs(**{k: getattr(args, k) for k in (
        "length_mode", "length_buckets", "max_seq_len", "pack_max_segments",
        "seed", "prefetch", "model")})
    return (setup.build_length_train_loader(
                args, data, collate.Collator(tok, args.max_seq_len), enc,
                batch_size=batch),
            jsetup.build_length_train_loader(
                jargs, data, jcollate.Collator(jt, args.max_seq_len), jenc,
                batch_size=batch))


@pytest.mark.parametrize("mode,prefetch", [("bucket", 0), ("bucket", 2),
                                           ("pack", 0), ("pack", 2),
                                           ("full", 0)])
def test_loader_batches_match_jax(corpus, toks, encs, mode, prefetch):
    args = Args(model="bert-tiny", length_mode=mode, max_seq_len=S,
                prefetch=prefetch, seed=7)
    got, want = _loaders(args, corpus, encs, toks, BATCH)
    assert len(got) == len(want)
    widths = set()
    for epoch in range(2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        a, b = list(got), list(want)
        assert len(a) == len(b) == len(got)
        for x, y in zip(a, b):
            _same_arrays(x, y)
            widths.add(x["input_ids"].shape[1])
    assert widths == ({32, 64, 128} if mode == "bucket" else {S})


def test_multi_width_loader_batches_match_jax(long_encs, toks):
    data, enc, jenc = long_encs
    args = Args(model="bert-tiny-long", length_mode="pack", max_seq_len=512,
                length_buckets="128,256,512", prefetch=0, seed=3)
    got, want = _loaders(args, data, (enc, jenc), toks, 4)
    assert isinstance(got.encoded, packing.MultiWidthPackedDataset)
    got.set_epoch(1)
    want.set_epoch(1)
    a, b = list(got), list(want)
    assert len(a) == len(b) == len(got)
    for x, y in zip(a, b):
        _same_arrays(x, y)
    assert {x["input_ids"].shape[1] for x in a} == {128, 256, 512}


def test_collator_and_take_at_a_bucket_width_match_jax(corpus, toks, encs):
    """``Collator(seq_len=)`` and ``take(seq_len=)``: the column slice of
    the full-width encoding is the direct encoding at the bucket width."""
    (tok, jt), (enc, jenc) = toks, encs
    short = [i for i, l in enumerate(enc.lengths()) if l <= 32][:6]
    got = enc.take(short, pad_to=8, seq_len=32)
    _same_arrays(got, jenc.take(short, pad_to=8, seq_len=32))
    direct = collate.Collator(tok, S)([corpus[i] for i in short], pad_to=8,
                                      seq_len=32)
    _same_arrays(got, direct)
    _same_arrays(direct, jcollate.Collator(jt, S)(
        [corpus[i] for i in short], pad_to=8, seq_len=32))
    np.testing.assert_array_equal(enc.lengths(), jenc.lengths())


# -------------------------------------------------------------- numerics


@pytest.fixture(scope="module")
def tiny(toks):
    """bert-tiny weights from the JAX initialiser, as a numpy tree."""
    tok, _ = toks
    jcfg = jax_get_config("bert-tiny", vocab_size=tok.vocab_size,
                          num_labels=6, dropout=0.0, attn_dropout=0.0)
    return jcfg, jax.tree_util.tree_map(
        np.asarray, jbert.init_params(jax.random.key(0), jcfg))


def _port_model(tok, tiny_params, **kw):
    args = Args(device="cpu", model="bert-tiny", dropout=0.0,
                attn_dropout=0.0, **kw)
    _, state = setup.setup_model(args, tok.vocab_size, total_steps=10)
    state.model.load_state_dict(convert.from_jax_params(tiny_params))
    return args, state


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def test_packed_rows_give_their_examples_unpacked_logits(toks, encs, tiny):
    """Every segment of a packed row has its example's unpacked logits
    (1e-4), in the port and in JAX: block-diagonal attention and
    per-segment positions keep each example's math."""
    tok, _ = toks
    enc, _ = encs
    jcfg, params = tiny
    _, state = _port_model(tok, params)
    packed = packing.pack_classification(enc, max_segments=8)
    with torch.no_grad():
        lp = state.model.classify(_t(packed.arrays)).numpy()
        lu = state.model.classify(_t({k: v for k, v in enc.arrays.items()
                                      if k != "label"})).numpy()
    jp = np.asarray(jbert.classify(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg,
        {k: jnp.asarray(v) for k, v in packed.arrays.items()}))
    np.testing.assert_allclose(lp, jp, atol=1e-4)
    w = packed.arrays["example_weight"] > 0
    checked = 0
    for r, members in enumerate(packed.source_rows):
        for s_, orig in enumerate(members):
            assert w[r, s_]
            np.testing.assert_allclose(lp[r, s_], lu[orig], atol=1e-4)
            assert lp[r, s_].argmax() == lu[orig].argmax()
            checked += 1
    assert checked == len(enc)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_packed_train_steps_match_jax(corpus, toks, encs, tiny, route):
    """Three fp32 train steps of bert-tiny on packed batches from the same
    weights at dropout 0 with label smoothing 0.1: losses, accuracies and
    params against JAX ``build_train_step``.  ``pallas``: the flash and
    fused-CE twins in the port against the Pallas kernels in interpret
    mode; ``xla``: the plain paths."""
    tok, _ = toks
    jcfg, params = tiny
    kw = dict(attention_impl=route, fused_ce=route, learning_rate=1e-3,
              label_smoothing=0.1, length_mode="pack", pack_max_segments=8)
    args, state = _port_model(tok, params, **kw)
    got_loader, _ = _loaders(args.replace(prefetch=0), corpus, encs, toks,
                             BATCH)
    got_loader.set_epoch(0)
    batches = list(got_loader)[:3]
    assert all(b["example_weight"].shape == (BATCH, 8) for b in batches)
    jargs = JArgs(model="bert-tiny", dropout=0.0, attn_dropout=0.0, **kw)
    tx = joptim.build_optimizer(params, jargs)
    jstate = jsteps.init_state(jax.random.key(0), jcfg, tx,
                               rng=jax.random.key(1),
                               params=jax.tree_util.tree_map(jnp.asarray,
                                                             params))
    jstep = jax.jit(jsteps.build_train_step(jcfg, tx, jargs))
    step = steps.build_train_step(args, torch.device("cpu"))
    for batch in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        m = step(state, _t(batch))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    got = convert.to_jax_params(state.model.state_dict())
    want = jax.tree_util.tree_map(np.asarray, jstate["params"])
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(g, w, atol=2e-6, err_msg=str(path))


def test_packed_eval_step_matches_jax(toks, encs, tiny):
    """The eval step flattens packed outputs to example rows: the loss sum,
    weight, correct count and per-example predictions of JAX's."""
    tok, _ = toks
    enc, _ = encs
    jcfg, params = tiny
    args, state = _port_model(tok, params)
    packed = packing.pack_classification(enc, max_segments=8)
    batch = packed.take(list(range(5)), pad_to=6)
    m = steps.build_eval_step(args)(state.model, None, _t(batch))
    jm = jsteps.build_eval_step(jcfg, JArgs(model="bert-tiny"))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(m["weight"]) == float(jm["weight"]) == \
        int((batch["example_weight"] > 0).sum())
    assert m["pred"].shape == (6 * 8,)
    for k in ("loss_sum", "correct"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4, k
    for k in ("pred", "label", "ew"):
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]))


def test_trainer_test_on_packed_rows_drops_empty_slots(corpus, toks, encs,
                                                       tiny, tmp_path):
    """``Trainer.test`` on a packed loader keeps one prediction per real
    example: the filler drop reads the flat weights."""
    tok, _ = toks
    jcfg, params = tiny
    args, state = _port_model(tok, params, length_mode="pack",
                              output_dir=str(tmp_path))
    ld, _ = _loaders(args.replace(prefetch=0), corpus, encs, toks, BATCH)
    tr = Trainer(args, None, state, None, steps.build_eval_step(args),
                 torch.device("cpu"))
    r = tr.test(ld)
    assert len(r["y_true"]) == len(r["y_pred"]) == len(corpus)
    assert Counter(r["y_true"]) == Counter(lab for _, lab in corpus)
