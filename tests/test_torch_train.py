"""The PyTorch port's training slice against the JAX package's: the data
path byte for byte, the decay groups, AdamW and the schedules against
optax, the weighted CE, three train steps from the same weights, and the
``Trainer``'s lines and report byte for byte — on the CPU, bert-tiny, the
synthetic corpus of ``tests/conftest.py:corpus_path``.

Tolerances: the CE and one AdamW step are fp32 rounding (1e-6); three
bert-tiny train steps from the same weights at dropout 0 hold the losses to
1e-5 and the params to 2e-6 (fp32 sums taken in another order by two
frameworks, through an Adam update that divides by sqrt(v) + 1e-6).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdnlp_tpu.data import collate as jcollate
from pdnlp_tpu.data import corpus as jcorpus
from pdnlp_tpu.data import loader as jloader
from pdnlp_tpu.data import sampler as jsampler
from pdnlp_tpu.data import tokenizer as jtok
from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.train import optim as joptim
from pdnlp_tpu.train import steps as jsteps
from pdnlp_tpu.utils import logging as jlog
from pdnlp_tpu.utils import metrics as jmetrics
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu.utils.profiling import StepStats
from pdnlp_tpu_torch.data import collate, corpus, loader, sampler, tokenizer
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.models.bert import BertClassifier
from pdnlp_tpu_torch.models.config import get_config
from pdnlp_tpu_torch.train import optim, steps
from pdnlp_tpu_torch.train.setup import setup_model
from pdnlp_tpu_torch.utils import logging as tlog
from pdnlp_tpu_torch.utils import metrics
from pdnlp_tpu_torch.utils.config import Args
from pdnlp_tpu_torch.utils.profiling import StepStats as PortStepStats

VOCAB = 120


@pytest.fixture(scope="module")
def split(corpus_path):
    """(port split, JAX split, port tokenizer, JAX tokenizer) of a 300-
    example slice."""
    data = corpus.load_data(corpus_path)
    port = corpus.split_data(data, seed=123, limit=300, ratio=0.9)
    ref = jcorpus.split_data(jcorpus.load_data(corpus_path), seed=123,
                             limit=300, ratio=0.9)
    vocab = tokenizer.build_vocab(t for t, _ in data)
    return port, ref, tokenizer.WordPieceTokenizer(vocab), \
        jtok.WordPieceTokenizer(vocab)


def _same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_split_matches_jax(corpus_path, split):
    port, ref, _, _ = split
    assert port == ref
    data = corpus.load_data(corpus_path)
    assert corpus.split_data(data) == jcorpus.split_data(data)
    assert len(corpus.split_data(data, limit=100)[0]) == 92


def test_collator_and_encoded_batches_match_jax(split):
    (train, _), _, tok, jt = split
    for n, pad_to in ((5, 8), (32, 32), (3, 0)):
        ex = train[:n]
        _same_batch(collate.Collator(tok, 64)(ex, pad_to=pad_to),
                    jcollate.Collator(jt, 64)(ex, pad_to=pad_to))
    enc = collate.EncodedDataset(train, tok, 128)
    jenc = jcollate.EncodedDataset(train, jt, 128)
    assert len(enc) == len(jenc)
    for idx in ([0, 5, 7], list(range(40, 72)), [3]):
        _same_batch(enc.take(idx, pad_to=32), jenc.take(idx, pad_to=32))
    # the encoded split and the collator give the same bytes
    _same_batch(enc.take(list(range(10)), pad_to=16),
                collate.Collator(tok, 128)(train[:10], pad_to=16))


@pytest.mark.parametrize("shards,shuffle,drop_last",
                         [(1, True, False), (2, True, False),
                          (3, False, True)])
def test_sampler_orders_match_jax(shards, shuffle, drop_last):
    for shard in range(shards):
        a = sampler.DistributedShardSampler(101, shards, shard, shuffle,
                                            seed=7, drop_last=drop_last)
        b = jsampler.DistributedShardSampler(101, shards, shard, shuffle,
                                             seed=7, drop_last=drop_last)
        for epoch in range(3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b) and len(a) == len(b)


@pytest.mark.parametrize("prefetch,drop_last,encoded",
                         [(2, False, True), (0, True, True), (1, False, False)])
def test_loader_batches_match_jax(split, prefetch, drop_last, encoded):
    (train, _), _, tok, jt = split
    loaders = []
    for mod, smp, col, enc, t in (
            (loader, sampler, collate, collate, tok),
            (jloader, jsampler, jcollate, jcollate, jt)):
        loaders.append(mod.DataLoader(
            train, col.Collator(t, 128), 32,
            sampler=smp.DistributedShardSampler(len(train), seed=123),
            drop_last=drop_last, prefetch=prefetch,
            encoded=enc.EncodedDataset(train, t, 128) if encoded else None))
    assert len(loaders[0]) == len(loaders[1])
    for epoch in range(2):
        for ld in loaders:
            ld.set_epoch(epoch)
        got, want = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == len(loaders[0])
        for a, b in zip(got, want):
            _same_batch(a, b)
    last = got[-1]["example_weight"]
    assert drop_last or last.min() == 0.0      # filler rows, weight 0


def test_loader_worker_stops_when_the_consumer_leaves(split):
    """An early break with the queue full: the stop-aware worker is gone
    once the generator closes."""
    import threading

    (train, _), _, tok, _ = split
    before = set(threading.enumerate())
    ld = loader.DataLoader(train, collate.Collator(tok, 32), 4, prefetch=1)
    it = iter(ld)
    next(it)
    workers = set(threading.enumerate()) - before
    assert len(workers) == 1
    it.close()                                 # an early break
    assert not any(t.is_alive() for t in workers)


# --------------------------------------------------------- optimizer


@pytest.fixture(scope="module")
def tiny_params():
    jcfg = jax_get_config("bert-tiny", vocab_size=VOCAB)
    return jax.tree_util.tree_map(
        np.asarray, jbert.init_params(jax.random.key(0), jcfg))


def test_decay_groups_match_jax_decay_mask(tiny_params):
    """Every port parameter's decay flag, carried to the JAX tree by the
    bridge, equals ``decay_mask``; the counts agree once JAX's stacked
    layer leaves are counted per layer."""
    model = BertClassifier(get_config("bert-tiny", vocab_size=VOCAB))
    flags = {n: torch.tensor(optim.is_decayed(n))
             for n, _ in model.named_parameters()}
    got = convert.to_jax_params(flags)
    want = joptim.decay_mask(tiny_params)
    paths_g = jax.tree_util.tree_leaves_with_path(got)
    paths_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in paths_g] == [p for p, _ in paths_w]
    for (path, g), (_, w) in zip(paths_g, paths_w):
        assert np.all(np.asarray(g) == w), path
    L = model.cfg.num_layers
    jdec, jex = joptim.count_decayed(tiny_params)
    layer_dec = sum(1 for p, w in paths_w if "layers" in str(p[0]) and w)
    layer_ex = sum(1 for p, w in paths_w if "layers" in str(p[0]) and not w)
    assert optim.count_decayed(model) == (jdec + (L - 1) * layer_dec,
                                          jex + (L - 1) * layer_ex)
    groups = optim.decay_groups(model, 0.01)
    assert [g["weight_decay"] for g in groups] == [0.01, 0.0]
    assert sum(len(g["params"]) for g in groups) == len(list(
        model.parameters()))


def test_adamw_steps_match_optax():
    """Three decoupled AdamW updates, two decay groups, eps outside the
    square root: torch's AdamW against optax.adamw with the mask."""
    r = np.random.RandomState(0)
    params = {"w": r.randn(5, 4).astype(np.float32),
              "bias": r.randn(4).astype(np.float32)}
    grads = [{k: (r.randn(*v.shape) * 10.0 ** -r.randint(0, 7)).astype(
        np.float32) for k, v in params.items()} for _ in range(3)]
    args = Args(learning_rate=1e-2, weight_decay=0.1)
    tx = optax.adamw(args.learning_rate, b1=args.adam_b1, b2=args.adam_b2,
                     eps=args.adam_eps, weight_decay=args.weight_decay,
                     mask={"w": True, "bias": False})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.AdamW(
        [{"params": [tp["w"]], "weight_decay": args.weight_decay},
         {"params": [tp["bias"]], "weight_decay": 0.0}],
        lr=args.learning_rate, betas=(args.adam_b1, args.adam_b2),
        eps=args.adam_eps)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k])
        opt.step()
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", ["warmup_linear", "warmup_cosine"])
@pytest.mark.parametrize("total", [7, 50])
def test_schedules_match_optax(name, total):
    args = Args(lr_schedule=name, learning_rate=5e-5, warmup_ratio=0.1)
    jargs = JArgs(lr_schedule=name, learning_rate=5e-5, warmup_ratio=0.1)
    got = optim.make_schedule(args, total)
    want = joptim.make_schedule(jargs, total)
    for c in range(total + 3):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                   atol=1e-12, err_msg=f"count {c}")
    # the optimizer's learning rate follows it, update by update
    model = torch.nn.Linear(2, 2)
    opt, sched = optim.build_optimizer(model, args, total)
    for c in range(5):
        assert opt.param_groups[0]["lr"] == pytest.approx(got(c), rel=1e-9)
        opt.step()
        sched.step()
    assert optim.make_schedule(Args(), total) is None
    with pytest.raises(ValueError, match="total_steps"):
        optim.make_schedule(args, 0)


# ------------------------------------------------------------ steps


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_weighted_ce_matches_jax(smoothing):
    r = np.random.RandomState(3)
    logits = r.randn(20, 6).astype(np.float32)
    logits[0, 2] = logits[0, 4] = logits[0].max() + 1       # a tie
    labels = r.randint(0, 6, 20).astype(np.int32)
    labels[0] = 4
    w = (r.rand(20) > 0.3).astype(np.float32)
    want = jsteps.weighted_ce(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(w), smoothing)
    got = steps.weighted_ce(torch.from_numpy(logits),
                            torch.from_numpy(labels), torch.from_numpy(w),
                            smoothing)
    for g, x in zip(got, want):
        assert abs(float(g) - float(x)) <= 1e-6


def _train_batches(B=8, S=128, n=3, seed=0):
    """Padded batches with a filler row each (all-zero mask, weight 0)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.zeros((B, S), np.int32)
        for b in range(B - 1):
            mask[b, : r.randint(8, S + 1)] = 1
        out.append({
            "input_ids": (r.randint(5, VOCAB, (B, S)) * mask).astype(np.int32),
            "token_type_ids": np.zeros((B, S), np.int32),
            "attention_mask": mask,
            "label": r.randint(0, 6, B).astype(np.int32),
            "example_weight": (np.arange(B) < B - 1).astype(np.float32),
        })
    return out


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_train_steps_match_jax(tiny_params, route):
    """Three fp32 train steps of bert-tiny from the same (JAX-initialised)
    weights at dropout 0, label smoothing 0.1 and a warmup schedule: the
    losses, accuracies and updated params of the port against JAX
    ``build_train_step``.  ``pallas``: the flash and fused-CE kernels'
    twins on the port side, the Pallas kernels in interpret mode on the
    JAX side; ``xla``: the plain paths."""
    kw = dict(model="bert-tiny", dropout=0.0, attn_dropout=0.0,
              attention_impl=route, fused_ce=route, learning_rate=1e-3,
              label_smoothing=0.1, lr_schedule="warmup_linear",
              warmup_ratio=0.3)
    batches = _train_batches()
    jargs = JArgs(**kw)
    jcfg = jax_get_config("bert-tiny", vocab_size=VOCAB).replace(
        dropout=0.0, attn_dropout=0.0)
    tx = joptim.build_optimizer(tiny_params, jargs,
                                schedule=joptim.make_schedule(jargs, 10))
    jstate = jsteps.init_state(jax.random.key(0), jcfg, tx,
                               rng=jax.random.key(1),
                               params=jax.tree_util.tree_map(jnp.asarray,
                                                             tiny_params))
    jstep = jax.jit(jsteps.build_train_step(jcfg, tx, jargs))
    args = Args(device="cpu", **kw)
    _, state = setup_model(args, VOCAB, total_steps=10)
    state.model.load_state_dict(convert.from_jax_params(tiny_params))
    step = steps.build_train_step(args, torch.device("cpu"))
    for batch in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
        assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))
    got = convert.to_jax_params(state.model.state_dict())
    want = jax.tree_util.tree_map(np.asarray, jstate["params"])
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(g, w, atol=2e-6, err_msg=str(path))
    assert state.step == 3


def test_dropout_is_seeded_and_routes_attention_to_the_plain_path():
    """With dropout on, a train step draws from the state's generator: the
    same seed gives the same params, another seed other ones; attention
    dropout takes the plain path even when the kernel is asked for."""
    from pdnlp_tpu_torch.ops import attention

    assert attention.routed_impl("pallas", "cuda", dropout=True) == "xla"
    assert attention.routed_impl("auto", "cuda", dropout=True) == "xla"
    assert attention.routed_impl("auto", "cuda", dropout=False) == "pallas"
    batch = {k: torch.from_numpy(v) for k, v in _train_batches(4, 32, 1)[0]
             .items()}
    outs = []
    for seed in (1, 1, 2):
        args = Args(device="cpu", model="bert-tiny", seed=seed,
                    attention_impl="pallas", fused_ce="pallas")
        _, state = setup_model(args, VOCAB)
        m = steps.build_train_step(args, torch.device("cpu"))(state, batch)
        assert torch.isfinite(m["loss"])
        outs.append(state.model.state_dict()["layers.0.q.weight"].clone())
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    model = BertClassifier(get_config("bert-tiny", vocab_size=VOCAB))
    with pytest.raises(ValueError, match="generator"):
        model.classify(batch, deterministic=False)


def test_ema_tracks_the_params_and_evaluates():
    args = Args(device="cpu", model="bert-tiny", dropout=0.0,
                attn_dropout=0.0, ema_decay=0.5, learning_rate=1e-2)
    _, state = setup_model(args, VOCAB)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    batch = {k: torch.from_numpy(v) for k, v in _train_batches(4, 32, 1)[0]
             .items()}
    steps.build_train_step(args, torch.device("cpu"))(state, batch)
    after = state.model.state_dict()
    k = "layers.0.q.weight"
    torch.testing.assert_close(state.ema[k], 0.5 * before[k] + 0.5 * after[k])
    ev = steps.build_eval_step(args)
    m_ema = ev(state.model, state.ema, batch)
    m_live = ev(state.model, None, batch)
    m_before = ev(state.model, before, batch)
    assert float(m_ema["loss_sum"]) != float(m_live["loss_sum"])
    assert float(m_before["weight"]) == 3.0
    assert m_ema["pred"].shape == (4,)


# ---------------------------------------------------- trainer, formats


def test_log_formats_match_jax_byte_for_byte():
    for args in ((1, 1, 10, 288, 1.7917594), (2, 3, 1, 1, 0.0)):
        assert tlog.fmt_train(*args) == jlog.fmt_train(*args)
    assert tlog.fmt_dev(1.23456789, 0.875) == jlog.fmt_dev(1.23456789, 0.875)
    assert tlog.fmt_best(0.5) == jlog.fmt_best(0.5)
    assert tlog.fmt_elapsed_minutes(0.1234) == \
        jlog.fmt_elapsed_minutes(0.1234)
    for s, e, m in ((288, 9200, 0.37), (0, 0, 0.0)):
        assert PortStepStats(s, e, m).line() == StepStats(s, e, m).line()
    r = np.random.RandomState(0)
    yt, yp = r.randint(0, 6, 50).tolist(), r.randint(0, 6, 50).tolist()
    for names in (corpus.LABELS, None):
        assert metrics.classification_report(yt, yp, names) == \
            jmetrics.classification_report(yt, yp, names)
    assert metrics.accuracy(yt, yp) == jmetrics.accuracy(yt, yp)


def test_trainer_run_prints_the_reference_lines(corpus_path, tmp_path,
                                                capsys):
    """``train.single`` on the CPU: every printed line re-formats to
    itself through the JAX formatters, dev runs every ``eval_step``, the
    report is JAX's for the same predictions, and the checkpoint serves."""
    from pdnlp_tpu_torch.serve.engine import build_engine
    from pdnlp_tpu_torch.train import single

    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                vocab_path=str(tmp_path / "vocab.txt"),
                output_dir=str(tmp_path / "out"), data_limit=200,
                train_batch_size=16, dev=True, eval_step=4,
                attn_dropout=0.0, seed=5)
    single.main(args)
    lines = capsys.readouterr().out.splitlines()
    train = [ln for ln in lines if ln.startswith("【train】")]
    assert len(train) == 12                  # 184 examples / 16
    for ln in train:
        e, E, s, S, loss = re.fullmatch(
            r"【train】 epoch：(\d+)/(\d+) step：(\d+)/(\d+) loss：(\S+)",
            ln).groups()
        assert jlog.fmt_train(int(e), int(E), int(s), int(S),
                              float(loss)) == ln
    dev = [ln for ln in lines if ln.startswith("【dev】")]
    assert len(dev) == 3
    for ln in dev:
        loss, acc = re.fullmatch(r"【dev】 loss：(\S+) accuracy：(\S+)",
                                 ln).groups()
        assert jlog.fmt_dev(float(loss), float(acc)) == ln
    minutes = next(ln for ln in lines if ln.startswith("耗时："))
    assert jlog.fmt_elapsed_minutes(float(minutes[3:-2])) == minutes
    assert any(ln.startswith("steps/s：") for ln in lines)
    head = lines.index(next(ln for ln in lines if "precision" in ln))
    report = "\n".join(lines[head:head + 11])
    assert report.splitlines()[2].strip().startswith(corpus.LABELS[0])
    assert "accuracy" in report and report.count("\n") == 10
    engine = build_engine(args, checkpoint=args.ckpt_path())
    assert engine.classify_texts(["天地人"])[1].shape == (1, 6)


def test_entry_point_refusals(tmp_path, corpus_path):
    """What the entry points take and refuse: ``train.single`` takes
    ``--elastic`` (read by the spawn launcher alone, ignored here as JAX
    ignores it) and ``--heartbeat_interval``, whose loop beats once a step
    (``parallel.watchdog.Heartbeat``, as JAX's trainer does); the data-
    parallel paths still to port are refused by name (ROADMAP A7)."""
    from pdnlp_tpu_torch.parallel.watchdog import heartbeat_file
    from pdnlp_tpu_torch.train import single
    from pdnlp_tpu_torch.train import multi
    from pdnlp_tpu_torch.train.run import build_single_trainer

    for argv in (["--elastic", "1"], ["--heartbeat_interval", "5"]):
        assert single.refuse_not_ported(argv) == argv
    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                vocab_path=str(tmp_path / "v.txt"), data_limit=80,
                max_seq_len=16, train_batch_size=16, dropout=0.0,
                attn_dropout=0.0, output_dir=str(tmp_path),
                heartbeat_interval=1e-9, log_every=10 ** 9, pipeline="sync")
    trainer, loader, _ = build_single_trainer(args)
    trainer.train(loader)
    import json

    with open(heartbeat_file(str(tmp_path), 0)) as f:
        assert json.load(f)["step"] == len(loader)
    ported = ["--length_mode", "pack", "--pipeline", "resident",
              "--fuse_steps", "4", "--resume_every", "10", "--grads_dtype",
              "compute", "--trace", "1", "--profile_dir", "p",
              "--metrics_port", "9000", "--flight_recorder", "f",
              "--init_from", "x.msgpack", "--init_head", "true"]
    assert single.refuse_not_ported(ported) == ported
    table = multi.MULTI_NOT_PORTED
    assert multi.refuse_not_ported(["--init_from", "x.msgpack",
                                    "--init_head", "true"], table) == \
        ["--init_from", "x.msgpack", "--init_head", "true"]
    assert multi.refuse_not_ported(["--fuse_steps", "1", "--dev", "1"],
                                   table) == ["--dev", "1"]
    with pytest.raises(SystemExit, match="ROADMAP A7"):
        multi.refuse_not_ported(["--fuse_steps", "4"], table)
    assert multi.refuse_not_ported(["--grads_dtype", "compute"], table) \
        == ["--grads_dtype", "compute"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            setup_model(Args(model="bert-tiny"), VOCAB)


def test_single_trains_with_remat_and_matches_without(corpus_path, tmp_path,
                                                      capsys):
    """``train.single --remat true`` (no longer refused) trains, and at
    dropout 0 its loss lines and weights are ``--remat false``'s: the
    recompute gives the same activations."""
    from pdnlp_tpu_torch.train import single

    assert single.refuse_not_ported(["--remat", "true"]) == ["--remat",
                                                             "true"]
    runs = {}
    for remat in (True, False):
        out = tmp_path / f"remat_{remat}"
        args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                    vocab_path=str(tmp_path / "vocab.txt"),
                    output_dir=str(out), data_limit=120,
                    train_batch_size=16, dropout=0.0, attn_dropout=0.0,
                    learning_rate=1e-3, remat=remat)
        single.main(args)
        lines = capsys.readouterr().out.splitlines()
        losses = [float(ln.rsplit("：", 1)[1]) for ln in lines
                  if ln.startswith("【train】")]
        runs[remat] = (losses, torch.load(args.ckpt_path(),
                                          weights_only=True)["state_dict"])
    assert len(runs[True][0]) == 7
    np.testing.assert_allclose(runs[True][0], runs[False][0], atol=1e-6)
    for k, v in runs[False][1].items():
        torch.testing.assert_close(runs[True][1][k], v, atol=1e-6, rtol=0)
