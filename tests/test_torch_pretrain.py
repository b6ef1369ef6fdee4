"""Masked-LM pretraining and the warm start in the PyTorch port against
the JAX package — the twin of ``tests/test_pretrain.py``, on the CPU with
bert-tiny and the ``corpus_path`` corpus:

- ``pack_texts``, ``PackedLoader`` and both corpora (pretraining and the
  supervised stage's) byte for byte;
- ``mask_tokens``' statistics and invariants in both packages (the draws
  are each package's own: JAX's ``threefry``, the port's generator);
- one MLM step at JAX's own mask for step 0: the loss, ``mask_acc``, every
  gradient (within 5e-5 of its leaf's largest) and the params after one
  AdamW update, fp32, within 5e-5 (the flash tests' gradient bound), on
  both attention routes;
- the decay groups over trunk + head and the pretraining schedule;
- a real bert-tiny pretraining run, the artifact's bytes and its loads in
  both packages, the supervised stage, ``--init_from`` / ``--init_head``
  on ``setup_model`` and ``setup_sharded_model`` (dp, and zero in a 2-rank
  gloo gang) and the entry point's refusals and lines.
"""
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdnlp_tpu.data import packing as jpacking
from pdnlp_tpu.data import tokenizer as jtok
from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.train import optim as joptim
from pdnlp_tpu.train import pretrain as jpre
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.data import packing, tokenizer
from pdnlp_tpu_torch.data.corpus import load_data
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train import optim, pretrain
from pdnlp_tpu_torch.train.setup import setup_model
from pdnlp_tpu_torch.utils.config import Args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["今天天气真好", "我 很 高兴", "讨厌下雨", "伤心极了", "愤怒",
         "平常心", "喜欢喝茶", "开心一整天", "难过的一天", "无聊"]
#: the MLM step at a fixed mask, fp32: the gradient bound of the flash tests
STEP_ATOL = 5e-5
GANG_TIMEOUT = 300


@pytest.fixture(scope="module")
def toks():
    vocab = tokenizer.build_vocab(TEXTS * 3, min_freq=1)
    return tokenizer.WordPieceTokenizer(vocab), jtok.WordPieceTokenizer(vocab)


@pytest.fixture(scope="module")
def work(tmp_path_factory, corpus_path):
    """The shared corpus vocab file and the common small-run fields (both
    packages read the same ``Args`` fields)."""
    d = tmp_path_factory.mktemp("pretrain")
    vocab_path = str(d / "vocab.txt")
    tokenizer.save_vocab(tokenizer.build_vocab(
        t for t, _ in load_data(corpus_path)), vocab_path)
    common = dict(model="bert-tiny", max_seq_len=32, data_path=corpus_path,
                  vocab_path=vocab_path, data_limit=300, log_every=10 ** 9,
                  dropout=0.0, attn_dropout=0.0)
    return d, common


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("S", [16, 32])
def test_pack_texts_matches_jax_byte_for_byte(toks, S):
    """Greedy last-row fill in the texts' order, a text longer than S - 2
    truncated to fill its row exactly, 1-based segments, 0 on padding."""
    tok, jt = toks
    texts = TEXTS + ["好" * 100] + TEXTS[:3]
    got = packing.pack_texts(tok, texts, S)
    want = jpacking.pack_texts(jt, texts, S)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    ids, segs = got["input_ids"], got["segment_ids"]
    assert (ids == tok.cls_id).sum() == len(texts)
    assert ((segs == 0) == (ids == tok.pad_id)).all()
    assert (segs > 0).sum(1).max() == S          # the long text fills a row
    assert ids.shape[0] < len(texts)             # packing packs


def test_packed_loader_matches_jax_over_two_epochs():
    r = np.random.RandomState(0)
    packed = {"input_ids": r.randint(0, 50, (43, 8)).astype(np.int32),
              "segment_ids": r.randint(0, 3, (43, 8)).astype(np.int32)}
    got = pretrain.PackedLoader(packed, 8, seed=5)
    want = jpre.PackedLoader(packed, 8, seed=5)
    assert len(got) == len(want) == 5
    seen = []
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        pairs = list(zip(got, want, strict=True))
        for a, b in pairs:
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(a[k], b[k])
        seen.append(np.concatenate([a["input_ids"] for a, _ in pairs]))
    assert not np.array_equal(seen[0], seen[1])


@pytest.mark.parametrize("limit", [None, 150])
def test_corpora_match_jax_and_hold_out_the_dev_split(work, limit):
    from pdnlp_tpu.data.corpus import load_data as jload
    from pdnlp_tpu.data.corpus import split_data as jsplit

    _, common = work
    args = Args(pretrain_limit=limit, **common)
    jargs = JArgs(pretrain_limit=limit, **common)
    vocab = tokenizer.load_vocab(args.vocab_path)
    got = pretrain.build_pretrain_corpus(args,
                                         tokenizer.WordPieceTokenizer(vocab))
    want = jpre.build_pretrain_corpus(jargs, jtok.WordPieceTokenizer(vocab))
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    ext = pretrain.build_supervised_corpus(args)
    assert ext == jpre.build_supervised_corpus(jargs)
    data = jload(args.data_path)
    _, dev = jsplit(data, seed=args.seed, limit=args.data_limit,
                    ratio=args.ratio)
    dev_texts = {t for t, _ in dev}
    assert ext and not any(t in dev_texts for t, _ in ext)
    kept = [t for t, _ in data if t not in dev_texts][:limit]
    assert got["input_ids"].shape[0] == packing.pack_texts(
        tokenizer.WordPieceTokenizer(vocab), kept, 32)["input_ids"].shape[0]


# ------------------------------------------------------------- masking


def _mask_stats(ids, corrupted, labels, w, mask_id):
    sel = np.asarray(w) > 0
    maskable = ids >= pretrain.N_SPECIALS
    c = np.asarray(corrupted)
    np.testing.assert_array_equal(np.asarray(labels), ids)  # labels echo
    np.testing.assert_array_equal(c[~sel], ids[~sel])       # untouched
    assert not sel[~maskable].any()                        # specials never
    return (sel.sum() / maskable.sum(), (c[sel] == mask_id).mean(),
            (c[sel] == ids[sel]).mean())


def _port_mask(ids, mask_id, vocab, span, seed=0, step=0):
    g = pretrain.mask_generator(seed, step, "cpu")
    return [t.numpy() for t in pretrain.mask_tokens(
        g, torch.from_numpy(ids), mask_id, vocab, 0.15, span=span)]


def _jax_mask(ids, mask_id, vocab, span, key=0):
    return [np.asarray(a) for a in jpre.mask_tokens(
        jax.random.PRNGKey(key), jnp.asarray(ids), mask_id, vocab, 0.15,
        span=span)]


@pytest.mark.parametrize("span", [False, True])
def test_mask_tokens_statistics_match_jax(toks, span):
    """On the same [64, 128] ids, in both packages: ~15% of the maskable
    positions selected, of those ~80% [MASK] and ~10% kept; labels echo
    the input, unselected positions and ids 0-4 untouched.  In span mode
    the two packages' selected fractions are within 0.02."""
    tok, _ = toks
    mask_id, V = tok.vocab["[MASK]"], tok.vocab_size + 200
    r = np.random.RandomState(3)
    ids = r.randint(pretrain.N_SPECIALS, V, (64, 128)).astype(np.int32)
    ids[:, ::17] = tok.sep_id                    # some specials in every row
    fracs = []
    for got in (_port_mask(ids, mask_id, V, span),
                _jax_mask(ids, mask_id, V, span)):
        sel, masked, kept = _mask_stats(ids, *got, mask_id)
        assert 0.12 < sel < 0.18, sel
        assert 0.75 < masked < 0.85, masked
        assert 0.05 < kept < 0.15, kept
        fracs.append(sel)
    if span:
        assert abs(fracs[0] - fracs[1]) < 0.02, fracs
    specials = np.tile(np.arange(5, dtype=np.int32), (8, 20))
    for got in (_port_mask(specials, mask_id, V, span),
                _jax_mask(specials, mask_id, V, span)):
        assert got[2].sum() == 0
        np.testing.assert_array_equal(got[0], specials)


def test_span_masks_never_cross_a_packed_text(toks, corpus_path):
    """Span mode on packed rows: the selection inside each text equals the
    selection of a row where every other position is [PAD] — the same
    draws (same generator, same shape), so no span started in one text
    reaches into the next, in either package.  The mask also repeats for
    the same (seed, step) and differs for another step."""
    texts = [t for t, _ in load_data(corpus_path)[:120]]
    tok = tokenizer.WordPieceTokenizer(tokenizer.build_vocab(texts))
    V = tok.vocab_size
    packed = packing.pack_texts(tok, texts, 64)
    ids, segs = packed["input_ids"][:8], packed["segment_ids"][:8]
    mask_id = tok.vocab["[MASK]"]
    for masker in (lambda x: _port_mask(x, mask_id, V, True),
                   lambda x: _jax_mask(x, mask_id, V, True)):
        whole = masker(ids)[2] > 0
        assert whole.any()
        for seg in range(1, int(segs.max()) + 1):
            alone = np.where(segs == seg, ids, tok.pad_id).astype(np.int32)
            inside = segs == seg
            np.testing.assert_array_equal((masker(alone)[2] > 0)[inside],
                                          whole[inside])
    again = _port_mask(ids, mask_id, V, True)[2]
    np.testing.assert_array_equal(again, _port_mask(ids, mask_id, V, True)[2])
    assert not np.array_equal(again,
                              _port_mask(ids, mask_id, V, True, step=1)[2])


# ------------------------------------------------------------ the step


@pytest.fixture(scope="module")
def mlm_setup(corpus_path):
    """(tokenizer, packed batch, JAX cfg, JAX params with the head): eight
    packed 128-token rows of the corpus and JAX-initialised bert-tiny."""
    texts = [t for t, _ in load_data(corpus_path)]
    tok = tokenizer.WordPieceTokenizer(tokenizer.build_vocab(texts))
    packed = packing.pack_texts(tok, texts, 128)
    batch = {k: v[:8] for k, v in packed.items()}
    jcfg = jax_get_config("bert-tiny", vocab_size=tok.vocab_size).replace(
        dropout=0.0, attn_dropout=0.0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = jbert.init_params(k1, jcfg)
    params["mlm"] = jbert.init_mlm_head(k2, jcfg)
    return tok, batch, jcfg, jax.tree_util.tree_map(np.asarray, params)


def _load_pretrain_state(state, params):
    sd = convert.from_jax_params(params)
    sd.update({f"mlm.{k}": v for k, v in
               convert.head_from_jax(params["mlm"]).items()})
    with torch.no_grad():
        state.model.load_state_dict(sd)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_mlm_step_at_jax_mask_matches_jax(mlm_setup, route):
    """JAX's step-0 mask (``k_mask`` from ``fold_in(rng, 0)``, split, then
    ``mask_tokens``, as ``build_mlm_step``'s step draws it) handed to the
    port's loss: the loss, ``mask_acc``, every gradient and every
    parameter after one AdamW update against JAX ``build_mlm_step``, fp32,
    from the same weights.
    ``pallas``: the flash twins' segment form in the port, the Pallas
    kernels in interpret mode in JAX; ``xla``: the plain paths."""
    tok, batch, jcfg, params = mlm_setup
    kw = dict(model="bert-tiny", dropout=0.0, attn_dropout=0.0,
              attention_impl=route, learning_rate=1e-3, mlm_span=True)
    jargs = JArgs(**kw)
    # JAX's gradients of the step: a first transform that passes them on
    # and keeps them as its state
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, joptim.build_optimizer(params, jargs))
    rng = jax.random.PRNGKey(7)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = {"params": jparams, "opt_state": tx.init(jparams),
              "step": jnp.zeros((), jnp.int32), "rng": rng}
    mask_id = tok.vocab["[MASK]"]
    jstep = jax.jit(jpre.build_mlm_step(jcfg, tx, jargs, mask_id))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate2, jm = jstep(jstate, jbatch)
    k_mask, _ = jax.random.split(jax.random.fold_in(rng, 0))
    masked = jpre.mask_tokens(k_mask, jbatch["input_ids"], mask_id,
                              jcfg.vocab_size, jargs.mlm_prob,
                              span=jargs.mlm_span)
    masked = tuple(torch.from_numpy(np.array(a)) for a in masked)
    assert float(masked[2].sum()) > 0

    args = Args(device="cpu", **kw)
    _, state = pretrain.setup_pretrain(args, tok.vocab_size)
    _load_pretrain_state(state, params)
    m = pretrain.mlm_update(state, {k: torch.from_numpy(v) for k, v in
                                    batch.items()}, masked, args)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= STEP_ATOL
    assert abs(float(m["mask_acc"]) - float(jm["mask_acc"])) <= STEP_ATOL
    sd = state.model.state_dict()
    got = convert.mlm_artifact_to_jax(
        sd, {k[4:]: v for k, v in sd.items() if k.startswith("mlm.")})
    want = jax.tree_util.tree_map(np.asarray, jpre._mlm_artifact(
        jstate2["params"]))
    leaves_g = jax.tree_util.tree_leaves_with_path(got)
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in leaves_g] == [p for p, _ in leaves_w]
    for (path, g), (_, w) in zip(leaves_g, leaves_w):
        np.testing.assert_allclose(g, w, atol=STEP_ATOL, err_msg=str(path))
    # the gradients before the update (one AdamW step moves each weight by
    # about lr whatever its gradient's size): each leaf within STEP_ATOL of
    # its largest gradient, taken as at least 1e-3 of the model's largest
    # (the key bias's gradient is rounding alone: a softmax does not see a
    # shift of a query's scores)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    got = convert.mlm_artifact_to_jax(
        grads, {k[4:]: v for k, v in grads.items() if k.startswith("mlm.")})
    want = jax.tree_util.tree_map(np.asarray, jpre._mlm_artifact(
        jstate2["opt_state"][0]))
    leaves_g = jax.tree_util.tree_leaves_with_path(got)
    leaves_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in leaves_g] == [p for p, _ in leaves_w]
    top = max(np.abs(w).max() for _, w in leaves_w)
    for (path, g), (_, w) in zip(leaves_g, leaves_w):
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(
            g, w, rtol=0, atol=STEP_ATOL * max(np.abs(w).max(), 1e-3 * top),
            err_msg=str(path))
    assert state.step == 1


def test_decay_groups_and_schedule_match_jax(mlm_setup):
    """The pretraining optimizer's decay flag on every parameter, trunk and
    head, carried to the JAX tree, equals ``decay_mask`` over the tree with
    ``mlm`` in it; the tied word matrix is in the optimizer once.  The
    schedule equals ``optax.warmup_cosine_decay_schedule(0, lr,
    max(1, T * 6 // 100), T)`` at every update for several T, and the
    optimizer's rate follows it."""
    tok, _, _, params = mlm_setup
    args = Args(device="cpu", model="bert-tiny")
    _, state = pretrain.setup_pretrain(args, tok.vocab_size)
    decayed = {id(p) for p in state.optimizer.param_groups[0]["params"]}
    flags = {n: torch.tensor(id(p) in decayed)
             for n, p in state.model.named_parameters()}
    got = convert.to_jax_params(flags)
    got["mlm"] = convert.head_to_jax(
        {k[4:]: v for k, v in flags.items() if k.startswith("mlm.")})
    want = joptim.decay_mask(params)
    lg = jax.tree_util.tree_leaves_with_path(convert._sorted(got))
    lw = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, g), (_, w) in zip(lg, lw):
        assert np.all(np.asarray(g) == w), path
    in_opt = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert len(in_opt) == len({id(p) for p in in_opt}) == len(
        list(state.model.parameters()))
    assert not any(p is not state.model.embeddings.word and
                   p.shape == state.model.embeddings.word.shape
                   for p in in_opt)
    lr = 2e-4
    for T in (2, 17, 50, 400):
        mine = optim.pretrain_schedule(lr, T)
        ref = optax.warmup_cosine_decay_schedule(0.0, lr, max(1, T * 6 // 100),
                                                 T)
        for c in range(T + 3):   # optax evaluates in fp32
            np.testing.assert_allclose(mine(c), float(ref(c)), rtol=1e-6,
                                       atol=1e-6 * lr, err_msg=f"T {T} c {c}")
    with pytest.raises(ValueError, match="warmup"):
        optim.pretrain_schedule(lr, 1)
    model = torch.nn.Linear(2, 2)
    opt, sched = optim.build_optimizer(model, Args(learning_rate=lr),
                                       schedule=optim.pretrain_schedule(lr,
                                                                        17))
    for c in range(4):
        assert opt.param_groups[0]["lr"] == pytest.approx(
            optim.pretrain_schedule(lr, 17)(c), rel=1e-9)
        opt.step()
        sched.step()


# ----------------------------------------------------- end to end runs


@pytest.fixture(scope="module")
def port_run(work):
    """The port's bert-tiny pretraining run: (args, artifact path, the
    printed lines)."""
    import contextlib
    import io

    d, common = work
    args = Args(device="cpu", strategy="pretrain", train_batch_size=8,
                epochs=3, learning_rate=1e-3, pretrain_limit=300,
                output_dir=str(d / "port"), **common)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = pretrain.run_pretrain(args)
    return args, path, out.getvalue().splitlines()


@pytest.fixture(scope="module")
def jax_run(work):
    """JAX's run of the same configuration (batch 8 over the 8 virtual
    devices)."""
    import contextlib
    import io

    d, common = work
    jargs = JArgs(strategy="pretrain", train_batch_size=8, epochs=3,
                  learning_rate=1e-3, pretrain_limit=300,
                  output_dir=str(d / "jax"), **common)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        path = jpre.run_pretrain(jargs)
    return jargs, path, out.getvalue().splitlines()


def _losses(lines):
    return [float(x) for ln in lines for x in re.findall(
        r"^\[pretrain\] epoch \d+/\d+ loss ([0-9.]+) mask_acc [0-9.]+$", ln)]


def _zero_gang(rank, world, args, payload):
    """Rank ``rank`` of a zero placement warm-started from the artifact:
    the consolidated encoder, on rank 0."""
    from pdnlp_tpu_torch.parallel.execution import setup_sharded_model
    from pdnlp_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device_type="cpu")
    _, state = setup_sharded_model(args, payload["vocab_size"], mesh, "zero")
    full = ckpt.consolidate(state.model)
    sharded = ckpt.is_sharded(state.model)
    # numpy, not tensors: a tensor crosses the result queue as a shared-
    # memory handle that dies with the rank's process
    return {k: v.numpy().copy() for k, v in full.items()} if rank == 0 \
        else sharded


def test_pretrain_then_finetune_warmstart(work, port_run):
    """The port's pretraining learns (the printed loss falls) and writes
    the artifact; ``setup_model`` and ``setup_sharded_model`` (dp at world
    1, zero in a 2-rank gang) with ``init_from`` hold the file's encoder
    exactly and no ``mlm`` parameter; the EMA starts from it; a missing
    tree and a shape mismatch raise."""
    from pdnlp_tpu_torch.parallel import local
    from pdnlp_tpu_torch.parallel.execution import setup_sharded_model
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.parallel.runtime import init_runtime

    d, common = work
    args, path, lines = port_run
    losses = _losses(lines)
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    assert os.path.exists(path) and ckpt.verify(path)[0]
    vocab_size = len(tokenizer.load_vocab(args.vocab_path))
    ft = Args(device="cpu", init_from=path, ema_decay=0.5, **common)
    _, state = setup_model(ft, vocab_size)
    trunk, _head = convert.mlm_artifact_from_jax(ckpt.load(path))
    sd = state.model.state_dict()
    assert not any(k.startswith("mlm") for k in sd)
    for k, v in trunk.items():
        assert torch.equal(sd[k], v), k
        assert torch.equal(state.ema[k], v), k
    fresh = setup_model(ft.replace(init_from=None), vocab_size)[1]
    assert torch.equal(sd["classifier.weight"],
                       fresh.model.state_dict()["classifier.weight"])
    init_runtime(ft)
    _, dp = setup_sharded_model(ft.replace(ema_decay=0.0), vocab_size,
                                make_mesh(device_type="cpu"), "dp")
    for k, v in trunk.items():
        assert torch.equal(dp.model.state_dict()[k], v), k
    full, sharded = local.run_gang(
        _zero_gang, 2, ft.replace(ema_decay=0.0, dist_backend="gloo"),
        {"vocab_size": vocab_size}, timeout=GANG_TIMEOUT)
    assert sharded is True
    for k, v in trunk.items():
        assert np.array_equal(full[k], v.numpy()), k
    small = sd["embeddings.word"][:-1]
    with pytest.raises(ValueError, match="shapes do not match"):
        pretrain.load_encoder(path, {**sd, "embeddings.word": small})
    bare = str(d / "bare.msgpack")
    ckpt.save(bare, {"embeddings": ckpt.load(path)["embeddings"]})
    with pytest.raises(ValueError, match="no 'layers' tree"):
        pretrain.load_encoder(bare, sd)


def test_artifacts_interoperate_with_jax(work, port_run, jax_run):
    """JAX's artifact loads in the port as JAX's ``load_encoder`` loads
    it; the port writes the bytes JAX's ``save_params`` writes for the
    same weights; the port's artifact loads in JAX's ``load_encoder``."""
    d, common = work
    jargs, jpath, _ = jax_run
    vocab_size = len(tokenizer.load_vocab(jargs.vocab_path))
    jcfg = jax_get_config("bert-tiny", vocab_size=vocab_size)
    jtmpl = jbert.init_params(jax.random.PRNGKey(3), jcfg)
    jwant = jax.tree_util.tree_map(np.asarray,
                                   jpre.load_encoder(jpath, jtmpl))
    _, state = setup_model(Args(device="cpu", init_from=jpath, **common),
                           vocab_size)
    got = convert.to_jax_params(state.model.state_dict())
    for key in ("embeddings", "layers"):
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got[key]),
                jax.tree_util.tree_leaves_with_path(jwant[key])):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
    # the same weights through the port's writer: JAX's bytes
    _, pstate = pretrain.setup_pretrain(Args(device="cpu", **common),
                                        vocab_size)
    trunk, head = convert.mlm_artifact_from_jax(ckpt.load(jpath))
    sd = pstate.model.state_dict()
    sd.update(trunk)
    sd.update({f"mlm.{k}": v for k, v in head.items()})
    with torch.no_grad():
        pstate.model.load_state_dict(sd)
    mine = str(d / "port-of-jax.msgpack")
    ckpt.save(mine, pretrain.mlm_artifact(mine, pstate.model, "bert-tiny"))
    with open(mine, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    _, ppath, _ = port_run
    back = jpre.load_encoder(ppath, jtmpl)
    ptrunk, _ = convert.mlm_artifact_from_jax(ckpt.load(ppath))
    back_sd = convert.from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             back))
    for k, v in ptrunk.items():
        assert torch.equal(back_sd[k], v), k


def test_supervised_stage_trains_and_head_restores(work, port_run):
    """The supervised stage from the MLM artifact writes full params;
    ``--init_head`` restores its pooler and classifier bit for bit, a
    trunk-only load leaves the head fresh, ``head=True`` on the MLM
    artifact raises naming ``init_head``, and ``dev=True`` is refused."""
    d, common = work
    _, mlm_path, _ = port_run
    sft = Args(device="cpu", strategy="sft", train_batch_size=8, epochs=1,
               pretrain_limit=64, init_from=mlm_path,
               lr_schedule="warmup_linear", ckpt_name="pretrained.msgpack",
               output_dir=str(d / "sft"), **common)
    sft_path = pretrain.run_supervised_stage(sft)
    saved = convert.from_jax_params(ckpt.load(sft_path))
    vocab_size = len(tokenizer.load_vocab(sft.vocab_path))
    ft = Args(device="cpu", init_from=sft_path, init_head=True, **common)
    got = setup_model(ft, vocab_size)[1].model.state_dict()
    for k in ("pooler.weight", "pooler.bias", "classifier.weight",
              "classifier.bias", "embeddings.word", "layers.1.up.weight"):
        assert torch.equal(got[k], saved[k]), k
    trunk = setup_model(ft.replace(init_head=False),
                        vocab_size)[1].model.state_dict()
    assert torch.equal(trunk["embeddings.word"], saved["embeddings.word"])
    assert not torch.equal(trunk["classifier.weight"],
                           saved["classifier.weight"])
    with pytest.raises(ValueError, match="init_head"):
        pretrain.load_encoder(mlm_path, got, head=True)
    with pytest.raises(ValueError, match="dev=False"):
        pretrain.run_supervised_stage(sft.replace(dev=True))


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "pretrain_tpu_script", os.path.join(REPO, "pretrain-tpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_point_refusals_and_lines_match_jax(work, port_run, jax_run,
                                                  monkeypatch, capsys):
    """``python -m pdnlp_tpu_torch.train.pretrain``'s three refusals carry
    ``pretrain-tpu.py``'s messages byte for byte; both packages' runs print
    the same corpus and run lines and the ``[pretrain]`` / ``pretrain
    耗时`` lines in JAX's formats; the two-phase entry point runs end to
    end on the CPU."""
    d, common = work
    jmain = _jax_entry().main
    out = str(d / "refuse")
    cases = (
        ["--init_from", "x.msgpack", "--sft_epochs", "0"],
        ["--init_from", os.path.join(out, "pretrained.msgpack")],
        ["--ckpt_name", "pretrained-mlm.msgpack"],
    )
    for argv in cases:
        argv = argv + ["--output_dir", out]
        with pytest.raises(SystemExit) as got:
            pretrain.main(argv + ["--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["pretrain-tpu.py"] + argv)
        with pytest.raises(SystemExit) as want:
            jmain()
        assert str(got.value) == str(want.value)
    _, _, plines = port_run
    _, _, jlines = jax_run
    for prefix in ("pretrain corpus: ", "pretraining "):
        assert [ln for ln in plines if ln.startswith(prefix)] == \
            [ln for ln in jlines if ln.startswith(prefix)]
    for lines in (plines, jlines):
        assert len(_losses(lines)) == 3
        took = [ln for ln in lines if ln.startswith("pretrain 耗时")]
        assert len(took) == 1 and re.fullmatch(
            r"pretrain 耗时：\d+\.\d{4}分钟", took[0])
    if not torch.cuda.is_available():     # cuda by default, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pretrain.main(["--model", "bert-tiny", "--output_dir", out,
                           "--data_path", common["data_path"],
                           "--vocab_path", common["vocab_path"],
                           "--sft_epochs", "0"])
    run = str(d / "entry")
    pretrain.main(["--device", "cpu", "--model", "bert-tiny",
                   "--data_path", common["data_path"],
                   "--vocab_path", common["vocab_path"],
                   "--output_dir", run, "--max_seq_len", "32",
                   "--data_limit", "300", "--pretrain_limit", "64",
                   "--train_batch_size", "8", "--epochs", "1",
                   "--sft_epochs", "1", "--attn_dropout", "0"])
    lines = capsys.readouterr().out.splitlines()
    assert os.path.exists(os.path.join(run, "pretrained-mlm.msgpack"))
    assert os.path.exists(os.path.join(run, "pretrained.msgpack"))
    assert any(ln.startswith("supervised stage: 64 labeled externals")
               for ln in lines)
