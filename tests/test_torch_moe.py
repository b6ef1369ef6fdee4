"""The PyTorch port's mixture-of-experts model against the JAX package's
(``pdnlp_tpu/models/bert.py`` ``moe_mlp``, ``tests/test_moe.py``), on the
CPU with ``bert-tiny-moe`` (2 layers, width 128, 4 experts of 512) and the
JAX weights carried over by ``models.convert``:

- shapes, the forward and the aux against ``classify(return_aux=True)``,
  both dispatches, padded and packed rows (fp32 logits 2e-5);
- top-k = E is the softmax mixture; grouped = dense at capacity >= T
  (2e-5, ``tests/test_moe.py:102``), and each capacity case (1.25, the
  squeezed 0.25, padding) against JAX's own ``moe_mlp``;
- ties: a zero gate picks experts 0 and 1, as ``jax.lax.top_k`` does;
- one train step's gradients (each leaf within 5e-5 of its largest) and
  params against JAX's ``build_train_step``; the reported loss is bare CE;
- upcycling bit for bit with JAX's ``upcycle_layers`` on the same seed;
- msgpack checkpoints both ways; int8 expert stacks byte for byte with
  JAX's ``quantize_params`` and served against JAX's int8 forward;
- the guards with JAX's messages, and MoE on the explicit-collectives
  path;
- one masked-LM step with the aux: its gradients (each leaf within 5e-5 of
  its largest) and params against JAX's ``build_mlm_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.serve import quant as jquant
from pdnlp_tpu.train import optim as joptim
from pdnlp_tpu.train import steps as jsteps
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.models.bert import (
    BertClassifier, grouped_slots, moe_mlp, quantize_linears, route,
    top_k_lowest,
)
from pdnlp_tpu_torch.models.config import get_config
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train import steps
from pdnlp_tpu_torch.train.setup import setup_model
from pdnlp_tpu_torch.utils.config import Args

SEQ = 16
VOCAB = 100
#: logits and expert outputs, fp32 (``tests/test_moe.py``'s dispatch bound)
ATOL = 2e-5
#: one train step's gradients: each leaf within this of its largest
GRAD_RTOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs
    several workers on the machine's cores at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def fake_batch(n, seed=0, pad=True):
    r = np.random.RandomState(seed)
    mask = np.ones((n, SEQ), np.int32)
    if pad:
        for b in range(n):
            mask[b, r.randint(SEQ // 4, SEQ + 1):] = 0
    return {
        "input_ids": (r.randint(5, VOCAB, (n, SEQ)) * mask).astype(np.int32),
        "token_type_ids": np.zeros((n, SEQ), np.int32),
        "attention_mask": mask,
        "label": r.randint(0, 6, (n,)).astype(np.int32),
        "example_weight": np.ones((n,), np.float32),
    }


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def moe():
    """(JAX config, JAX params as numpy): JAX-initialised bert-tiny-moe."""
    jcfg = jax_get_config("bert-tiny-moe", vocab_size=VOCAB)
    return jcfg, _host(jbert.init_params(jax.random.key(0), jcfg))


def port_model(params, **over):
    model = BertClassifier(get_config("bert-tiny-moe", vocab_size=VOCAB,
                                      **over)).eval()
    model.load_state_dict(convert.from_jax_params(params))
    return model


def layer0(params):
    return jax.tree_util.tree_map(lambda a: a[0], params["layers"])


def test_moe_params_and_forward_shapes(moe):
    jcfg, params = moe
    model = port_model(params)
    E, H, I = 4, 128, 512
    lay = model.layers[0]
    assert lay.up.kernel.shape == (E, H, I)
    assert lay.up.bias.shape == (E, I)
    assert lay.down.kernel.shape == (E, I, H)
    assert lay.gate.kernel.shape == (H, E)
    with torch.no_grad():
        logits, aux = model.classify(_t(fake_batch(4)), return_aux=True)
    assert logits.shape == (4, 6) and torch.isfinite(logits).all()
    # Switch aux: >= 1 per layer by Cauchy-Schwarz, summed over the layers
    assert float(aux) >= jcfg.num_layers * 0.99


@pytest.mark.parametrize("dispatch", ["grouped", "dense"])
@pytest.mark.parametrize("packed", [False, True])
def test_forward_and_aux_match_jax(moe, dispatch, packed):
    """``classify(return_aux=True)`` in fp32: logits within 2e-5 and the
    aux within 1e-6 relative of JAX's, on padded rows and on packed rows
    (the segment mask on the kernel's twin, per-segment logits)."""
    jcfg, params = moe
    jcfg = jcfg.replace(moe_dispatch=dispatch)
    model = port_model(params, moe_dispatch=dispatch)
    if packed:
        from pdnlp_tpu_torch.data.packing import pack_id_lists

        r = np.random.RandomState(5)
        ids = [[2] + list(r.randint(5, VOCAB, r.randint(3, 12))) + [3]
               for _ in range(10)]
        batch, _ = pack_id_lists(ids, 32, 4, 4)
        impl = "pallas"
    else:
        batch = fake_batch(4, seed=1)
        impl = "xla"
    jb = {k: v for k, v in batch.items() if k not in ("label",
                                                      "example_weight")}
    want, jaux = jbert.classify(jax.tree_util.tree_map(jnp.asarray, params),
                                jcfg, {k: jnp.asarray(v) for k, v in
                                       jb.items()}, return_aux=True)
    with torch.no_grad():
        got, aux = model.classify(_t(jb), attn_impl=impl, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


def test_moe_gating_is_topk_convex_combination(moe):
    """top-k = E is the full-softmax mixture (``tests/test_moe.py:60``)."""
    jcfg, params = moe
    model = port_model(params, moe_top_k=4, moe_dispatch="dense")
    lay = model.layers[0]
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (2, SEQ, 128)).astype(np.float32))
    with torch.no_grad():
        out, _ = moe_mlp(x, lay, model.cfg)
        probs = torch.softmax(x @ lay.gate.kernel, -1)
        h = torch.einsum("bsh,ehi->ebsi", x, lay.up.kernel) \
            + lay.up.bias[:, None, None, :]
        y = torch.einsum("ebsi,eih->ebsh", torch.nn.functional.gelu(h),
                         lay.down.kernel) + lay.down.bias[:, None, None, :]
        manual = torch.einsum("ebsh,bse->bsh", y, probs)
    np.testing.assert_allclose(out.numpy(), manual.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cf,masked", [(4.0, False), (1.25, False),
                                       (0.25, False), (1.25, True)])
def test_grouped_dispatch_matches_dense_and_jax(moe, cf, masked):
    """Grouped at capacity >= T equals dense (2e-5) with the same aux; at
    1.25, squeezed at 0.25, and with padding (which never takes a slot and
    gets zero output) it equals JAX's grouped ``moe_mlp`` (2e-5)."""
    jcfg, params = moe
    lp = layer0(params)
    x = np.random.RandomState(1).standard_normal(
        (4, SEQ, 128)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((4, SEQ), np.int32)
        mask[:, SEQ // 2:] = 0
    gcfg = jcfg.replace(moe_dispatch="grouped", moe_capacity_factor=cf)
    want, jaux = jbert.moe_mlp(jnp.asarray(x), lp, gcfg,
                               mask=None if mask is None
                               else jnp.asarray(mask))
    model = port_model(params, moe_dispatch="grouped",
                       moe_capacity_factor=cf)
    lay = model.layers[0]
    tm = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        got, aux = moe_mlp(torch.from_numpy(x), lay, model.cfg, tm)
        _, idx, _ = route(lay.gate(torch.from_numpy(x)), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    slots = grouped_slots(idx, tm, 4, cf)
    dropped = int((slots.routed & ~slots.kept).sum())
    if cf == 4.0:
        assert dropped == 0
        dense = port_model(params, moe_dispatch="dense")
        with torch.no_grad():
            d_out, d_aux = moe_mlp(torch.from_numpy(x), dense.layers[0],
                                   dense.cfg)
        np.testing.assert_allclose(got.numpy(), d_out.numpy(), rtol=ATOL,
                                   atol=ATOL)
        assert float(aux) == pytest.approx(float(d_aux), rel=1e-6)
    if cf == 0.25:
        assert dropped > 0
        assert np.isfinite(got.numpy()).all()
    if masked:
        assert np.abs(got.numpy()[:, SEQ // 2:]).max() == 0.0
        assert int(slots.routed.sum()) == 4 * (SEQ // 2) * 2


def test_top_k_ties_go_to_the_lower_index(moe):
    """A zero gate makes every probability equal: every token picks
    experts 0 and 1 (``jax.lax.top_k``'s order), each at weight 1/2."""
    _, params = moe
    model = port_model(params)
    lay = model.layers[0]
    with torch.no_grad():
        lay.gate.kernel.zero_()
    probs = torch.full((3, 5, 4), 0.25)
    _, idx = top_k_lowest(probs, 2)
    assert (idx[..., 0] == 0).all() and (idx[..., 1] == 1).all()
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    x = torch.randn(2, SEQ, 128, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out, aux = moe_mlp(x, lay, model.cfg.replace(moe_capacity_factor=4.0))
        manual = 0
        for e in (0, 1):
            h = torch.nn.functional.gelu(x @ lay.up.kernel[e]
                                         + lay.up.bias[e])
            manual = manual + 0.5 * (h @ lay.down.kernel[e]
                                     + lay.down.bias[e])
    np.testing.assert_allclose(out.numpy(), manual.numpy(), atol=ATOL)
    # every token on expert 0 first: token_frac (1, 0, 0, 0), prob_frac 1/4
    assert float(aux) == pytest.approx(1.0)


@pytest.fixture(scope="module")
def jax_step(moe):
    """JAX's first train step from ``moe``'s weights (dropout 0, lr 1e-3):
    (batch, metrics, params after, gradients)."""
    jcfg, params = moe
    jcfg = jcfg.replace(dropout=0.0, attn_dropout=0.0)
    kw = dict(model="bert-tiny-moe", dropout=0.0, attn_dropout=0.0,
              attention_impl="xla", fused_ce="xla", learning_rate=1e-3)
    jargs = JArgs(**kw)
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, joptim.build_optimizer(params, jargs))
    jstate = jsteps.init_state(jax.random.key(0), jcfg, tx,
                               rng=jax.random.key(1),
                               params=jax.tree_util.tree_map(jnp.asarray,
                                                             params))
    batch = fake_batch(8, seed=2)
    jstate, jm = jax.jit(jsteps.build_train_step(jcfg, tx, jargs))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return (kw, batch, jm, _host(jstate["params"]),
            _host(jstate["opt_state"][0]))


def _leaves_close(got, want, rtol=None, atol=None):
    lg = jax.tree_util.tree_leaves_with_path(got)
    lw = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    top = max(np.abs(w).max() for _, w in lw)
    for (path, g), (_, w) in zip(lg, lw):
        assert np.isfinite(g).all(), path
        tol = atol if atol is not None else \
            rtol * max(np.abs(w).max(), 1e-3 * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_train_step_gradients_match_jax(moe, jax_step, route):
    """One fp32 step (CE + 0.01 aux) from JAX's weights: the bare-CE loss
    within 1e-5, every gradient before the update within 5e-5 of its
    leaf's largest, the params after AdamW within 2e-6.  ``pallas``: the
    flash and fused-CE kernels' twins in the port."""
    _, params = moe
    kw, batch, jm, jparams, jgrads = jax_step
    args = Args(device="cpu", **{**kw, "attention_impl": route,
                                 "fused_ce": route})
    _, state = setup_model(args, VOCAB)
    state.model.load_state_dict(convert.from_jax_params(params))
    m = steps.build_train_step(args, torch.device("cpu"))(state, _t(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    _leaves_close(convert.to_jax_params(grads), jgrads, rtol=GRAD_RTOL)
    _leaves_close(convert.to_jax_params(state.model.state_dict()), jparams,
                  atol=2e-6)


def test_moe_trains_and_reports_bare_ce(moe):
    """A few steps: the loss falls, and the reported loss is the bare
    weighted CE of the pre-update weights, not CE + coef * aux
    (``tests/test_moe.py:129``)."""
    args = Args(device="cpu", model="bert-tiny-moe", dropout=0.0,
                attn_dropout=0.0, learning_rate=1e-3)
    _, state = setup_model(args, VOCAB)
    batch = _t(fake_batch(16, seed=3))
    with torch.no_grad():
        logits, aux = state.model.classify(batch, return_aux=True)
    bare, _, _ = steps.weighted_ce(logits, batch["label"],
                                   batch["example_weight"])
    step = steps.build_train_step(args, torch.device("cpu"))
    losses = [float(step(state, batch)["loss"]) for _ in range(6)]
    assert losses[-1] < losses[0]
    assert losses[0] == pytest.approx(float(bare), rel=1e-5)
    assert abs(losses[0] - float(bare + 0.01 * aux)) > 1e-4


def _jax_guard(args, mesh_shape, mode):
    from pdnlp_tpu.parallel import make_mesh, setup_sharded_model

    with pytest.raises(ValueError) as e:
        setup_sharded_model(args, VOCAB, make_mesh(shape=mesh_shape), mode)
    return str(e.value)


@pytest.mark.parametrize("model,shape,mode", [
    ("bert-tiny-moe", {"data": 4, "model": 2}, "tp"),
    ("bert-tiny", {"data": 4, "expert": 2}, "ep"),
    ("bert-tiny-moe", {"data": 1, "expert": 8}, "ep"),
    ("bert-tiny", {"data": 2, "model": 4}, "tp")])
def test_guards_match_jax(model, shape, mode):
    """tp with MoE, ep on a dense model, an ep degree that does not divide
    the experts and a tp degree that does not divide the heads: the port
    refuses with JAX's messages (``tests/test_moe.py:186``)."""
    from pdnlp_tpu_torch.parallel.sharding import check_model

    want = _jax_guard(JArgs(model=model, max_seq_len=SEQ), shape, mode)
    with pytest.raises(ValueError) as e:
        check_model(get_config(model, vocab_size=VOCAB), mode, shape, model)
    assert str(e.value) == want


def test_upcycle_matches_jax_bit_for_bit(tmp_path):
    """A dense checkpoint loaded into an MoE model: every expert kernel
    equals JAX's ``upcycle_layers`` on the same dense params and seed (its
    template in sorted key order, as a jitted state holds it), biases copy,
    the gate stays the template's, the rest copies bit for bit; both file
    formats load the same (``tests/test_moe.py:203``)."""
    from pdnlp_tpu.train import pretrain as jpre
    from pdnlp_tpu_torch.train import pretrain

    dcfg = jax_get_config("bert-tiny", vocab_size=VOCAB)
    dense = _host(jbert.init_params(jax.random.key(7), dcfg))
    mcfg = jax_get_config("bert-tiny-moe", vocab_size=VOCAB)
    tmpl = _host(jbert.init_params(jax.random.key(8), mcfg))
    tmpl_sorted = {k: tmpl["layers"][k] for k in sorted(tmpl["layers"])}
    want = _host(jpre.upcycle_layers(dense["layers"], tmpl_sorted))
    model = port_model(tmpl)
    template = model.state_dict()
    paths = {"msgpack": str(tmp_path / "dense.msgpack"),
             "pt": str(tmp_path / "dense.pt")}
    ckpt.save(paths["msgpack"], dense)
    ckpt.save_params(paths["pt"], convert.from_jax_params(dense),
                     model_name="bert-tiny", vocab_size=VOCAB)
    for fmt, path in paths.items():
        got = pretrain.load_encoder(path, template, head=True)
        tree = convert.to_jax_params(got)
        for sub in ("up", "down"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(
                    tree["layers"][sub][leaf], want[sub][leaf],
                    err_msg=f"{fmt} {sub}.{leaf}")
        np.testing.assert_array_equal(tree["layers"]["gate"]["kernel"],
                                      tmpl["layers"]["gate"]["kernel"])
        for name in ("q", "o", "attn_ln"):
            for leaf in want[name]:
                np.testing.assert_array_equal(tree["layers"][name][leaf],
                                              dense["layers"][name][leaf])
        np.testing.assert_array_equal(tree["pooler"]["kernel"],
                                      dense["pooler"]["kernel"])
        up = tree["layers"]["up"]["kernel"]
        assert np.abs(up[:, 0] - up[:, 1]).max() > 0   # symmetry broken


def test_msgpack_checkpoints_cross_both_ways(moe, tmp_path):
    """JAX's ``save_params`` bytes load into the port's MoE model, and the
    port's ``.msgpack`` of those weights is the same bytes."""
    from pdnlp_tpu.train import checkpoint as jckpt

    _, params = moe
    jpath = str(tmp_path / "jax.msgpack")
    jckpt.save(jpath, params)
    model = port_model(params)
    sd = ckpt.load_params(jpath, model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    ppath = str(tmp_path / "port.msgpack")
    ckpt.save_params(ppath, model.state_dict(), model_name="bert-tiny-moe",
                     vocab_size=VOCAB)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()


def test_int8_experts_match_jax_quantize_params(moe, tmp_path):
    """The int8 expert stacks (per expert, per output channel) and every
    other quantized block equal JAX's ``quantize_params`` byte for byte
    (the gate stays fp32); the int8 forward equals JAX's int8 forward; the
    JAX int8 artifact loads into a quantized port model."""
    from pdnlp_tpu.train import checkpoint as jckpt
    from pdnlp_tpu_torch.serve.quant import quantize_state

    jcfg, params = moe
    jq = _host(jquant.quantize_params(params))
    model = port_model(params)
    q = convert.to_jax_params(quantize_state(model.state_dict()))
    lq = jax.tree_util.tree_leaves_with_path(q)
    lw = jax.tree_util.tree_leaves_with_path(jq)
    assert [p for p, _ in lq] == [p for p, _ in lw]
    for (path, g), (_, w) in zip(lq, lw):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    assert jq["layers"]["up"]["qscale"].shape == (2, 4, 512)
    assert "qscale" not in jq["layers"]["gate"]
    quantize_linears(model)
    path = str(tmp_path / "jax.int8.msgpack")
    jckpt.save(path, jq)
    model.load_state_dict(ckpt.load_params(path, model.state_dict()))
    batch = fake_batch(4, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jbert.classify(jax.tree_util.tree_map(jnp.asarray, jq), jcfg, jb)
    with torch.no_grad():
        got = model.classify(_t(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_moe_on_the_explicit_collectives_path(corpus_path, tmp_path):
    """MoE trains on the explicit-collectives step: with the dense
    dispatch its first reported loss equals the dp step's bare CE, and
    further steps on the same rows bring it down (``tests/test_moe.py
    :247``)."""
    from pdnlp_tpu_torch.train.run import build_parallel_trainer

    args = Args(device="cpu", model="bert-tiny-moe", data_path=corpus_path,
                vocab_path=str(tmp_path / "v.txt"), data_limit=100,
                max_seq_len=SEQ, train_batch_size=4, dropout=0.0,
                attn_dropout=0.0, moe_dispatch="dense", log_every=10 ** 9,
                learning_rate=1e-3, prefetch=0)
    tr_sm, loader, _ = build_parallel_trainer(args, mode="dp",
                                              explicit_collectives=True)
    tr_dp, _, _ = build_parallel_trainer(args, mode="dp")
    loader.set_epoch(0)
    first = next(iter(loader))
    m_sm = tr_sm.train_step(tr_sm.state, tr_sm.put(first))
    m_dp = tr_dp.train_step(tr_dp.state, tr_dp.put(first))
    assert float(m_sm["loss"]) == pytest.approx(float(m_dp["loss"]),
                                                rel=1e-5)
    losses = [float(m_sm["loss"])] + [
        float(tr_sm.train_step(tr_sm.state, tr_sm.put(first))["loss"])
        for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("serve_dtype", ["auto", "int8"])
def test_engine_serves_moe_like_jax(tmp_path, serve_dtype):
    """``InferenceEngine`` serves a JAX bert-tiny-moe checkpoint as JAX's
    engine does: fp32 logits within 2e-5; int8 (expert stacks quantized
    per expert and output channel, bf16 activations) within the bf16 band
    of ``tests/test_torch_serve_quant.py`` and the same argmax; JAX's
    int8 artifact serves the same bits as quantizing on the fly."""
    from pdnlp_tpu.data.tokenizer import WordPieceTokenizer as JaxTok
    from pdnlp_tpu.serve import InferenceEngine as JaxEngine
    from pdnlp_tpu.train import checkpoint as jckpt
    from pdnlp_tpu.utils.config import Args as JaxArgs
    from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer, build_vocab
    from pdnlp_tpu_torch.serve import InferenceEngine

    vocab = build_vocab(["".join(chr(0x4e00 + i) for i in range(j, j + 9))
                         for j in range(40)], size=64)
    jcfg = jax_get_config("bert-tiny-moe", vocab_size=len(vocab))
    tree = _host(jbert.init_params(jax.random.key(3), jcfg))
    path = str(tmp_path / "moe-cls.msgpack")
    jckpt.save(path, tree)
    jeng = JaxEngine(JaxArgs(model="bert-tiny-moe", serve_dtype=serve_dtype),
                     tokenizer=JaxTok(vocab), mesh=None)
    jeng.load_checkpoint(path)
    eng = InferenceEngine(Args(model="bert-tiny-moe", device="cpu",
                               serve_dtype=serve_dtype),
                          tokenizer=WordPieceTokenizer(vocab))
    eng.load_checkpoint(path)
    r = np.random.RandomState(0)
    ids = [[2] + list(r.randint(5, len(vocab), r.randint(3, 30))) + [3]
           for _ in range(16)]
    want, got = jeng.infer_ids(ids, 32), eng.infer_ids(ids, 32)
    if serve_dtype == "auto":
        np.testing.assert_allclose(got, want, atol=ATOL)
        return
    assert isinstance(eng.model.layers[0].up.kernel, torch.Tensor)
    assert eng.model.layers[0].up.kernel.dtype == torch.int8
    assert eng.model.layers[0].gate.kernel.dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=0.1, atol=0.15)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    qpath = str(tmp_path / "moe-cls.int8.msgpack")
    jckpt.save(qpath, jquant.quantize_params(tree))
    art = InferenceEngine(Args(model="bert-tiny-moe", device="cpu",
                               serve_dtype="int8"),
                          tokenizer=WordPieceTokenizer(vocab))
    art.load_checkpoint(qpath)
    np.testing.assert_array_equal(art.infer_ids(ids, 32), got)


def test_mlm_step_with_aux_matches_jax():
    """One masked-LM step of bert-tiny-moe on packed rows at JAX's step-0
    mask: the bare-CE loss within 5e-5, every fp32 gradient before the
    update (of CE + 0.01 aux, JAX ``train/pretrain.py:128``) within 5e-5 of
    its leaf's largest, and every param after the update within 5e-5."""
    from pdnlp_tpu.train import pretrain as jpre
    from pdnlp_tpu_torch.data import packing, tokenizer
    from pdnlp_tpu_torch.train import pretrain

    r = np.random.RandomState(0)
    chars = [chr(0x4e00 + i) for i in range(60)]
    texts = ["".join(r.choice(chars, r.randint(4, 20))) for _ in range(40)]
    tok = tokenizer.WordPieceTokenizer(tokenizer.build_vocab(texts))
    batch = {k: v[:4] for k, v in packing.pack_texts(tok, texts, 64).items()}
    jcfg = jax_get_config("bert-tiny-moe", vocab_size=tok.vocab_size).replace(
        dropout=0.0, attn_dropout=0.0)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    params = jbert.init_params(k1, jcfg)
    params["mlm"] = jbert.init_mlm_head(k2, jcfg)
    params = _host(params)
    kw = dict(model="bert-tiny-moe", dropout=0.0, attn_dropout=0.0,
              attention_impl="xla", learning_rate=1e-3)
    jargs = JArgs(**kw)
    # JAX's gradients of the step: a first transform that passes them on
    # and keeps them as its state
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    tx = optax.chain(keep, joptim.build_optimizer(params, jargs))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    rng = jax.random.PRNGKey(7)
    jstate = {"params": jp, "opt_state": tx.init(jp),
              "step": jnp.zeros((), jnp.int32), "rng": rng}
    mask_id = tok.vocab["[MASK]"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstate2, jm = jax.jit(jpre.build_mlm_step(jcfg, tx, jargs, mask_id))(
        jstate, jb)
    k_mask, _ = jax.random.split(jax.random.fold_in(rng, 0))
    masked = tuple(torch.from_numpy(np.array(a)) for a in jpre.mask_tokens(
        k_mask, jb["input_ids"], mask_id, jcfg.vocab_size, jargs.mlm_prob,
        span=jargs.mlm_span))
    args = Args(device="cpu", **kw)
    _, state = pretrain.setup_pretrain(args, tok.vocab_size)
    sd = convert.from_jax_params(params)
    sd.update({f"mlm.{k}": v for k, v in
               convert.head_from_jax(params["mlm"]).items()})
    state.model.load_state_dict(sd)
    m = pretrain.mlm_update(state, _t(batch), masked, args)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= GRAD_RTOL
    got = state.model.state_dict()
    got = convert.mlm_artifact_to_jax(
        got, {k[4:]: v for k, v in got.items() if k.startswith("mlm.")})
    want = _host(jpre._mlm_artifact(jstate2["params"]))
    _leaves_close(got, want, atol=GRAD_RTOL)
    # one AdamW step moves each weight by about lr whatever its gradient's
    # size: the gradients themselves show the aux term
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    got = convert.mlm_artifact_to_jax(
        grads, {k[4:]: v for k, v in grads.items() if k.startswith("mlm.")})
    want = _host(jpre._mlm_artifact(jstate2["opt_state"][0]))
    _leaves_close(got, want, rtol=GRAD_RTOL)
