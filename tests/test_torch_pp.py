"""Pipeline parallelism in the PyTorch port against the JAX package's
(``pdnlp_tpu/parallel/pp.py``; the twin of ``tests/test_parallel.py:180``):
gloo gangs of real ranks on the CPU (``parallel.local.run_gang``,
bert-tiny, 2 layers: one a stage) at ``{"stage": 2}`` and ``{"data": 2,
"stage": 2}``, from the same weights (the port's seeded init, carried to
JAX by ``models.convert``):

- the GPipe step against JAX's ``make_pp_train_step`` on the same mesh
  (loss rel 1e-5, consolidated params 2e-5; JAX's step takes S times the
  gradient, which its AdamW's ``eps`` is scaled to cancel: see
  :func:`jax_pp`) and against JAX's dp step (rel 1e-5, tighter than
  ``test_parallel.py:206``'s 1e-4), a ragged batch (filler rows weigh 0)
  included on the dp x pp mesh;
- the eval step's metric contract; MoE on pp (``bert-tiny-moe``) against
  JAX's pp with MoE;
- each stage holds only its layers and the replicated trees, which stay
  bit-equal across the stages;
- the consolidated checkpoint loads in ``serve.cli``'s engine and gives
  JAX's logits; a resume snapshot reloads into fresh stages bit for bit.

The stages run the flash kernels' twins (``attention_impl pallas``), as
the card runs K1-K3.  Dropout is 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.parallel import (
    make_global_batch, make_mesh as jax_make_mesh, make_parallel_train_step,
    setup_sharded_model,
)
from pdnlp_tpu.parallel.pp import (
    make_pp_batch, make_pp_train_step, pp_shardings, setup_pp_model,
)
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.parallel import local
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train import setup
from pdnlp_tpu_torch.utils.config import Args
from tests.test_torch_sp import _Started

SEQ = 16
VOCAB = 100
LR = 1e-3
GANG_TIMEOUT = 300
KERNELS = dict(attention_impl="pallas")


def tiny_args(**kw):
    base = dict(model="bert-tiny", max_seq_len=SEQ, train_batch_size=4,
                dropout=0.0, attn_dropout=0.0, learning_rate=LR)
    base.update(kw)
    return base


def fake_batch(n, seed=0):
    r = np.random.RandomState(seed)
    mask = np.ones((n, SEQ), np.int32)
    for b in range(n):
        mask[b, r.randint(SEQ // 2, SEQ + 1):] = 0
    return {
        "input_ids": (r.randint(5, VOCAB, (n, SEQ)) * mask).astype(np.int32),
        "token_type_ids": np.zeros((n, SEQ), np.int32),
        "attention_mask": mask,
        "label": r.randint(0, 6, (n,)).astype(np.int32),
        "example_weight": np.ones((n,), np.float32),
    }


def batches():
    return [fake_batch(16, seed=s) for s in range(3)]


def ragged():
    b = fake_batch(16, seed=7)
    b["example_weight"][-3:] = 0.0
    return b


def _resume_check(rank, world, args, payload):
    """Two pp steps at ``{"stage": 2}``; the state after the first saved
    as a resume snapshot, loaded into fresh stages and the second step run
    again: are the consolidated params of both runs the same bits?"""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.parallel.execution import setup_sharded_model
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.parallel.pp import (
        make_pp_eval_step, make_pp_train_step,
    )
    from pdnlp_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(shape={"stage": 2}, device_type="cpu")
    dev = torch.device("cpu")
    b1, b2 = (to_device(b, dev) for b in payload["batches"][:2])

    def fresh():
        cfg, state = setup_sharded_model(args, VOCAB, mesh, "pp")
        trainer = Trainer(args, cfg, state,
                          make_pp_train_step(args, mesh, dev),
                          make_pp_eval_step(args, mesh, dev), dev)
        return trainer

    t1 = fresh()
    t1.train_step(t1.state, b1)
    t1.save_resume(payload["path"])
    t1.train_step(t1.state, b2)
    first = ckpt.consolidate(t1.state.model)
    t2 = fresh()
    t2.load_resume(payload["path"])
    t2.train_step(t2.state, b2)
    again = ckpt.consolidate(t2.state.model)
    return {"same": all(torch.equal(first[k], again[k]) for k in first),
            "steps": (t1.state.step, t2.state.step)}


def _pp_gang(rank, world, args, payload):
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = {"runs": local.train_global_batches(rank, world, args,
                                              payload["train"])}
    if payload.get("resume"):
        dist.barrier()
        out["resume"] = _resume_check(rank, world, args, payload["resume"])
    return out


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The 2-rank gang (``{"stage": 2}``: dense, MoE, the resume) and the
    4-rank gang (``{"data": 2, "stage": 2}``, a ragged batch last), started
    at once; the tests compute JAX's side while they run."""
    args = Args(device="cpu", **tiny_args())
    out2 = str(tmp_path_factory.mktemp("pp2"))
    out4 = str(tmp_path_factory.mktemp("pp4"))
    two = {"train": {"runs": [
        {"name": "pp", "mode": "pp", "mesh_shape": {"stage": 2},
         "microbatches": 4, **KERNELS},
        {"name": "moe", "mode": "pp", "mesh_shape": {"stage": 2},
         "microbatches": 4, "model": "bert-tiny-moe"}],
        "vocab_size": VOCAB, "batches": batches(),
        "eval_batch": batches()[0], "out_dir": out2},
        "resume": {"batches": batches(), "path": out2 + "/resume-pp.pt"}}
    four = {"train": {"runs": [
        {"name": "pp22", "mode": "pp", "mesh_shape": {"data": 2, "stage": 2},
         "microbatches": 2, **KERNELS}],
        "vocab_size": VOCAB, "batches": batches() + [ragged()],
        "eval_batch": ragged(), "out_dir": out4}}
    gangs = {n: _Started(lambda n=n, p=p: local.run_gang(
        _pp_gang, n, args, p, timeout=GANG_TIMEOUT))
        for n, p in ((2, two), (4, four))}
    yield gangs
    for g in gangs.values():
        g.thread.join(timeout=2 * GANG_TIMEOUT)


def port_weights(**kw):
    _, state = setup.setup_model(Args(device="cpu", **tiny_args(**kw)),
                                 VOCAB)
    return state.model.state_dict()


def jax_params(**kw):
    return jax.tree_util.tree_map(jnp.asarray,
                                  convert.to_jax_params(port_weights(**kw)))


def jax_pp(shape, n_micro, steps, **kw):
    """JAX's pp step on a ``shape`` mesh of the virtual devices from the
    port's weights: (losses, final params).

    JAX's step differentiates ``_select_last``'s ``psum`` over ``stage``
    under ``shard_map(check_vma=False)``, whose transpose is a ``psum`` of
    the cotangent: every gradient it takes is S times the true one (JAX's
    own test holds it to dp at rel 1e-4 only, ``test_parallel.py:206``).
    AdamW divides the scale out except in ``eps``: with ``eps * S`` JAX's
    update is the true gradient's, which the port takes, so the two are
    held at the tight bounds."""
    S = shape["stage"]
    jargs = JArgs(**tiny_args(**kw))
    jargs = jargs.replace(adam_eps=jargs.adam_eps * S)
    mesh = jax_make_mesh(shape=shape)
    cfg, tx, state, sh = setup_pp_model(jargs, VOCAB, mesh)
    state["params"] = jax.device_put(jax_params(**kw),
                                     pp_shardings(state, mesh)["params"])
    step = make_pp_train_step(cfg, tx, jargs, mesh, n_micro=n_micro)
    put = make_pp_batch(mesh)
    losses = []
    for b in steps:
        state, m = step(state, put(b))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state["params"])


def jax_dp(steps):
    jargs = JArgs(**tiny_args())
    mesh = jax_make_mesh(shape={"data": 2})
    cfg, tx, state, sh = setup_sharded_model(jargs, VOCAB, mesh, "dp")
    state["params"] = jax.device_put(jax_params(), sh["params"])
    step = make_parallel_train_step(cfg, tx, jargs, mesh, sh)
    put = make_global_batch(mesh)
    losses = []
    for b in steps:
        state, m = step(state, put(b))
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state["params"])


def close_to_jax(params, jparams, atol):
    got = convert.to_jax_params(params)
    lg = jax.tree_util.tree_leaves_with_path(got)
    lw = jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, g), (_, w) in zip(lg, lw):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol,
                                   err_msg=str(path))


def _runs(gang, name):
    return [next(r for r in g["runs"] if r["name"] == name) for g in gang]


def _params(rec):
    return torch.load(rec["checkpoint"], weights_only=True)["state_dict"]


@pytest.mark.parametrize("data", [1, 2])
def test_pp_matches_jax_pp_and_dp(started, data):
    """3 steps of 16 rows (a 4th, ragged, on the dp x pp mesh) against
    JAX's pp step on the same mesh (loss rel 1e-5, params 2e-5) and JAX's
    dp step (loss rel 1e-5; params 2e-5, 5e-5 over the dp x pp run's 4
    Adam steps, JAX's bound); every rank reports the same losses."""
    steps = batches() + ([ragged()] if data == 2 else [])
    shape = {"stage": 2} if data == 1 else {"data": 2, "stage": 2}
    jl, jp = jax_pp(shape, 4 if data == 1 else 2, steps)
    dl, dp = jax_dp(steps)
    recs = _runs(started[2 if data == 1 else 4].get(),
                 "pp" if data == 1 else "pp22")
    for r in recs:
        assert r["losses"] == recs[0]["losses"]
    np.testing.assert_allclose(recs[0]["losses"], jl, rtol=1e-5)
    np.testing.assert_allclose(recs[0]["losses"], dl, rtol=1e-5)
    params = _params(recs[0])
    close_to_jax(params, jp, 2e-5)
    close_to_jax(params, dp, 2e-5 if data == 1 else 5e-5)


def test_pp_eval_metric_contract(started):
    """The eval step: on ``{"stage": 2}`` the whole batch's predictions
    and labels; on the dp x pp mesh the ragged batch's 13 real rows,
    gathered over the data axis."""
    pred, label, ew = _runs(started[2].get(), "pp")[0]["eval"]
    assert pred.shape == (16,) and ew.sum() == 16.0
    np.testing.assert_array_equal(label, batches()[0]["label"])
    pred, label, ew = _runs(started[4].get(), "pp22")[0]["eval"]
    assert pred.shape == (16,) and ew.sum() == 13.0
    np.testing.assert_array_equal(label, ragged()["label"])


def test_pp_moe_matches_jax_pp(started):
    """bert-tiny-moe on ``{"stage": 2}``: the aux is each stage's layer
    share averaged over the microbatches and summed over the stages, as
    JAX's tick loop does; losses rel 1e-5, params 2e-5."""
    jl, jp = jax_pp({"stage": 2}, 4, batches(), model="bert-tiny-moe")
    rec = _runs(started[2].get(), "moe")[0]
    np.testing.assert_allclose(rec["losses"], jl, rtol=1e-5)
    close_to_jax(_params(rec), jp, 2e-5)


def test_pp_stages_hold_only_their_layers(started):
    """Stage s holds layer s alone (bert-tiny: 2 layers over 2 stages),
    plus the embeddings and the head, whose copies stay bit-equal after
    the steps; the gathered checkpoint is the full tree."""
    for gang, name in ((started[2].get(), "pp"), (started[4].get(), "pp22")):
        recs = _runs(gang, name)
        for rank, r in enumerate(recs):
            stage = rank % 2
            layers = {k.split(".")[1] for k in r["param_shapes"]
                      if k.startswith("layers.")}
            assert layers == {str(stage)}
            assert "embeddings.word" in r["param_shapes"]
            assert "classifier.weight" in r["param_shapes"]
        assert len(set(recs[0]["replicated_digests"])) == 1
        assert set(_params(recs[0])) == set(port_weights())


def test_pp_checkpoint_serves_and_resumes(started, tmp_path):
    """The consolidated checkpoint loads in ``serve.cli``'s engine, whose
    logits are JAX's on the same weights (2e-5); a snapshot taken after
    one step reloads into fresh stages and the next step lands on the
    uninterrupted run's params bit for bit."""
    from pdnlp_tpu_torch.serve.engine import build_engine

    gang = started[2].get()
    rec = _runs(gang, "pp")[0]
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                               + [f"t{i}" for i in range(VOCAB - 5)]) + "\n")
    engine = build_engine(Args(device="cpu", model="bert-tiny",
                               vocab_path=str(vocab), **{
                                   k: v for k, v in tiny_args().items()
                                   if k != "model"}),
                          checkpoint=rec["checkpoint"])
    batch = fake_batch(4, seed=9)
    got = engine.infer(batch)
    jcfg = jax_get_config("bert-tiny", vocab_size=VOCAB)
    want = jbert.classify(jax.tree_util.tree_map(
        jnp.asarray, convert.to_jax_params(_params(rec))), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
    for r in gang:
        assert r["resume"]["same"] and r["resume"]["steps"] == (2, 2)


def test_pp_refusals():
    """JAX's refusals on the pp path: a stage count that does not divide
    the layers, the EMA, a mesh without a stage axis."""
    from pdnlp_tpu_torch.models.config import get_config
    from pdnlp_tpu_torch.parallel.pp import check_pp
    from pdnlp_tpu_torch.parallel.sharding import check_mesh

    a = Args(**tiny_args())
    with pytest.raises(ValueError, match="must divide num_layers"):
        check_pp(a, get_config("bert-tiny"), 3)
    with pytest.raises(ValueError, match="--ema_decay"):
        check_pp(a.replace(ema_decay=0.9), get_config("bert-tiny"), 2)
    with pytest.raises(ValueError, match="pp needs a 'stage' mesh axis"):
        check_mesh("pp", {"data": 2})
