"""Tensor parallelism in the PyTorch port against the JAX package's ``tp``
mode (``pdnlp_tpu/parallel/sharding.py`` ``_tp_spec``,
``tests/test_parallel.py:134``): gloo gangs of real ranks on the CPU
(``parallel.local.run_gang``, bert-tiny) at ``{"data": 1, "model": 2}``
and ``{"data": 2, "model": 2}``, each held to JAX's step on the same mesh
of the suite's virtual CPU devices and to JAX's dp run, from the same
weights (the port's seeded init, carried to JAX by ``models.convert``).

Tolerances are JAX's: the loss to 1e-5 relative, the params to 2e-5.
Each rank holds half of every q/k/v/up column and o/down row; the
consolidated checkpoint loads into ``train.single`` and into JAX; a
resume re-slices it bit for bit; with dropout on, the replicated weights
stay bit-equal within the model group (every rank of it draws the same
masks).  The attention runs the flash kernels' twins on each rank's heads
(``attention_impl pallas``).  The placement runs each rank on one thread
(``parallel.execution.setup_sharded_model``): the CPU backward of the
embedding gather is not the same bits from process to process with
several threads, and the weights a model group replicates are updated
from gradients each rank computes itself.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.parallel import (
    make_global_batch, make_mesh as jax_make_mesh, make_parallel_train_step,
    setup_sharded_model,
)
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.parallel import local
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train import setup
from pdnlp_tpu_torch.utils.config import Args

SEQ = 16
VOCAB = 100
LR = 1e-3            # large enough that a wrong gradient shows in 3 steps
GANG_TIMEOUT = 300
BATCHES = 3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's torch work in the test
    process (the gangs' ranks run one each): the suite runs several
    workers on the machine's cores at once."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


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


def global_batches(n=16):
    return [fake_batch(n, seed=s) for s in range(BATCHES)]


def port_weights(**kw):
    """The seeded full weights every rank slices, as a state dict."""
    _, state = setup.setup_model(Args(device="cpu", **tiny_args(**kw)),
                                 VOCAB)
    return state.model.state_dict()


def jax_run(batches, mode, shape, **kw):
    """JAX's parallel step on a ``shape`` mesh of the virtual devices from
    the port's weights: (losses, final params as numpy)."""
    jargs = JArgs(**tiny_args(**kw))
    jmesh = jax_make_mesh(shape=shape)
    cfg, tx, state, sh = setup_sharded_model(jargs, VOCAB, jmesh, mode)
    params = convert.to_jax_params(port_weights(**kw))
    state["params"] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, params), sh["params"])
    step = make_parallel_train_step(cfg, tx, jargs, jmesh, sh)
    put = make_global_batch(jmesh)
    losses = []
    for b in batches:
        state, m = step(state, put(b))
        losses.append(float(m["loss"]))
    return losses, jax.tree_util.tree_map(np.asarray,
                                          jax.device_get(state["params"]))


def port_params(rec):
    """A run's consolidated weights, from the checkpoint rank 0 wrote."""
    return torch.load(rec["checkpoint"], weights_only=True)["state_dict"]


def close_to_jax(params, jparams, atol):
    got = convert.to_jax_params(params)
    lg = jax.tree_util.tree_leaves_with_path(got)
    lw = jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, g), (_, w) in zip(lg, lw):
        np.testing.assert_allclose(g, w, atol=atol, err_msg=str(path))


def run_gang(world, runs, tmp_path_factory, name):
    out = tmp_path_factory.mktemp(name)
    batches = global_batches()
    args = Args(device="cpu", **tiny_args())
    res = local.run_gang(local.train_global_batches, world, args,
                         {"runs": runs, "vocab_size": VOCAB,
                          "batches": batches, "eval_batch": batches[0],
                          "out_dir": str(out)}, timeout=GANG_TIMEOUT)
    return {r["name"]: [res[k][i] for k in range(world)]
            for i, r in enumerate(res[0])}


def _resume_gang(rank, world, args, payload):
    """Two steps under tp {"data": 1, "model": 2}; the state after the
    first saved as a resume snapshot, loaded into a fresh state and the
    second step run again: the consolidated params of both runs."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.parallel.execution import (
        make_parallel_eval_step, make_parallel_train_step,
        setup_sharded_model,
    )
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.train.trainer import Trainer

    mesh = make_mesh(shape={"data": 1, "model": 2}, device_type="cpu")
    dev = torch.device("cpu")
    b1, b2 = (to_device(b, dev) for b in payload["batches"][:2])

    def fresh():
        cfg, state = setup_sharded_model(args, VOCAB, mesh, "tp")
        return cfg, state, make_parallel_train_step(args, mesh, dev, "tp")

    cfg, state, step = fresh()
    step(state, b1)
    trainer = Trainer(args, cfg, state, step,
                      make_parallel_eval_step(args, state), dev)
    trainer.save_resume(payload["path"])
    step(state, b2)
    first = ckpt.consolidate(state.model)
    cfg, state2, step2 = fresh()
    trainer2 = Trainer(args, cfg, state2, step2,
                       make_parallel_eval_step(args, state2), dev)
    trainer2.load_resume(payload["path"])
    step2(state2, b2)
    again = ckpt.consolidate(state2.model)
    return {"same": all(torch.equal(first[k], again[k]) for k in first),
            "steps": (state.step, state2.step)}


@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    kernels = dict(attention_impl="pallas", fused_ce="pallas")
    return run_gang(2, [
        {"name": "tp", "mode": "tp", "mesh_shape": {"data": 1, "model": 2},
         **kernels},
        {"name": "tp_dropout", "mode": "tp", "dropout": 0.1,
         "mesh_shape": {"data": 1, "model": 2}}], tmp_path_factory, "tp2")


@pytest.fixture(scope="module")
def tp4(tmp_path_factory):
    return run_gang(4, [
        {"name": "tp", "mode": "tp", "mesh_shape": {"data": 2, "model": 2},
         "attention_impl": "pallas"}], tmp_path_factory, "tp4")


@pytest.mark.parametrize("data", [1, 2])
def test_tp_matches_jax_tp_and_dp(tp2, tp4, data):
    """3 steps of 16 rows at ``{"data": D, "model": 2}`` against JAX's tp
    step on the same mesh and JAX's dp step on one device: losses rel
    1e-5, consolidated params 2e-5; every rank reports the same losses."""
    ranks = (tp2 if data == 1 else tp4)["tp"]
    batches = global_batches()
    jl, jparams = jax_run(batches, "tp", {"data": data, "model": 2})
    dl, dparams = jax_run(batches, "dp", {"data": 1})
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(r["losses"], dl, rtol=1e-5)
    params = port_params(ranks[0])
    close_to_jax(params, jparams, 2e-5)
    close_to_jax(params, dparams, 2e-5)
    # the eval step gathers the global batch once (over the data axis)
    pred, label, ew = ranks[0]["eval"]
    np.testing.assert_array_equal(label, batches[0]["label"])
    assert pred.shape == (16,)


def test_tp_shards_every_split_leaf(tp2, tp4):
    """Each rank holds half of every q/k/v/up column (output features)
    and o/down row (input features), the rest whole (JAX ``_tp_spec``);
    the params and moments it holds are the shard fraction's share."""
    for ranks in (tp2["tp"], tp4["tp"]):
        for r in ranks:
            shapes = r["param_shapes"]
            for sub in ("q", "k", "v"):
                assert shapes[f"layers.0.{sub}.weight"] == (64, 128)
                assert shapes[f"layers.1.{sub}.bias"] == (64,)
            assert shapes["layers.0.up.weight"] == (256, 128)
            assert shapes["layers.0.up.bias"] == (256,)
            assert shapes["layers.0.o.weight"] == (128, 64)
            assert shapes["layers.0.down.weight"] == (128, 256)
            assert shapes["layers.0.o.bias"] == shapes[
                "layers.0.down.bias"] == (128,)
            assert shapes["embeddings.word"] == (VOCAB, 128)
            assert 0.5 < r["shard_fraction"] < 1.0
        assert ranks[0]["digests"][0] != ranks[0]["digests"][1]
        # four all-reduces a layer forward and backward, every step
        assert ranks[0]["megatron"]["calls"] == 4 * 2 * BATCHES
    full = port_weights()
    assert sum(v.numel() * 4 for v in full.values()) > \
        tp2["tp"][0]["param_bytes"]


def test_tp_dropout_keeps_the_model_group_equal(tp2):
    """Dropout 0.1: both ranks of the model group draw the same hidden
    masks (their dropout seed folds the data coordinate only), so the
    weights they replicate stay bit-equal and they report one loss."""
    r0, r1 = tp2["tp_dropout"]
    assert r0["replicated_digests"][0] == r0["replicated_digests"][1]
    assert r0["losses"] == r1["losses"]
    assert r0["losses"] != tp2["tp"][0]["losses"]


def test_tp_checkpoint_loads_into_single_and_jax(tp2):
    """The consolidated tp checkpoint is the full tree: ``train.single``'s
    model loads it (the port's shape check) and gives JAX's logits on it
    within 2e-5."""
    from pdnlp_tpu.models import get_config as jax_get_config

    rec = tp2["tp"][0]
    _, state = setup.setup_model(Args(device="cpu", **tiny_args()), VOCAB)
    sd = ckpt.load_params(rec["checkpoint"], state.model.state_dict(),
                          model_name="bert-tiny")
    state.model.load_state_dict(sd)
    batch = fake_batch(4, seed=9)
    jcfg = jax_get_config("bert-tiny", vocab_size=VOCAB)
    want = jbert.classify(jax.tree_util.tree_map(
        jnp.asarray, convert.to_jax_params(sd)), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = state.model.eval().classify(
            {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_tp_resume_reslices_bit_for_bit(tmp_path):
    """A resume snapshot saved under tp holds the full tree and moments;
    loaded into a fresh tp state it is re-sliced, and the next step ends
    on the uninterrupted run's params bit for bit."""
    args = Args(device="cpu", **tiny_args())
    r0, r1 = local.run_gang(_resume_gang, 2, args,
                            {"batches": global_batches(8),
                             "path": str(tmp_path / "resume-tp.pt")},
                            timeout=GANG_TIMEOUT)
    assert r0["same"] and r1["same"]
    assert r0["steps"] == (2, 2)
    raw = torch.load(str(tmp_path / "resume-tp.pt"), weights_only=False)
    assert tuple(raw["model"]["layers.0.q.weight"].shape) == (128, 128)
