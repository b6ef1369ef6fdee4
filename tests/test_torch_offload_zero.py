"""Host-resident AdamW moments (``--offload_opt_state``), the EMA and
``--grads_dtype compute`` under zero, in the PyTorch port on the CPU:

- dp and zero at two gloo ranks, each with and without
  ``--offload_opt_state``: the offloaded runs end on the on-device runs'
  params bit for bit, and their moments are plain host tensors
  (``train.optim.OffloadAdamW``: this rank's shard under zero; pinned on
  a machine with a card, which the H100 smoke checks), staged both ways
  every step;
- JAX's refusals of offload (``pdnlp_tpu/train/run.py:54-59``), with its
  wording, and of the single-device entry point;
- the EMA under zero against JAX's zero step with ``ema_decay`` on its
  2-device mesh from the same weights (``models.convert``): the EMA tree
  within 2e-5 in fp32, and JAX's offload is held through the on-device
  run, since JAX's own offload does not run on XLA:CPU
  (``tests/test_parallel.py:269-291``);
- bf16 ``--grads_dtype compute`` under zero (its matmul weights gathered
  and reduce-scattered in bf16, with zero's remat) against
  JAX's zero compute step within ``tests/test_torch_fuse.py``'s bf16
  band: losses 2e-2, the updates' relative norm 0.06 whole, 0.15 per
  matmul weight and 0.4 per leaf.

One gang runs every strategy of the file (module scope).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.parallel import (
    make_global_batch, make_mesh as jax_make_mesh, make_parallel_train_step,
    setup_sharded_model,
)
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.parallel import local
from pdnlp_tpu_torch.train import setup, steps
from pdnlp_tpu_torch.utils.config import Args

SEQ = 16
VOCAB = 100
LR = 1e-3
GANG_TIMEOUT = 240
EMA_DECAY = 0.9


def tiny(**kw):
    return {**dict(model="bert-tiny", max_seq_len=SEQ, train_batch_size=4,
                   dropout=0.0, attn_dropout=0.0, learning_rate=LR), **kw}


def fake_batch(n, seed):
    r = np.random.RandomState(seed)
    mask = np.ones((n, SEQ), np.int32)
    mask[::3, SEQ // 2:] = 0
    return {"input_ids": r.randint(5, VOCAB, (n, SEQ)).astype(np.int32)
            * mask,
            "token_type_ids": np.zeros((n, SEQ), np.int32),
            "attention_mask": mask,
            "label": r.randint(0, 6, (n,)).astype(np.int32),
            "example_weight": np.ones((n,), np.float32)}


BATCHES = [fake_batch(16, s) for s in (1, 2, 3)]

RUNS = {
    "dp": {"mode": "dp"},
    "dp_offload": {"mode": "dp", "offload_opt_state": True},
    "zero": {"mode": "zero"},
    "zero_offload": {"mode": "zero", "offload_opt_state": True},
    "zero_ema": {"mode": "zero", "ema_decay": EMA_DECAY},
    "dp_ema": {"mode": "dp", "ema_decay": EMA_DECAY},
    "zero_compute": {"mode": "zero", "remat": True, "dtype": "bfloat16",
                     "grads_dtype": "compute"},
}


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    out = tmp_path_factory.mktemp("offload")
    runs = [{"name": n, **kw} for n, kw in RUNS.items()]
    res = local.run_gang(local.train_global_batches, 2,
                         Args(device="cpu", **tiny()),
                         {"runs": runs, "vocab_size": VOCAB,
                          "batches": BATCHES, "eval_batch": BATCHES[0],
                          "out_dir": str(out)},
                         timeout=GANG_TIMEOUT)
    return {r["name"]: (r, res[1][i]) for i, r in enumerate(res[0])}


def _params(rec):
    return torch.load(rec["checkpoint"], weights_only=True)["state_dict"]


def _init(**kw):
    _, state = setup.setup_model(Args(device="cpu", **tiny(**kw)), VOCAB)
    return state.model.state_dict()


def jax_zero(**kw):
    """JAX's zero step on a 2-device mesh from the port's weights: the
    losses and the final state (numpy)."""
    jargs = JArgs(**tiny(**kw))
    jmesh = jax_make_mesh(num_devices=2)
    cfg, tx, state, sh = setup_sharded_model(jargs, VOCAB, jmesh, "zero")
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.to_jax_params(_init()))
    state["params"] = jax.device_put(params, sh["params"])
    if "ema" in state:
        state["ema"] = jax.device_put(
            jax.tree_util.tree_map(jnp.copy, params), sh["ema"])
    step = make_parallel_train_step(cfg, tx, jargs, jmesh, sh)
    put = make_global_batch(jmesh)
    losses = []
    for b in BATCHES:
        state, m = step(state, put(b))
        losses.append(float(m["loss"]))
    return losses, {k: jax.tree_util.tree_map(np.asarray, jax.device_get(v))
                    for k, v in state.items() if k in ("params", "ema")}


@pytest.mark.parametrize("mode", ["dp", "zero"])
def test_offload_equals_the_on_device_run(gang, mode):
    """Offloaded moments give the on-device run's params and losses bit
    for bit (each chunk's update is AdamW's own), every moment sits in
    host memory as a plain tensor (zero: this rank's shard), and each
    step stages all of them both ways."""
    on, off = gang[mode][0], gang[f"{mode}_offload"][0]
    assert on["losses"] == off["losses"]
    a, b = _params(on), _params(off)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert off["digests"] == on["digests"]
    m = off["moments"]
    assert m["count"] == 2 * len(a) and m["host"] == m["count"]
    assert m["offload"] and not on["moments"]["offload"]
    if mode == "zero":     # the on-device run's moments are DTensors
        assert on["moments"]["host"] == 0
    numel = sum(v.numel() for v in a.values())
    share = 1 if mode == "dp" else 2
    assert m["staged_bytes"] == pytest.approx(2 * 2 * 4 * numel / share,
                                              rel=0.01)
    assert on["moments"]["staged_bytes"] == 0


@pytest.mark.parametrize("how", ["explicit_collectives", "fuse_steps",
                                 "tp", "single"])
def test_offload_refusals_are_jax_own(how, corpus_path, tmp_path):
    """Offload is refused with shard_map, fused steps and tp in JAX's
    words, and by the single-device entry point as JAX's ``setup_model``
    refuses it."""
    from pdnlp_tpu.train import run as jrun, setup as jsetup
    from pdnlp_tpu_torch.train import multi
    from pdnlp_tpu_torch.train.run import build_parallel_trainer

    kw = dict(offload_opt_state=True, data_path=corpus_path,
              vocab_path=str(tmp_path / "v.txt"))
    if how == "single":
        with pytest.raises(ValueError) as want:
            jsetup.setup_model(JArgs(**kw), VOCAB)
        with pytest.raises(ValueError) as got:
            setup.setup_model(Args(device="cpu", **kw), VOCAB)
        assert str(got.value) == str(want.value)
        return
    jkw, pkw, argv = dict(kw), {}, ["--offload_opt_state", "true"]
    if how == "explicit_collectives":
        pkw["explicit_collectives"] = True
        argv += ["--strategy", "shardmap"]
    elif how == "fuse_steps":
        jkw["fuse_steps"] = 2
        argv += ["--fuse_steps", "2"]
    else:
        pkw["mode"] = "tp"
        argv += ["--strategy", "tp"]
    with pytest.raises(ValueError) as want:
        jrun.build_parallel_trainer(JArgs(**jkw), mesh=jax_make_mesh(
            num_devices=2), **pkw)
    with pytest.raises(ValueError) as got:
        build_parallel_trainer(Args(device="cpu", **jkw), **pkw)
    assert str(got.value) == str(want.value)
    assert "offload_opt_state works with the jit dp/zero" in str(got.value)
    with pytest.raises(SystemExit, match="works with the jit dp/zero"):
        multi.parse(argv + ["--device", "cpu"])


def test_zero_ema_matches_jax(gang):
    """zero with ``--ema_decay``: the EMA tree (one shard per rank, made
    whole) is JAX's zero step's within 2e-5 in fp32, the params within
    JAX's 2e-5 too, and the losses within 1e-5; the Trainer's dev pass on
    it equals dp's (1e-6), and so does the tree."""
    rec = gang["zero_ema"][0]
    losses, jstate = jax_zero(ema_decay=EMA_DECAY)
    np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5)
    for got, want in ((rec["ema"], jstate["ema"]),
                      ({k: v.numpy() for k, v in _params(rec).items()},
                       jstate["params"])):
        got = convert.to_jax_params({k: torch.as_tensor(v)
                                     for k, v in got.items()})
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(got),
                jax.tree_util.tree_leaves_with_path(want)):
            np.testing.assert_allclose(g, np.asarray(w), atol=2e-5,
                                       err_msg=str(path))
    # the EMA moved off the params and off the init
    p = _params(rec)
    assert any(not np.array_equal(rec["ema"][k], p[k].numpy()) for k in p)
    # the dev pass evaluates the EMA under zero (its shards swapped into
    # the params' place) as dp evaluates it, and the params are back after
    dp = gang["dp_ema"][0]
    np.testing.assert_allclose(rec["ema_dev"], dp["ema_dev"], rtol=1e-6)
    for k in rec["ema"]:
        np.testing.assert_allclose(rec["ema"][k], dp["ema"][k], atol=1e-6)


def _update_rel(got_sd, want_tree, start_sd):
    got = convert.to_jax_params({k: torch.as_tensor(v)
                                 for k, v in got_sd.items()})
    start = convert.to_jax_params(start_sd)
    leaves = {jax.tree_util.keystr(p): (np.asarray(g, np.float64),
                                        np.asarray(w, np.float64),
                                        np.asarray(s, np.float64))
              for (p, g), (_, w), (_, s) in zip(
                  jax.tree_util.tree_leaves_with_path(got),
                  jax.tree_util.tree_leaves_with_path(want_tree),
                  jax.tree_util.tree_leaves_with_path(start))}
    per = {k: float(np.linalg.norm((g - s) - (w - s))
                    / max(np.linalg.norm(w - s), 1e-30))
           for k, (g, w, s) in leaves.items()}
    whole = float(np.sqrt(sum(np.sum(((g - s) - (w - s)) ** 2)
                              for g, w, s in leaves.values())
                          / sum(np.sum((w - s) ** 2)
                                for _, w, s in leaves.values())))
    return per, whole


#: the key projection's bias: a per-query constant shift of the scores,
#: which the softmax cancels, so its gradient is 0 in exact arithmetic and
#: rounding alone in either framework (JAX's own dp and zero compute runs
#: differ by 1.24 relative on its update here): held in the whole-tree
#: norm, not leaf by leaf
KEY_BIAS = "['layers']['k']['bias']"


def test_zero_compute_grads_matches_jax(gang):
    """bf16 ``--grads_dtype compute`` under zero (with zero's remat):
    every step's loss within 2e-2 of JAX's zero compute step, and the
    updates within the bf16 band of ``tests/test_torch_fuse.py`` (bar
    :data:`KEY_BIAS` leaf by leaf).  Its matmul weights are gathered in
    bf16 and their gradients reduce-scattered in bf16, the rest fp32."""
    rec = gang["zero_compute"][0]
    losses, jstate = jax_zero(dtype="bfloat16", grads_dtype="compute",
                              remat=True)
    assert np.max(np.abs(np.asarray(rec["losses"]) - losses)) <= 2e-2
    got = _params(rec)
    assert all(v.dtype == torch.float32 for v in got.values())
    per, whole = _update_rel(got, jstate["params"], _init())
    print(f"zero compute update vs JAX: whole {whole:.4f}, leaf "
          f"{max(per.values()):.4f}")
    assert whole <= 0.06, whole
    matmul = {k for k in per if "kernel" in k}
    for k, e in per.items():
        if k == KEY_BIAS:
            continue
        assert e <= (0.15 if k in matmul else 0.4), (k, e)


def test_compute_units_are_the_matmul_weights():
    """The weights zero moves in bf16 under ``compute`` (its own buckets,
    gathered and reduce-scattered in that dtype): every matmul weight of
    ``matmul_weights``, the classifier's included, as JAX casts every
    kernel; the rest travel in fp32.  One bucket per encoder layer and
    dtype, and one for the rest, each weight in exactly one."""
    import torch.distributed as dist

    from pdnlp_tpu_torch.models.bert import BertClassifier
    from pdnlp_tpu_torch.models.config import get_config
    from pdnlp_tpu_torch.parallel import runtime
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.parallel.sharding import ZeroObjective

    args = Args(device="cpu", dist_backend="gloo", **tiny())
    model = BertClassifier(get_config("bert-tiny", vocab_size=VOCAB))
    # a group of one (another test of this process may have joined it)
    joined = dist.is_initialized()
    runtime.init_runtime(args)
    try:
        assert dist.get_world_size() == 1
        zero = ZeroObjective(
            steps.TrainObjective(model, args, torch.device("cpu")),
            make_mesh(shape={"data": 1}, device_type="cpu"), torch.bfloat16)
    finally:
        if not joined:
            runtime.shutdown()
    moved = {n for b in zero.buckets if b.dtype == torch.bfloat16
             for n in b.names}
    assert moved == {f"model.{n}" for n in steps.matmul_weights(model)}
    assert "model.classifier.weight" in moved
    names = [n for b in zero.buckets for n in b.names]
    assert sorted(names) == sorted(n for n, _ in zero.objective
                                   .named_parameters())
    assert len(zero.buckets) == 2 * (len(model.layers) + 1)


def test_offload_chunks_equal_one_adamw_step():
    """``OffloadAdamW`` staging the moments a few parameters at a time
    (many chunks) equals ``torch.optim.AdamW`` over three steps, params
    and moments bit for bit, with each moment back in host memory and a
    snapshot of its state loading into either."""
    from pdnlp_tpu_torch.train.optim import OffloadAdamW, build_optimizer

    torch.manual_seed(0)
    args = Args(device="cpu", **tiny(learning_rate=1e-2))
    runs = {}
    for offload in (False, True):
        _, state = setup.setup_model(args, VOCAB)
        if offload:
            opt, _ = build_optimizer(state.model,
                                     args.replace(offload_opt_state=True))
            opt.CHUNK_BYTES = 4096       # a chunk of one or two tensors
            assert isinstance(opt, OffloadAdamW)
        else:
            opt = state.optimizer
        gen = torch.Generator().manual_seed(1)
        for _ in range(3):
            for p in state.model.parameters():
                p.grad = torch.randn(p.shape, generator=gen)
            opt.step()
        runs[offload] = (state.model, opt)
    (m0, o0), (m1, o1) = runs[False], runs[True]
    assert all(torch.equal(a, b) for a, b in zip(m0.parameters(),
                                                 m1.parameters()))
    for p0, p1 in zip(m0.parameters(), m1.parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(o0.state[p0][k], o1.state[p1][k])
            assert o1.state[p1][k].device.type == "cpu"
    assert o1.staged_bytes == 2 * 2 * 4 * sum(p.numel()
                                              for p in m1.parameters())
    o1.load_state_dict(o0.state_dict())
    assert all(o1.state[p]["exp_avg"].device.type == "cpu"
               for p in m1.parameters())
