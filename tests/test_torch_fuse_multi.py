"""``--fuse_steps`` K under a process group in the PyTorch port, on the CPU
(gloo), where a fused group runs its K steps one by one — the plain
version of the captured graph (held against it on the card in
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 16c):

- ``train.multi``'s trainer (``run.build_parallel_trainer``) with
  ``--fuse_steps 4`` under dp (2 ranks: no DDP, the explicit bucketed
  all-reduce), zero (2 ranks: ``parallel.sharding.ZeroObjective``, the
  same step at every K), tp at ``{"data": 1, "model": 2}`` and ep at
  ``{"data": 1, "expert": 2}`` ends on the same gang's eager run's params
  bit for bit, the losses equal;
- the fused dp and zero steps (``train.steps.build_multi_step`` over the
  explicit reduce, or the explicit shards) against JAX's
  ``make_parallel_multi_step`` under the same mode on 2 virtual devices
  from the same weights: losses 1e-5 relative, params 2e-5
  (``tests/test_flash.py``'s fp32 tolerances), zero's params and moments
  sharded (``shard_fraction`` below 1.5 / world);
- bf16 ``--grads_dtype compute``: the fused zero step's bf16 gathers and
  reduce-scatters end on the fused dp step's params bit for bit;
- pp, sp and shardmap take K = 4 and run one step at a time (JAX's
  ``eff_k``), ending where their K = 1 runs end; a gloo group on a card
  would be refused at startup (``parallel.execution.
  check_capture_backend``), zero's step at any width; zero's strategy
  default ``--remat true`` holds under ``--fuse_steps`` above 1;
- the collectives' counters credit a replay with what its capture
  recorded (``parallel.collectives.add_stats``).

One gang runs every case (module scope).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.parallel import (
    make_mesh as jax_make_mesh, setup_sharded_model as jax_setup,
)
from pdnlp_tpu.parallel.execution import make_parallel_multi_step
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.parallel import collectives, local
from pdnlp_tpu_torch.train import setup
from pdnlp_tpu_torch.utils.config import Args

SEQ = 16
VOCAB = 100
LR = 1e-3
K = 4
GANG_TIMEOUT = 300

#: the trainer cases: (mode, knobs, mesh, model)
CASES = {
    "dp": ("dp", {}, {"data": 2}, "bert-tiny"),
    "zero": ("zero", {}, {"data": 2}, "bert-tiny"),
    "tp": ("tp", {}, {"data": 1, "model": 2}, "bert-tiny"),
    "ep": ("ep", {}, {"data": 1, "expert": 2}, "bert-tiny-moe"),
    "pp": ("pp", {}, {"stage": 2}, "bert-tiny"),
    "sp": ("sp", {}, {"data": 1, "seq": 2}, "bert-tiny"),
    "shardmap": ("dp", {"explicit_collectives": True}, {"data": 2},
                 "bert-tiny"),
}


def fake_batch(n, seed):
    r = np.random.RandomState(seed)
    mask = np.ones((n, SEQ), np.int32)
    mask[1::2, SEQ // 2:] = 0
    return {"input_ids": r.randint(5, VOCAB, (n, SEQ)).astype(np.int32)
            * mask,
            "token_type_ids": np.zeros((n, SEQ), np.int32),
            "attention_mask": mask,
            "label": r.randint(0, 6, (n,)).astype(np.int32),
            "example_weight": np.ones((n,), np.float32)}


GLOBAL = [fake_batch(16, s) for s in range(K)]


def _trainer(args, mode, knobs, mesh):
    from pdnlp_tpu_torch.train.run import (
        build_parallel_trainer, build_pipeline_trainer, build_sp_trainer,
    )

    a = args.replace(mode=mode, mesh_shape=mesh)
    if mode == "pp":
        return build_pipeline_trainer(a)
    if mode == "sp":
        return build_sp_trainer(a)
    return build_parallel_trainer(a, mode=mode, **knobs)


def _gang(rank, world, args, payload):
    """Each case's trainer over one epoch at ``--fuse_steps`` K and 1
    (the params made whole, whether a K-step dispatch was built, the
    losses of every logged step); then the fused dp and zero steps on the
    global batches ``GLOBAL`` stacked as one group, in fp32 and under bf16
    ``--grads_dtype compute``."""
    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.parallel.execution import (
        make_parallel_train_step, setup_sharded_model,
    )
    from pdnlp_tpu_torch.parallel.local import rank_block
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.parallel.sharding import shard_fraction
    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train.steps import build_multi_step
    from pdnlp_tpu_torch.train.trainer import LoopHooks

    torch.set_num_threads(1)
    out = {}
    for name, (mode, knobs, mesh, model) in CASES.items():
        for fuse in (K, 1):
            a = args.replace(model=model, fuse_steps=fuse,
                             output_dir=f"{payload['dir']}/{name}{fuse}")
            t, loader, _ = _trainer(a, mode, knobs, mesh)
            losses = []
            t.train(loader, hooks=LoopHooks(
                on_log=lambda e, s, n, loss: losses.append((s, loss)),
                end_save=False))
            params = ckpt.consolidate(t.state.model)
            out[(name, fuse)] = {
                "params": {k: v.numpy().copy() for k, v in params.items()},
                "losses": losses, "fuse": t.fuse, "steps": t.state.step,
                "multi": t.multi_step is not None}
    # the fused dp and zero steps on the global batches, one group of K
    dev = torch.device("cpu")
    m = make_mesh(shape={"data": 2}, device_type="cpu")
    blocks = [rank_block(b, rank, world) for b in GLOBAL]
    group = {k: np.stack([b[k] for b in blocks]) for k in blocks[0]}
    for mode, extra in (("dp", {}), ("zero", {}),
                        ("dp", {"dtype": "bfloat16",
                                "grads_dtype": "compute"}),
                        ("zero", {"dtype": "bfloat16",
                                  "grads_dtype": "compute"})):
        a = args.replace(fuse_steps=K, **extra)
        _, state = setup_sharded_model(a, VOCAB, m, mode)
        multi = build_multi_step(make_parallel_train_step(a, m, dev, mode),
                                 dev)
        metrics = multi(state, to_device(group, dev))
        out[("explicit", mode, bool(extra))] = {
            "losses": [float(x) for x in metrics["loss"]],
            "params": {k: v.numpy().copy() for k, v in
                       ckpt.consolidate(state.model).items()},
            "wrapper": type(state.objective).__name__,
            "shard_fraction": shard_fraction(state.model, state.optimizer)}
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def gang(corpus_path, tmp_path_factory):
    from pdnlp_tpu_torch.data.tokenizer import get_or_build_vocab

    d = tmp_path_factory.mktemp("fuse_multi")
    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                vocab_path=str(d / "v.txt"), data_limit=90, max_seq_len=SEQ,
                train_batch_size=4, dropout=0.0, attn_dropout=0.0,
                learning_rate=LR, dist_backend="gloo", pipeline="sync",
                log_every=1, epochs=1)
    get_or_build_vocab(args)
    return local.run_gang(_gang, 2, args, {"dir": str(d)},
                          timeout=GANG_TIMEOUT)[0]


@pytest.mark.parametrize("case", ["dp", "zero", "tp", "ep"])
def test_fused_equals_eager_under_a_group(gang, case):
    """dp, zero, tp and ep at ``--fuse_steps 4`` build the K-step dispatch
    and end on the eager run's params bit for bit, with the same loss at
    every step the fused run logs (dp's fused run reduces through the
    explicit bucketed all-reduce, its eager run through DDP; zero's runs
    both gather and reduce-scatter their shards in the same step)."""
    fused, eager = gang[(case, K)], gang[(case, 1)]
    assert fused["multi"] and fused["fuse"] == K
    assert not eager["multi"]
    assert fused["steps"] == eager["steps"] >= 2 * K
    # a fused group logs its last step's loss at its end
    at = dict(eager["losses"])
    assert len(fused["losses"]) >= 2
    assert all(at[s] == loss for s, loss in fused["losses"])
    for k, v in eager["params"].items():
        assert np.array_equal(fused["params"][k], v), k


@pytest.mark.parametrize("case", ["pp", "sp", "shardmap"])
def test_unfused_paths_take_k_and_run_one_step(gang, case):
    """pp, sp and shardmap accept ``--fuse_steps 4`` and run one step at a
    time, as JAX's ``eff_k`` does: no K-step dispatch, the K = 1 run's
    params bit for bit."""
    fused, eager = gang[(case, K)], gang[(case, 1)]
    assert not fused["multi"] and fused["fuse"] == 1
    assert fused["steps"] == eager["steps"]
    for k, v in eager["params"].items():
        assert np.array_equal(fused["params"][k], v), k


@pytest.mark.parametrize("mode", ["dp", "zero"])
def test_fused_dp_matches_jax_multi_step(gang, mode):
    """The fused dp step (no DDP: the explicit bucketed all-reduce) and the
    fused zero step (``ZeroObjective``, its params and moments sharded
    between steps) on 4 global batches against JAX's
    ``make_parallel_multi_step`` (a ``lax.scan``) under the same mode on a
    2-device mesh from the same weights: losses 1e-5 relative, params
    2e-5."""
    rec = gang[("explicit", mode, False)]
    if mode == "dp":
        assert rec["wrapper"] == "TrainObjective"
    else:
        assert rec["wrapper"] == "ZeroObjective"
        assert rec["shard_fraction"] < 1.5 / 2
    _, state = setup.setup_model(Args(device="cpu", model="bert-tiny",
                                      max_seq_len=SEQ, dropout=0.0,
                                      attn_dropout=0.0, learning_rate=LR),
                                 VOCAB)
    jargs = JArgs(model="bert-tiny", max_seq_len=SEQ, dropout=0.0,
                  attn_dropout=0.0, learning_rate=LR, fuse_steps=K)
    jmesh = jax_make_mesh(num_devices=2)
    cfg, tx, jstate, sh = jax_setup(jargs, VOCAB, jmesh, mode)
    params = convert.to_jax_params(state.model.state_dict())
    jstate["params"] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, params), sh["params"])
    multi = make_parallel_multi_step(cfg, tx, jargs, jmesh, sh)
    stacked = {k: jnp.stack([b[k] for b in GLOBAL]) for k in GLOBAL[0]}
    jstate, m = multi(jstate, stacked)
    np.testing.assert_allclose(rec["losses"], np.asarray(m["loss"]),
                               rtol=1e-5)
    got = convert.to_jax_params({k: torch.from_numpy(v)
                                 for k, v in rec["params"].items()})
    want = jax.device_get(jstate["params"])
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5,
                                   err_msg=str(path))


def test_zero_refuses_fused_steps_and_gloo_capture():
    """zero with ``--fuse_steps`` above 1 is taken at the entry point and
    in the assembly (refused before, ROADMAP A7), its strategy's
    ``--remat true`` default kept (the captured step replays the
    recompute's masks, ``models.bert.RematRng``) unless ``--remat false``
    is given; offload with fused steps stays refused; a captured step on
    a card over gloo is refused at startup — zero's at world 1 too, whose
    step always holds collectives."""
    from pdnlp_tpu_torch.parallel import execution
    from pdnlp_tpu_torch.train import multi

    args, knobs = multi.parse(["--strategy", "zero", "--fuse_steps", "2"])
    assert args.fuse_steps == 2 and knobs["mode"] == "zero"
    assert args.remat is True
    assert multi.parse(["--strategy", "zero"])[0].remat is True
    assert multi.parse(["--strategy", "zero", "--fuse_steps", "2",
                        "--remat", "false"])[0].remat is False
    assert multi.parse(["--mode", "zero", "--fuse_steps", "2"])[0].remat \
        is False
    for mode in ("zero", "dp", "pp", "sp", "tp", "ep"):
        execution.check_strategy(Args(fuse_steps=4), mode)
    with pytest.raises(ValueError, match="works with the jit dp/zero"):
        execution.check_strategy(Args(fuse_steps=4, offload_opt_state=True),
                                 "zero")

    class Gloo:
        @staticmethod
        def is_initialized():
            return True

        @staticmethod
        def get_backend(group=None):
            return "gloo"

    orig = execution.dist
    execution.dist = Gloo
    try:
        with pytest.raises(ValueError, match="needs NCCL"):
            execution.check_capture_backend(
                Args(fuse_steps=4), "dp", torch.device("cuda", 0),
                explicit_reduce=True)
        with pytest.raises(ValueError, match="needs NCCL"):
            execution.check_capture_backend(
                Args(fuse_steps=4), "zero", torch.device("cuda", 0))
        execution.check_capture_backend(Args(fuse_steps=1), "dp",
                                        torch.device("cuda", 0),
                                        explicit_reduce=True)
        execution.check_capture_backend(Args(fuse_steps=4), "pp",
                                        torch.device("cuda", 0),
                                        explicit_reduce=True)
    finally:
        execution.dist = orig


def test_replays_credit_the_collectives():
    """``add_stats`` credits ``times`` replays with a capture's calls and
    bytes, on the Megatron and the neighbour-exchange tables."""
    before = collectives.stats_counts()
    collectives.add_stats({"stats.calls": 3, "stats.bytes": 96,
                           "p2p.calls": 1, "p2p.bytes": 8}, times=2)
    after = collectives.stats_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "stats.calls": 6, "stats.bytes": 192, "p2p.calls": 2,
        "p2p.bytes": 16}
    collectives.add_stats({k: -(after[k] - before[k]) for k in after})
    assert collectives.stats_counts() == before


def test_fused_zero_compute_equals_fused_dp(gang):
    """bf16 ``--grads_dtype compute`` at 2 ranks: the fused zero step
    gathers the matmul weights in bf16 and reduce-scatters their bf16
    gradients, summed in bf16 then widened and halved, as the fused dp
    step all-reduces them: the same losses and params bit for bit."""
    dp, zero = (gang[("explicit", m, True)] for m in ("dp", "zero"))
    assert zero["wrapper"] == "ZeroObjective"
    assert zero["losses"] == dp["losses"]
    for k, v in dp["params"].items():
        assert np.array_equal(zero["params"][k], v), k
