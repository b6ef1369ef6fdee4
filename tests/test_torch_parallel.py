"""Data-parallel training in the PyTorch port against the JAX package's
(``pdnlp_tpu/parallel``): the rendezvous and the mesh, the step math, and
gangs of real ranks on the CPU (gloo, bert-tiny) — dp (DDP), zero (FSDP2),
the explicit-collectives (shardmap) step and remat — each held to JAX's
step on a 2-device mesh of the suite's virtual CPU devices from the same
weights (the port's seeded init, carried to JAX by ``models.convert``).

Tolerances are ``tests/test_parallel.py``'s: the loss to 1e-5 relative,
the params to 2e-5, the correct count within 1, bf16 on the wire to 1e-3
relative on the loss; dropout is 0, so every layout computes the same
math up to the order of fp32 sums.  The gangs run once per module; each
rank's numbers come back through ``parallel.local.run_gang``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.parallel import (
    make_global_batch, make_mesh as jax_make_mesh, make_parallel_eval_step,
    make_parallel_train_step, make_shardmap_train_step, setup_sharded_model,
)
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.data import collate, packing, tokenizer
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.parallel import collectives, local, mesh, runtime
from pdnlp_tpu_torch.train import setup, steps
from pdnlp_tpu_torch.utils.config import Args

SEQ = 16
VOCAB = 100
LR = 1e-3            # large enough that a wrong gradient shows in 3 steps
GANG_TIMEOUT = 240


def tiny_args(**kw):
    base = dict(model="bert-tiny", max_seq_len=SEQ, train_batch_size=4,
                dropout=0.0, attn_dropout=0.0, learning_rate=LR)
    base.update(kw)
    return base


def fake_batch(n, seed=0, vocab=VOCAB):
    r = np.random.RandomState(seed)
    return {
        "input_ids": r.randint(0, vocab, (n, SEQ)).astype(np.int32),
        "token_type_ids": np.zeros((n, SEQ), np.int32),
        "attention_mask": np.ones((n, SEQ), np.int32),
        "label": r.randint(0, 6, (n,)).astype(np.int32),
        "example_weight": np.ones((n,), np.float32),
    }


# ------------------------------------------------------ runtime and mesh


@pytest.fixture
def clean_env(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_rendezvous_precedence(clean_env):
    """Args fields, then the JAX package's env vars, then torchrun's."""
    env = clean_env
    assert runtime.rendezvous(Args()) == (None, 1, 0, 0)
    env.setenv("MASTER_ADDR", "h2")
    env.setenv("MASTER_PORT", "7")
    env.setenv("WORLD_SIZE", "4")
    env.setenv("RANK", "3")
    env.setenv("LOCAL_RANK", "1")
    assert runtime.rendezvous(Args()) == ("tcp://h2:7", 4, 3, 1)
    env.setenv("COORDINATOR_ADDRESS", "h1:9")
    env.setenv("NUM_PROCESSES", "2")
    env.setenv("PROCESS_ID", "1")
    assert runtime.rendezvous(Args()) == ("tcp://h1:9", 2, 1, 1)
    got = runtime.rendezvous(Args(coordinator_address="file:///tmp/r",
                                  num_processes=3, process_id=0))
    assert got == ("file:///tmp/r", 3, 0, 1)
    env.delenv("COORDINATOR_ADDRESS")
    env.delenv("MASTER_ADDR")
    with pytest.raises(ValueError, match="rendezvous address"):
        runtime.rendezvous(Args(num_processes=2, process_id=0))
    with pytest.raises(ValueError, match="outside"):
        runtime.rendezvous(Args(num_processes=2, process_id=2,
                                coordinator_address="h:1"))


def test_backend_resolution():
    assert runtime.resolve_backend("auto", "cpu") == "gloo"
    assert runtime.resolve_backend("auto", "cuda") == "nccl"
    assert runtime.resolve_backend("gloo", "cuda") == "gloo"
    with pytest.raises(ValueError, match="needs --device cuda"):
        runtime.resolve_backend("nccl", "cpu")
    with pytest.raises(ValueError, match="dist_backend"):
        runtime.resolve_backend("mpi", "cpu")


def test_init_runtime_is_idempotent_at_world_one(clean_env):
    """World 1 forms a group of one (an in-process store); a second call
    returns it; the mesh is one 'data' axis over it."""
    args = Args(device="cpu")
    try:
        assert runtime.init_runtime(args) == (0, 1)
        assert runtime.init_runtime(args) == (0, 1)
        assert torch.distributed.get_backend() == "gloo"
        m = mesh.make_mesh()
        assert m.mesh_dim_names == ("data",) and m.size() == 1
        assert mesh.local_data_extent(m) == (1, 0, 1)
        assert mesh.local_batch_mult(m) == 1
        # the collectives over a group of one: identities, bar the guard
        # and the bf16 wire's rounding
        x = torch.tensor([0.25, 3.0])
        assert torch.equal(collectives.loss_reduce(x), x)
        share, gw = collectives.weighted_shard_scale(torch.tensor(0.0))
        assert float(share) == 0.0 and float(gw) == 1.0
        g = [torch.full((2, 2), 1.0 + 2 ** -12), torch.ones(3)]
        collectives.grad_reduce(g)
        assert float(g[0][0, 0]) == 1.0 + 2 ** -12
        collectives.grad_reduce(g, compress_dtype=torch.bfloat16)
        assert float(g[0][0, 0]) == 1.0 and torch.equal(g[1], torch.ones(3))
        assert torch.equal(collectives.output_reduce(x)[0], x)
        collectives.barrier()
    finally:
        runtime.shutdown()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world,num_devices,shape,want", [
    (4, None, None, 4), (4, 4, None, 4), (4, None, {"data": -1}, 4),
    (2, None, {"data": 2}, 2)])
def test_mesh_size(world, num_devices, shape, want):
    assert mesh.mesh_size(world, num_devices, shape) == want


@pytest.mark.parametrize("num_devices,shape,match", [
    (5, None, "asked for 5 devices, have 4"),
    (2, None, "every rank"),
    (None, {"data": 8}, "needs 8 devices, have 4"),
    (None, {"data": -1, "model": -1}, "at most one inferred"),
    (None, {"data": 2, "model": 2}, "ROADMAP A11"),
    (None, {"stage": 4}, "ROADMAP A11"),
    (None, {"rows": 4}, "unknown mesh axes")])
def test_mesh_errors(num_devices, shape, match):
    with pytest.raises(ValueError, match=match):
        mesh.mesh_size(4, num_devices, shape)
    assert mesh.KNOWN_AXES == ("data", "model", "expert", "seq", "stage")


@pytest.mark.parametrize("mode", ["tp", "ep", "pp", "sp", "fsdp"])
def test_sharding_refuses_other_modes(mode):
    from pdnlp_tpu_torch.parallel import sharding

    with pytest.raises(ValueError, match="A11" if mode != "fsdp"
                       else "unknown"):
        sharding.check_mode(mode)


def test_step_math(corpus_path, tmp_path):
    """dp: global batch 64 at 2-way -> ceil(n/64) steps (144 on the real
    9,200-example split); dataparallel: the single-process count (288),
    each rank a contiguous 16-row block of every 32-row global batch."""
    args = Args(data_path=corpus_path, vocab_path=str(tmp_path / "v.txt"),
                prefetch=0)
    single, _, _ = setup.setup_data(args)
    n = len(single.sampler)
    shards = [setup.setup_data(args, num_shards=2, shard_id=r)[0]
              for r in range(2)]
    assert [len(s) for s in shards] == [-(-n // 64)] * 2
    blocks = [setup.setup_data(args, num_shards=2, shard_id=r,
                               scatter=True)[0] for r in range(2)]
    assert [len(b) for b in blocks] == [len(single)] * 2 == [-(-n // 32)] * 2
    if n == 9200:                                   # the real corpus
        assert len(shards[0]) == 144 and len(blocks[0]) == 288
    single.set_epoch(0)
    for b in blocks:
        b.set_epoch(0)
    for whole, b0, b1 in zip(single, *blocks):
        for k in whole:
            np.testing.assert_array_equal(
                whole[k], np.concatenate([b0[k], b1[k]]))
    with pytest.raises(ValueError, match="equal blocks"):
        setup.setup_data(args.replace(train_batch_size=30), num_shards=4,
                         scatter=True)


def test_dataparallel_blocks_in_pack_mode(corpus_path, tmp_path):
    """The block split holds in every length mode: packed rows too."""
    args = Args(data_path=corpus_path, vocab_path=str(tmp_path / "v.txt"),
                prefetch=0, length_mode="pack", max_seq_len=64)
    single, _, _ = setup.setup_data(args)
    blocks = [setup.setup_data(args, num_shards=2, shard_id=r,
                               scatter=True)[0] for r in range(2)]
    single.set_epoch(1)
    for b in blocks:
        b.set_epoch(1)
    got = list(zip(single, *blocks))
    assert len(got) == len(single)
    for whole, b0, b1 in got:
        assert whole["example_weight"].ndim == 2
        for k in whole:
            np.testing.assert_array_equal(
                whole[k], np.concatenate([b0[k], b1[k]]))


# ----------------------------------------------------------------- gangs


@pytest.fixture(scope="module")
def packed_data():
    """(vocab size, three packed 8 x 32 batches whose ranks' weights
    differ): packer-made rows of a seeded corpus."""
    rng = np.random.RandomState(3)
    chars = "天地人你我他好坏大小上下来去爱恨喜怒哀乐"
    data = [("".join(rng.choice(list(chars))
                     for _ in range(int(rng.choice([3, 5, 9, 14, 25])))),
             int(rng.randint(0, 6))) for _ in range(160)]
    tok = tokenizer.WordPieceTokenizer(
        tokenizer.build_vocab((t for t, _ in data), size=128))
    packed = packing.pack_classification(
        collate.EncodedDataset(data, tok, 32), max_segments=8)
    w = (packed.arrays["example_weight"] > 0).sum(1)
    # rank 0's block of each batch holds the fullest rows, rank 1's the
    # emptiest: the ranks' weight mass differs on every step
    full = np.argsort(-w, kind="stable")
    empty = full[::-1]
    batches = [packed.take(np.concatenate([full[4 * i: 4 * i + 4],
                                           empty[4 * i: 4 * i + 4]]).tolist(),
                           pad_to=8) for i in range(3)]
    return max(tok.vocab_size, VOCAB), batches


#: three steps for the compute-dtype gradients: one Adam step is about
#: ``lr * sign(g)`` and would hide a gradient that is off
COMPUTE_BATCHES = [fake_batch(32, seed=s) for s in (1, 2, 3)]


@pytest.fixture(scope="module")
def gang2(packed_data, tmp_path_factory):
    """One 2-rank gang that trains every strategy of this file."""
    vocab, packed = packed_data
    out = tmp_path_factory.mktemp("gang2")
    fixed = fake_batch(32)
    kernels = dict(attention_impl="pallas", fused_ce="pallas")
    runs = [
        {"name": "dp", "mode": "dp", "batches": [fixed]},
        {"name": "dp_packed", "mode": "dp", "batches": packed, **kernels},
        {"name": "zero", "mode": "zero", "batches": [fixed], **kernels},
        {"name": "shardmap", "explicit_collectives": True,
         "compress_grads": False, "batches": [fixed]},
        {"name": "shardmap_bf16", "explicit_collectives": True,
         "compress_grads": True, "batches": [fixed]},
        {"name": "remat", "mode": "dp", "remat": True, "batches": [fixed]},
        {"name": "zero_remat_packed", "mode": "zero", "remat": True,
         "batches": packed, **kernels},
        {"name": "dp_compute", "mode": "dp", "dtype": "bfloat16",
         "grads_dtype": "compute", "batches": COMPUTE_BATCHES},
    ]
    args = Args(device="cpu", **tiny_args())
    res = local.run_gang(local.train_global_batches, 2, args,
                         {"runs": runs, "vocab_size": vocab,
                          "eval_batch": fixed, "out_dir": str(out)},
                         timeout=GANG_TIMEOUT)
    return {r["name"]: (r, res[1][i]) for i, r in enumerate(res[0])}, vocab


def port_weights(vocab, **kw):
    """The seeded port weights every rank starts from, as a state dict."""
    _, state = setup.setup_model(Args(device="cpu", **tiny_args(**kw)), vocab)
    return state


def jax_run(vocab, batches, mode="dp", explicit=False, compress=False, **kw):
    """JAX's parallel step on a 2-device mesh from the port's weights:
    (losses, accuracies, final params as numpy, eval outputs)."""
    jargs = JArgs(**tiny_args(**kw))
    jmesh = jax_make_mesh(num_devices=2)
    cfg, tx, state, sh = setup_sharded_model(jargs, vocab, jmesh, mode)
    params = convert.to_jax_params(port_weights(vocab).model.state_dict())
    state["params"] = jax.device_put(
        jax.tree_util.tree_map(jnp.asarray, params), sh["params"])
    step = (make_shardmap_train_step(cfg, tx, jargs, jmesh,
                                     compress_grads=compress) if explicit
            else make_parallel_train_step(cfg, tx, jargs, jmesh, sh))
    put = make_global_batch(jmesh)
    losses, accs = [], []
    for b in batches:
        state, m = step(state, put(b))
        losses.append(float(m["loss"]))
        accs.append(float(m["accuracy"]))
    ev = make_parallel_eval_step(cfg, jargs, jmesh, sh["params"])
    em = ev(state["params"], put(batches[0]))
    return losses, accs, jax.tree_util.tree_map(
        np.asarray, jax.device_get(state["params"])), em


def _port_params(rec):
    """A run's consolidated weights, from the checkpoint rank 0 wrote."""
    return torch.load(rec["checkpoint"], weights_only=True)["state_dict"]


def _close_to_jax(rec, jparams, atol=2e-5):
    got = convert.to_jax_params(_port_params(rec))
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jparams)):
        np.testing.assert_allclose(g, w, atol=atol, err_msg=str(path))


def _weights(batch):
    return float(batch["example_weight"].sum())


@pytest.mark.parametrize("name,jax_kw", [
    ("dp", {}), ("zero", {"mode": "zero"}),
    ("shardmap", {"explicit": True}), ("remat", {"remat": True})])
def test_one_step_matches_jax(gang2, name, jax_kw):
    """One step of 32 rows over 2 ranks against JAX's dp / zero /
    shard_map / remat step on 2 devices: loss rel 1e-5, params 2e-5, the
    correct count within 1; the eval step gathers the global outputs."""
    runs, vocab = gang2
    rec, _ = runs[name]
    fixed = fake_batch(32)
    losses, accs, jparams, em = jax_run(vocab, [fixed], **jax_kw)
    assert rec["losses"][0] == pytest.approx(losses[0], rel=1e-5)
    assert abs(rec["accuracies"][0] - accs[0]) * 32 <= 1.0
    _close_to_jax(rec, jparams)
    pred, label, ew = rec["eval"]
    np.testing.assert_array_equal(label, fixed["label"])
    np.testing.assert_array_equal(ew, fixed["example_weight"])
    assert pred.shape == (32,)
    assert abs(int((pred == label).sum()) - float(em["correct"])) <= 1


@pytest.mark.parametrize("name,jax_kw", [
    ("dp_packed", {}), ("zero_remat_packed", {"mode": "zero",
                                              "remat": True})])
def test_packed_steps_with_unequal_rank_weights_match_jax(packed_data,
                                                         gang2, name,
                                                         jax_kw):
    """Three packed steps whose ranks carry different weight mass: the
    objective's ``world * lw / gw`` scale makes the wrappers' mean of the
    ranks' gradients JAX's global weighted mean (2e-5); without it the
    params drift."""
    _, batches = packed_data
    for b in batches:
        lo, hi = local.rank_block(b, 0, 2), local.rank_block(b, 1, 2)
        assert _weights(lo) != _weights(hi)
    runs, vocab = gang2
    rec, _ = runs[name]
    losses, accs, jparams, _ = jax_run(vocab, batches, **jax_kw)
    np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(rec["accuracies"], accs, atol=1e-6)
    _close_to_jax(rec, jparams)


def test_zero_shards_state_and_consolidates_to_dp(gang2):
    """FSDP2 holds half of every parameter and moment on each rank (0.5 +-
    0.05, the twin of ``test_zero_shards_state_memory``); dp holds all;
    zero's consolidated checkpoint equals dp's params."""
    runs, _ = gang2
    for name in ("zero", "zero_remat_packed"):
        for rec in runs[name]:
            assert rec["shard_fraction"] == pytest.approx(0.5, abs=0.05)
    assert runs["dp"][0]["shard_fraction"] == 1.0
    dp, zero = _port_params(runs["dp"][0]), _port_params(runs["zero"][0])
    assert dp.keys() == zero.keys()
    for k in dp:
        torch.testing.assert_close(zero[k], dp[k], atol=2e-5, rtol=0)


def test_replicas_are_bit_equal_and_shardmap_matches_dp(gang2):
    """dp and shardmap leave the same bits on both ranks; the explicit
    uncompressed all-reduce equals DDP's within 2e-5, bf16 on the wire
    keeps the loss within 1e-3 relative (``test_shardmap_bf16_compression
    _close``)."""
    runs, _ = gang2
    for name in ("dp", "dp_packed", "shardmap", "shardmap_bf16", "remat"):
        d0, d1 = runs[name][0]["digests"]
        assert d0 == d1, name
    zd = runs["zero"][0]["digests"]
    assert zd[0] != zd[1]                        # each rank its own shard
    dp, sm = _port_params(runs["dp"][0]), _port_params(runs["shardmap"][0])
    for k in dp:
        torch.testing.assert_close(sm[k], dp[k], atol=2e-5, rtol=0)
    assert runs["shardmap"][0]["losses"][0] == pytest.approx(
        runs["dp"][0]["losses"][0], rel=1e-5)
    assert runs["shardmap_bf16"][0]["losses"][0] == pytest.approx(
        runs["dp"][0]["losses"][0], rel=1e-3)


def test_ranks_report_the_same_global_metrics(gang2):
    runs, _ = gang2
    for name, (r0, r1) in runs.items():
        assert r0["losses"] == r1["losses"], name
        assert r0["accuracies"] == r1["accuracies"], name


def test_four_rank_dp_matches_a_single_process():
    """A 4-rank dp gang against one process on the same 32-row batches."""
    batches = [fake_batch(32, seed=s) for s in (4, 5)]
    args = Args(device="cpu", **tiny_args())
    r0 = local.run_gang(
        local.train_global_batches, 4, args,
        {"runs": [{"name": "dp4"}], "vocab_size": VOCAB,
         "batches": batches, "eval_batch": batches[0]},
        timeout=GANG_TIMEOUT)[0][0]
    state = port_weights(VOCAB)
    step = steps.build_train_step(args, torch.device("cpu"))
    for b, got in zip(batches, r0["losses"]):
        m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert got == pytest.approx(float(m["loss"]), rel=1e-5)
    assert len(set(r0["digests"])) == 1
    pred, label, _ = r0["eval"]
    np.testing.assert_array_equal(label, batches[0]["label"])
    with torch.no_grad():
        want = state.model.classify(
            {k: torch.from_numpy(v) for k, v in batches[0].items()})
    np.testing.assert_array_equal(pred, want.argmax(-1).numpy())


# ----------------------------------------------------------------- remat


def _grads(remat, dropout, seed=9):
    """Gradients of one training forward of bert-tiny (plain attention,
    dropout drawn from the state's generator)."""
    args = Args(device="cpu", **tiny_args(dropout=dropout,
                                          attn_dropout=dropout, remat=remat))
    state = port_weights(VOCAB, dropout=dropout, attn_dropout=dropout)
    state.generator.manual_seed(seed)
    obj = steps.TrainObjective(state.model, args, torch.device("cpu"))
    batch = {k: torch.from_numpy(v) for k, v in fake_batch(8).items()}
    _, _, objective, _ = obj(batch, state.generator)
    objective.backward()
    after = state.generator.get_state()
    return {n: p.grad.clone() for n, p in state.model.named_parameters()}, \
        after


def test_remat_replays_the_dropout_generator():
    """Remat on against off at dropout 0.1 from the same generator seed:
    the recompute draws the forward's masks again (gradients within 1e-6)
    and leaves the generator where the forward left it."""
    on, state_on = _grads(True, 0.1)
    off, state_off = _grads(False, 0.1)
    for k in off:
        torch.testing.assert_close(on[k], off[k], atol=1e-6, rtol=0)
    assert torch.equal(state_on, state_off)


def test_remat_frees_activations():
    """The checkpointed layers keep only their inputs for the backward."""
    saved = {}
    for remat in (False, True):
        args = Args(device="cpu", **tiny_args(remat=remat))
        state = port_weights(VOCAB)
        obj = steps.TrainObjective(state.model, args, torch.device("cpu"))
        batch = {k: torch.from_numpy(v) for k, v in fake_batch(8).items()}
        n = [0]

        def pack(t):
            n[0] += t.numel()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            obj(batch, state.generator)
        saved[remat] = n[0]
    assert saved[True] < saved[False] / 2


def test_local_gang_reports_a_failing_rank():
    """A rank that raises stops the gang and surfaces its traceback."""
    args = Args(device="cpu", **tiny_args())
    with pytest.raises(RuntimeError, match="(?s)failed.*KeyError"):
        local.run_gang(local.train_global_batches, 2, args, {}, timeout=60)


def test_compute_grads_under_dp_match_jax(gang2):
    """``--grads_dtype compute`` at bf16 under dp over 2 ranks against
    JAX's dp step with the same setting on 2 devices, three steps: DDP's
    reduction is off and the step reduces the gradients itself, the
    matmul weights' bf16 gradients in bf16 on the wire.  Losses within
    2e-2 (bf16); the updates (end − start) by relative norm, at the
    single-device compute path's limits (``tests/test_torch_fuse.py``):
    whole tree 0.06, matmul weights 0.15, any leaf 0.4, the key biases
    (zero gradient) left out.  This test's readings (printed): 0.023,
    0.047 and 0.12."""
    runs, vocab = gang2
    rec, _ = runs["dp_compute"]
    losses, _, jparams, _ = jax_run(vocab, COMPUTE_BATCHES,
                                    dtype="bfloat16", grads_dtype="compute")
    np.testing.assert_allclose(rec["losses"], losses, atol=2e-2)
    model = port_weights(vocab).model
    start = {k: v.numpy() for k, v in model.state_dict().items()}
    got = {k: v.float().numpy() for k, v in _port_params(rec).items()}
    want = {k: v.float().numpy() for k, v in
            convert.from_jax_params(jparams).items()}
    mm = set(steps.matmul_weights(model))
    num = den = 0.0
    per = {}
    for k in start:
        if k.endswith(".k.bias"):
            continue
        dg, dw = got[k] - start[k], want[k] - start[k]
        per[k] = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        num += np.sum((dg - dw) ** 2)
        den += np.sum(dw ** 2)
    whole = np.sqrt(num / den)
    print(f"update vs JAX: whole {whole:.4f}, matmul "
          f"{max(per[k] for k in mm):.4f}, leaf {max(per.values()):.4f}")
    for k, e in per.items():
        assert e <= (0.15 if k in mm else 0.4), (k, e)
    assert whole <= 0.06
