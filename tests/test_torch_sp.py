"""Sequence parallelism in the PyTorch port against the JAX package's
(``pdnlp_tpu/ops/ring.py``, ``pdnlp_tpu/parallel/sp.py``; the twins of
``tests/test_sp.py`` and ``tests/test_longcontext.py:350, 377``), on gloo
gangs of real ranks on the CPU (``parallel.local.run_gang``, bert-tiny):

- ``ring_attention`` over seq groups of 2 and 4 ranks against JAX's
  ``ring_attention`` on seq meshes of the suite's virtual devices, with and
  without a key bias and in the packed layout: outputs within 2e-5, the
  gradients of q, k and v within 5e-5 (``tests/test_flash.py``'s bounds);
- attention dropout in the ring: the mean of 400 draws within 0.12 of the
  undropped output (``test_sp.py:82``);
- the sp train step at ``{"data": 1, "seq": 2}`` and ``{"data": 2, "seq":
  2}`` against JAX's sp step on the same mesh and JAX's single-device
  step, from the same weights (the port's seeded init, carried to JAX by
  ``models.convert``): loss rel 1e-5, params atol 2e-5, the eval step's
  labels the global batch's;
- ``bert-tiny-long`` at a global length of 512 over a seq group of 4
  against the single-device step (``test_sp.py:194-217``), and the packed
  sp step at ``{"data": 2, "seq": 2}`` against JAX's packed single-device
  step (``test_longcontext.py:377``).

Inputs come from a numpy seed; dropout is 0 except in the dropout test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pdnlp_tpu.data.packing import pack_id_lists
from pdnlp_tpu.ops.attention import dot_product_attention, mask_bias
from pdnlp_tpu.ops.ring import ring_attention as jax_ring
from pdnlp_tpu.parallel import make_mesh as jax_make_mesh
from pdnlp_tpu.parallel.compat import shard_map
from pdnlp_tpu.parallel.sp import (
    make_sp_batch, make_sp_eval_step as jax_sp_eval, make_sp_train_step,
)
from pdnlp_tpu.train.setup import setup_model as jax_setup_model
from pdnlp_tpu.train.steps import make_train_step
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.parallel import local
from pdnlp_tpu_torch.train import setup
from pdnlp_tpu_torch.utils.config import Args

S, V = 32, 100
LR = 1e-3
GANG_TIMEOUT = 300
STEPS = 2


def sp_args(**kw):
    base = dict(model="bert-tiny", max_seq_len=S, dropout=0.0,
                attn_dropout=0.0, learning_rate=LR)
    base.update(kw)
    return base


def make_batch(n=16, seed=0, seq=S, full_mask=False):
    r = np.random.RandomState(seed)
    b = {
        "input_ids": r.randint(0, V, (n, seq)).astype(np.int32),
        "token_type_ids": np.zeros((n, seq), np.int32),
        "attention_mask": (np.ones((n, seq)) if full_mask
                           else (r.rand(n, seq) > 0.1)).astype(np.int32),
        "label": r.randint(0, 6, (n,)).astype(np.int32),
        "example_weight": np.ones((n,), np.float32),
    }
    b["attention_mask"][:, 0] = 1
    return b


def small_segments(B, Sg, seed=0, pad=8):
    r = np.random.RandomState(seed)
    seg = np.zeros((B, Sg), np.int32)
    for b in range(B):
        pos, sid = 0, 0
        while pos < Sg - pad:
            ln = r.randint(6, 28)
            sid += 1
            seg[b, pos: pos + ln] = sid
            pos += ln
    return seg


def packed_batch():
    """Two packed 64-wide rows whose segments cross the seq shards'
    boundaries (``test_longcontext.py:377``'s)."""
    r = np.random.RandomState(5)
    lists = [list(r.randint(5, 99, r.randint(8, 30))) for _ in range(10)]
    pb, _ = pack_id_lists(lists, 64, rows=2, max_segments=8)
    M = pb["cls_positions"].shape[1]
    pb = dict(pb)
    pb["label"] = r.randint(0, 6, (2, M)).astype(np.int32)
    w = np.zeros((2, M), np.float32)
    w[(pb["segment_ids"].max(1)[:, None]
       > np.arange(M)[None, :]).nonzero()] = 1.0
    pb["example_weight"] = w
    return {k: np.asarray(v) for k, v in pb.items()}


def ring_cases(n):
    r = np.random.RandomState(1)
    B, Sq, N, D = 2, 8 * n, 2, 16
    q, k, v = (r.randn(B, Sq, N, D).astype(np.float32) for _ in range(3))
    mask = (r.rand(B, Sq) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    bias = ((1.0 - mask) * -1e9).astype(np.float32)
    seg = small_segments(B, Sq, seed=4)
    return {"bias": dict(q=q, k=k, v=v, bias=bias),
            "nobias": dict(q=q, k=k, v=v, bias=None),
            "packed": dict(q=q, k=k, v=v, seg=seg)}


def drop_case(n):
    r = np.random.RandomState(3)
    B, Sq, N, D = 2, 4 * n, 2, 8
    return {k: r.randn(B, Sq, N, D).astype(np.float32) for k in "qkv"}


def _slice(a, rank, n):
    w = a.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(
        a[:, rank * w:(rank + 1) * w]))


def _sp_gang(rank, world, args, payload):
    """This rank's side of every check: the ring on a ``{"seq": world}``
    group (outputs and the q/k/v gradients of the summed squares), the
    dropout draws, then the train runs on their meshes."""
    import torch.distributed as dist

    from pdnlp_tpu_torch.ops.ring import ring_attention
    from pdnlp_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(shape={"seq": world}, device_type="cpu")
    group = mesh.get_group("seq")
    out = {"ring": {}}
    for name, c in payload["ring"].items():
        q, k, v = (_slice(c[x], rank, world).requires_grad_()
                   for x in "qkv")
        bias = None if c.get("bias") is None else _slice(c["bias"], rank,
                                                         world)
        seg = None if c.get("seg") is None else _slice(c["seg"], rank, world)
        o = ring_attention(q, k, v, bias, group, segment_ids=seg)
        (o ** 2).sum().backward()
        out["ring"][name] = [t.detach().numpy() for t in
                             (o, q.grad, k.grad, v.grad)]
    d = payload["drop"]
    q, k, v = (_slice(d[x], rank, world) for x in "qkv")
    gen = torch.Generator().manual_seed(1000 + rank)
    base = ring_attention(q, k, v, None, group).numpy()
    same = np.array_equal(ring_attention(q, k, v, None, group,
                                         dropout_rate=0.3).numpy(), base)
    acc, first = np.zeros_like(base), None
    for i in range(payload["draws"]):
        a = ring_attention(q, k, v, None, group, dropout_rate=0.3,
                           generator=gen).numpy()
        first = a if first is None else first
        acc += a
    out["drop"] = {"base": base, "no_generator_same": same,
                   "first": first, "mean": acc / payload["draws"]}
    dist.barrier()
    out["runs"] = local.train_global_batches(rank, world, args,
                                             payload["train"])
    return out


class _Started:
    """A gang running on a thread while the test process compiles JAX's
    side: ``get()`` waits for it (``tests/test_torch_pp.py`` uses it too)."""

    def __init__(self, fn):
        import threading

        self.box = {}

        def run():
            try:
                self.box["value"] = fn()
            except BaseException as e:  # re-raised by get()
                self.box["error"] = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def get(self):
        self.thread.join(timeout=2 * GANG_TIMEOUT)
        if "error" in self.box:
            raise self.box["error"]
        return self.box["value"]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """One gang of 2 and one of 4 ranks, each running every port-side
    check of this module (rank 0 writes each run's weights), started at
    once; the tests compute JAX's side while they run."""
    def payload(n, runs):
        out = str(tmp_path_factory.mktemp(f"sp{n}"))
        return {"ring": ring_cases(n), "drop": drop_case(n), "draws": 400,
                "train": {"runs": runs, "vocab_size": V, "out_dir": out}}

    args = Args(device="cpu", **sp_args())
    padded = [make_batch(seed=s) for s in range(STEPS)]
    long_batch = [make_batch(n=4, seed=3, seq=512, full_mask=True)]
    two = payload(2, [
        {"name": "sp12", "mode": "sp", "mesh_shape": {"data": 1, "seq": 2},
         "batches": padded, "eval_batch": padded[0]}])
    four = payload(4, [
        {"name": "sp22", "mode": "sp", "mesh_shape": {"data": 2, "seq": 2},
         "batches": padded, "eval_batch": padded[0]},
        {"name": "long", "mode": "sp", "model": "bert-tiny-long",
         "max_seq_len": 512, "mesh_shape": {"data": 1, "seq": 4},
         "batches": long_batch},
        {"name": "packed", "mode": "sp", "max_seq_len": 64,
         "mesh_shape": {"data": 2, "seq": 2},
         "batches": [packed_batch()] * 2}])
    gangs = {n: _Started(lambda n=n, p=p: local.run_gang(
        _sp_gang, n, args, p, timeout=GANG_TIMEOUT))
        for n, p in ((2, two), (4, four))}
    yield gangs
    for g in gangs.values():
        g.thread.join(timeout=2 * GANG_TIMEOUT)


@pytest.fixture(scope="module")
def gangs(started):
    return {n: g.get() for n, g in started.items()}


def port_weights(**kw):
    _, state = setup.setup_model(Args(device="cpu", **sp_args(**kw)), V)
    return state.model.state_dict()


def jax_state(args, **kw):
    cfg, tx, state = jax_setup_model(args, V)
    state["params"] = jax.tree_util.tree_map(
        jnp.asarray, convert.to_jax_params(port_weights(**kw)))
    return cfg, tx, state


def close_to_jax(params, jparams, atol):
    got = convert.to_jax_params(params)
    lg = jax.tree_util.tree_leaves_with_path(got)
    lw = jax.tree_util.tree_leaves_with_path(jparams)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, g), (_, w) in zip(lg, lw):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol,
                                   err_msg=str(path))


def _run(gang, name):
    return next(r for r in gang[0]["runs"] if r["name"] == name)


def _params(gang, name):
    """Run ``name``'s weights after its steps (rank 0's checkpoint: every
    rank of an sp run holds the whole model)."""
    return torch.load(_run(gang, name)["checkpoint"],
                      weights_only=True)["state_dict"]


@pytest.mark.parametrize("shape", [{"data": 1, "seq": 2},
                                   {"data": 2, "seq": 2}])
def test_sp_step_matches_jax_sp_and_single(started, jax_single, shape):
    """Two steps of 16 rows at ``shape`` against JAX's sp step on the same
    mesh and JAX's single-device step: loss rel 1e-5, params 2e-5; every
    rank holds the same weights; the eval step echoes the global labels."""
    name = "sp12" if shape["data"] == 1 else "sp22"
    jargs = JArgs(**sp_args())
    batches = [make_batch(seed=seed) for seed in range(STEPS)]
    single_losses, single_params = jax_single
    cfg, tx2, st2 = jax_state(jargs)
    mesh = jax_make_mesh(shape=shape)
    put = make_sp_batch(mesh)
    step = make_sp_train_step(cfg, tx2, jargs, mesh)(batches[0])
    sp_losses = []
    for b in batches:
        st2, m2 = step(st2, put(b))
        sp_losses.append(float(m2["loss"]))
    jem = jax_sp_eval(cfg, jargs, mesh)(batches[0])(st2["params"],
                                                    put(batches[0]))
    gang = started[2 if shape["data"] == 1 else 4].get()
    rec = _run(gang, name)
    np.testing.assert_allclose(rec["losses"], single_losses, rtol=1e-5)
    np.testing.assert_allclose(rec["losses"], sp_losses, rtol=1e-5)
    assert len(set(rec["digests"])) == 1
    params = _params(gang, name)
    close_to_jax(params, single_params, 2e-5)
    close_to_jax(params, jax.device_get(st2["params"]), 2e-5)
    pred, label, ew = rec["eval"]
    np.testing.assert_array_equal(label, batches[0]["label"])
    assert pred.shape == (16,) and ew.sum() == 16
    np.testing.assert_array_equal(pred, np.asarray(jem["pred"]))


@pytest.fixture(scope="module")
def jax_single():
    """JAX's single-device step on the padded batches from the port's
    weights: (losses, final params)."""
    jargs = JArgs(**sp_args())
    cfg, tx, st = jax_state(jargs)
    single = jax.jit(make_train_step(cfg, tx, jargs))
    losses = []
    for seed in range(STEPS):
        st, m = single(st, {k: jnp.asarray(v) for k, v in
                            make_batch(seed=seed).items()})
        losses.append(float(m["loss"]))
    return losses, jax.device_get(st["params"])


def _joined(ranks, name, i):
    return np.concatenate([r["ring"][name][i] for r in ranks], axis=1)


def _jax_ring(n, c):
    mesh = jax_make_mesh(shape={"seq": n})
    spec = P(None, "seq")
    q, k, v = (jnp.asarray(c[x]) for x in "qkv")
    if "seg" in c:
        seg = jnp.asarray(c["seg"])

        def f(q, k, v):
            return shard_map(
                lambda q, k, v, s: jax_ring(q, k, v, None, axis_name="seq",
                                            segment_ids=s),
                mesh=mesh, in_specs=(spec,) * 4, out_specs=spec,
                check_vma=False)(q, k, v, seg)
    else:
        b = jnp.zeros(q.shape[:2], jnp.float32) if c["bias"] is None \
            else jnp.asarray(c["bias"])

        def f(q, k, v):
            return shard_map(
                lambda q, k, v, b: jax_ring(q, k, v, b, axis_name="seq"),
                mesh=mesh, in_specs=(spec,) * 4, out_specs=spec,
                check_vma=False)(q, k, v, b)
    out = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: (f(q, k, v) ** 2).sum(),
                             argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", ["bias", "nobias", "packed"])
def test_ring_attention_matches_jax_ring(gangs, n, case):
    """The port's ring over ``n`` ranks = JAX's ring over ``n`` devices:
    outputs 2e-5, gradients 5e-5; both equal the plain full-length
    attention (the reference the JAX tests hold)."""
    c = ring_cases(n)[case]
    want = _jax_ring(n, c)
    got = [_joined(gangs[n], case, i) for i in range(4)]
    np.testing.assert_allclose(got[0], want[0], atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=5e-5)
    q, k, v = (jnp.asarray(c[x]) for x in "qkv")
    if case == "packed":
        ref = dot_product_attention(q, k, v, impl="xla",
                                    segment_ids=jnp.asarray(c["seg"]))
    else:
        mask = jnp.ones(q.shape[:2], jnp.int32) if c["bias"] is None \
            else jnp.asarray((c["bias"] == 0).astype(np.int32))
        ref = dot_product_attention(q, k, v, mask_bias(mask), impl="xla")
    np.testing.assert_allclose(got[0], np.asarray(ref), atol=2e-5)


def test_ring_refuses_bias_and_segments():
    from pdnlp_tpu_torch.ops.ring import ring_attention

    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="bias_local OR segment_ids"):
        ring_attention(x, x, x, torch.zeros(1, 4), None,
                       segment_ids=torch.ones(1, 4, dtype=torch.int32))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_dropout_is_unbiased(gangs, n):
    """Attention dropout in the ring: a rate without a generator is a
    no-op; a draw differs from the undropped output; the mean of 400
    draws is within 0.12 of it (the numerator-masked online softmax is
    unbiased; JAX's bound)."""
    base = np.concatenate([r["drop"]["base"] for r in gangs[n]], axis=1)
    first = np.concatenate([r["drop"]["first"] for r in gangs[n]], axis=1)
    mean = np.concatenate([r["drop"]["mean"] for r in gangs[n]], axis=1)
    assert all(r["drop"]["no_generator_same"] for r in gangs[n])
    assert not np.allclose(first, base, atol=1e-3)
    np.testing.assert_allclose(mean, base, atol=0.12)


def test_sp_long_sequence_matches_single_device(gangs):
    """``bert-tiny-long`` at a global 512 over 4 seq ranks (128 each) =
    the single-device full-attention step (rel 1e-5, params 2e-5); the
    base config refuses the same global length."""
    rec = _run(gangs[4], "long")
    jargs = JArgs(**sp_args(model="bert-tiny-long", max_seq_len=512))
    batch = make_batch(n=4, seed=3, seq=512, full_mask=True)
    cfg, tx, st = jax_state(jargs, model="bert-tiny-long", max_seq_len=512)
    st, m = jax.jit(make_train_step(cfg, tx, jargs))(
        st, {k: jnp.asarray(v) for k, v in batch.items()})
    assert rec["losses"][0] == pytest.approx(float(m["loss"]), rel=1e-5)
    close_to_jax(_params(gangs[4], "long"),
                 jax.device_get(st["params"]), 2e-5)


def test_sp_packed_step_matches_single_device(gangs):
    """Packed rows whose segments cross the shards, at ``{"data": 2,
    "seq": 2}``: two steps against JAX's packed single-device step (each
    loss within 2e-6, JAX's bound; params 2e-5)."""
    rec = _run(gangs[4], "packed")
    jargs = JArgs(**sp_args(max_seq_len=64))
    pb = packed_batch()
    cfg, tx, st = jax_state(jargs, max_seq_len=64)
    single = jax.jit(make_train_step(cfg, tx, jargs))
    for i in range(2):
        st, m = single(st, {k: jnp.asarray(v) for k, v in pb.items()})
        assert abs(rec["losses"][i] - float(m["loss"])) < 2e-6
        assert abs(rec["accuracies"][i] - float(m["accuracy"])) < 2e-6
    close_to_jax(_params(gangs[4], "packed"),
                 jax.device_get(st["params"]), 2e-5)


def test_sp_refusals():
    """JAX's refusals on the sp path: MoE layers, the EMA, a mesh without
    a seq axis, and a global length past the position table."""
    from pdnlp_tpu_torch.models.config import get_config
    from pdnlp_tpu_torch.parallel.execution import check_sp
    from pdnlp_tpu_torch.parallel.sharding import check_mesh

    a = Args(**sp_args())
    with pytest.raises(ValueError, match="MoE layers are not supported"):
        check_sp(a, get_config("bert-tiny-moe"))
    with pytest.raises(ValueError, match="--ema_decay"):
        check_sp(a.replace(ema_decay=0.9), get_config("bert-tiny"))
    with pytest.raises(ValueError, match="sp needs a 'seq' mesh axis"):
        check_mesh("sp", {"data": 2})
    with pytest.raises(ValueError, match="also needs a 'data'"):
        check_mesh("sp", {"seq": 2})
    # the base config refuses a length its position table does not hold
    from pdnlp_tpu_torch.models.bert import BertClassifier

    model = BertClassifier(get_config("bert-tiny", vocab_size=V))
    long = {k: torch.from_numpy(v) for k, v in
            make_batch(n=2, seq=512, full_mask=True).items()}
    with pytest.raises(ValueError, match="max_position"):
        model.classify(long)
