"""Expert parallelism in the PyTorch port against the JAX package's ``ep``
mode (``pdnlp_tpu/parallel/sharding.py`` ``_ep_spec``,
``tests/test_moe.py:155``): gloo gangs on the CPU (bert-tiny-moe, 4
experts, grouped dispatch) at ``{"data": 1, "expert": 2}`` and ``{"data":
2, "expert": 2}``, each held to JAX's ep step on the same mesh and to JAX's
dp run from the same weights; and dp with the MoE model on two ranks.

Tolerances are JAX's: the loss to 1e-4 relative, the params to 3e-5.  Over
several data ranks the routing is the global batch's on both sides: the
aux's statistics, and the grouped dispatch's capacity and each
assignment's position in its expert, which the ranks before it push back.
The squeezed capacity factor (0.5) drops assignments, so a rank that sized
its slots from its own rows would show.  Each rank holds 2 of the 4 experts
of every layer; with dropout on, the weights an expert group replicates
stay bit-equal (the placement runs one thread a rank on the CPU).
"""
import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.parallel import local
from pdnlp_tpu_torch.utils.config import Args
from tests.test_torch_tp import (
    BATCHES, GANG_TIMEOUT, VOCAB, close_to_jax, global_batches, jax_run,
    port_params, tiny_args,
)

MOE = dict(model="bert-tiny-moe")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """As ``tests/test_torch_tp.py``'s: two intra-op threads here."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_gang(world, runs, tmp_path_factory, name):
    out = tmp_path_factory.mktemp(name)
    batches = global_batches()
    args = Args(device="cpu", **tiny_args(**MOE))
    res = local.run_gang(local.train_global_batches, world, args,
                         {"runs": runs, "vocab_size": VOCAB,
                          "batches": batches, "eval_batch": batches[0],
                          "out_dir": str(out)}, timeout=GANG_TIMEOUT)
    return {r["name"]: [res[k][i] for k in range(world)]
            for i, r in enumerate(res[0])}


@pytest.fixture(scope="module")
def ep2(tmp_path_factory):
    return run_gang(2, [
        {"name": "ep", "mode": "ep", "mesh_shape": {"data": 1, "expert": 2},
         "attention_impl": "pallas", "fused_ce": "pallas"},
        {"name": "ep_dropout", "mode": "ep", "dropout": 0.1,
         "mesh_shape": {"data": 1, "expert": 2}},
        {"name": "dp_squeezed", "mode": "dp", "moe_capacity_factor": 0.5}],
        tmp_path_factory, "ep2")


@pytest.fixture(scope="module")
def ep4(tmp_path_factory):
    return run_gang(4, [
        {"name": "ep", "mode": "ep", "mesh_shape": {"data": 2, "expert": 2}},
        {"name": "ep_squeezed", "mode": "ep", "moe_capacity_factor": 0.5,
         "mesh_shape": {"data": 2, "expert": 2}}], tmp_path_factory, "ep4")


@pytest.mark.parametrize("data,run,cf", [
    (1, "ep", None), (2, "ep", None), (2, "ep_squeezed", 0.5)])
def test_ep_matches_jax_ep_and_dp(ep2, ep4, data, run, cf):
    """3 steps of 16 rows at ``{"data": D, "expert": 2}``, grouped
    dispatch, against JAX's ep step on the same mesh and JAX's dp step on
    one device: losses rel 1e-4, consolidated params 3e-5; every rank
    reports the same losses; the eval gathers the global batch once."""
    ranks = (ep2 if data == 1 else ep4)[run]
    kw = dict(MOE) if cf is None else dict(MOE, moe_capacity_factor=cf)
    batches = global_batches()
    jl, jparams = jax_run(batches, "ep", {"data": data, "expert": 2}, **kw)
    dl, dparams = jax_run(batches, "dp", {"data": 1}, **kw)
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(r["losses"], jl, rtol=1e-4)
        np.testing.assert_allclose(r["losses"], dl, rtol=1e-4)
    params = port_params(ranks[0])
    close_to_jax(params, jparams, 3e-5)
    close_to_jax(params, dparams, 3e-5)
    pred, label, _ = ranks[0]["eval"]
    np.testing.assert_array_equal(label, batches[0]["label"])
    assert pred.shape == (16,)


def test_ep_shards_the_experts(ep2, ep4):
    """Each rank holds 2 of the 4 experts of every up/down stack (JAX
    ``_ep_spec``); the gate and the attention stay whole; the expert
    group's ranks hold different experts."""
    for ranks in (ep2["ep"], ep4["ep"]):
        for r in ranks:
            shapes = r["param_shapes"]
            assert shapes["layers.0.up.kernel"] == (2, 128, 512)
            assert shapes["layers.1.up.bias"] == (2, 512)
            assert shapes["layers.0.down.kernel"] == (2, 512, 128)
            assert shapes["layers.0.down.bias"] == (2, 128)
            assert shapes["layers.0.gate.kernel"] == (128, 4)
            assert shapes["layers.0.q.weight"] == (128, 128)
            assert 0.5 < r["shard_fraction"] < 1.0
        assert ranks[0]["digests"][0] != ranks[0]["digests"][1]
        # x and the combine weights in (backward), the partial combine out
        # (forward): three all-reduces a layer, every step
        assert ranks[0]["megatron"]["calls"] >= 3 * 2 * BATCHES


def test_dp_with_moe_routes_the_global_batch(ep2):
    """dp over two ranks with the MoE model at the squeezed capacity: the
    same function as JAX's dp step on a 2-device mesh and on one device
    (losses rel 1e-4, params 3e-5), the replicas bit-equal."""
    ranks = ep2["dp_squeezed"]
    kw = dict(MOE, moe_capacity_factor=0.5)
    batches = global_batches()
    for shape in ({"data": 2}, {"data": 1}):
        jl, jparams = jax_run(batches, "dp", shape, **kw)
        for r in ranks:
            np.testing.assert_allclose(r["losses"], jl, rtol=1e-4)
        close_to_jax(port_params(ranks[0]), jparams, 3e-5)
    assert ranks[0]["digests"][0] == ranks[0]["digests"][1]


def test_ep_dropout_keeps_the_expert_group_equal(ep2):
    r0, r1 = ep2["ep_dropout"]
    assert r0["replicated_digests"][0] == r0["replicated_digests"][1]
    assert r0["losses"] == r1["losses"]
    assert r0["losses"] != ep2["ep"][0]["losses"]
