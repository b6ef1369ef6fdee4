"""K-step fusion in the PyTorch port (``train.steps.build_multi_step``) on the CPU,
where the K steps run one by one — the plain version of the captured CUDA
graph (held against it on the card in ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 8a):

- four fused bert-tiny steps against JAX's ``build_multi_step`` (a
  ``lax.scan``) from the same weights on the same batches, at dropout 0
  (the two frameworks' dropout streams differ), with a warmup schedule;
- with dropout on, the fused call equals four single steps bit for bit
  (the twin of ``tests/test_fuse.py:14``);
- the Trainer fuses with a remainder and covers every batch once, a bucket
  boundary never stacks two widths, the K rates a group feeds equal
  ``LambdaLR``'s step by step, and a resume step inside a group raises
  JAX's error;
- the EMA against the JAX step's ``ema`` tree, and ``grads_dtype
  compute`` against JAX's compute path at bf16.

Tolerances: the fp32 steps are held as ``tests/test_torch_train.py`` holds
three (losses 1e-5, params 2e-6: fp32 sums in another order through
Adam's divide by sqrt(v) + 1e-6), four steps here; the EMA tracks the
params (3e-6).  The bf16 compute path is held to 2e-2 on the losses and
compares the updates by relative norm, at limits set from readings (see
the test): bf16 rounding of the activations in two frameworks, and the
second moment of a bf16 gradient squared in bf16 by JAX and in fp32 here
(``train/steps.py``).  Bit-for-bit comparisons run on one thread.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.data import pipeline as jpipeline
from pdnlp_tpu.models import bert as jbert
from pdnlp_tpu.models import get_config as jax_get_config
from pdnlp_tpu.train import optim as joptim
from pdnlp_tpu.train import steps as jsteps
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.models import convert
from pdnlp_tpu_torch.train import optim, steps
from pdnlp_tpu_torch.train.setup import setup_data, setup_model
from pdnlp_tpu_torch.train.trainer import Trainer
from pdnlp_tpu_torch.utils.config import Args

VOCAB = 120
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny_params():
    jcfg = jax_get_config("bert-tiny", vocab_size=VOCAB)
    return jax.tree_util.tree_map(
        np.asarray, jbert.init_params(jax.random.key(0), jcfg))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: bit-for-bit comparisons need it (the CPU
    backward with several threads differs run to run in the last bit),
    and bert-tiny needs no more beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _batches(n=4, B=8, S=32, seed=0):
    """Padded batches with a filler row each (all-zero mask, weight 0)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.zeros((B, S), np.int32)
        for b in range(B - 1):
            mask[b, : r.randint(4, S + 1)] = 1
        out.append({
            "input_ids": (r.randint(5, VOCAB, (B, S)) * mask).astype(np.int32),
            "token_type_ids": np.zeros((B, S), np.int32),
            "attention_mask": mask,
            "label": r.randint(0, 6, B).astype(np.int32),
            "example_weight": (np.arange(B) < B - 1).astype(np.float32),
        })
    return out


def _stack(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _jax_state(tiny_params, jargs, total, ema=False):
    jcfg = jax_get_config("bert-tiny", vocab_size=VOCAB).replace(
        dropout=0.0, attn_dropout=0.0)
    tx = joptim.build_optimizer(tiny_params, jargs,
                                schedule=joptim.make_schedule(jargs, total))
    state = jsteps.init_state(
        jax.random.key(0), jcfg, tx, rng=jax.random.key(1), ema=ema,
        params=jax.tree_util.tree_map(jnp.asarray, tiny_params))
    return jcfg, tx, state


def _port_state(tiny_params, args, total):
    _, state = setup_model(args, VOCAB, total_steps=total)
    state.model.load_state_dict(convert.from_jax_params(tiny_params))
    if state.ema is not None:
        state.ema = steps.init_ema(state.model)
    return state


def _assert_tree_close(got_sd, want_tree, atol):
    got = convert.to_jax_params(got_sd)
    want = jax.tree_util.tree_map(np.asarray, want_tree)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want)):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), atol=atol,
                                   err_msg=str(path))


def test_multi_step_matches_jax_make_multi_step(tiny_params):
    """Four fused steps: the port's ``build_multi_step`` (K steps in order)
    against JAX's scanned ``build_multi_step``, losses and accuracies
    stacked ``[K]`` as the scan returns them, params at the end."""
    kw = dict(model="bert-tiny", dropout=0.0, attn_dropout=0.0,
              learning_rate=1e-3, lr_schedule="warmup_linear",
              warmup_ratio=0.3, fuse_steps=4)
    batches = _batches()
    jargs = JArgs(**kw)
    jcfg, tx, jstate = _jax_state(tiny_params, jargs, 10)
    jmulti = jax.jit(jsteps.build_multi_step(
        jsteps.build_train_step(jcfg, tx, jargs)))
    jstate, jm = jmulti(jstate, {k: jnp.asarray(v)
                                 for k, v in _stack(batches).items()})
    args = Args(device="cpu", **kw)
    state = _port_state(tiny_params, args, 10)
    multi = steps.build_multi_step(steps.build_train_step(args, CPU), CPU)
    m = multi(state, _torch(_stack(batches)))
    assert m["loss"].shape == (4,) and m["accuracy"].shape == (4,)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               atol=1e-5)
    np.testing.assert_allclose(m["accuracy"].numpy(),
                               np.asarray(jm["accuracy"]), atol=1e-6)
    _assert_tree_close(state.model.state_dict(), jstate["params"], 2e-6)
    assert state.step == 4 and state.scheduler.last_epoch == 4


def test_fused_equals_sequential_bitwise():
    """With dropout on, one fused call of four steps is four single steps,
    bit for bit: losses, params and the generator's position."""
    args = Args(device="cpu", model="bert-tiny", dropout=0.1,
                attn_dropout=0.1, fuse_steps=4, learning_rate=1e-3)
    batches = _batches(seed=3)
    _, s1 = setup_model(args, VOCAB)
    step = steps.build_train_step(args, CPU)
    seq = [step(s1, _torch(b))["loss"] for b in batches]
    _, s2 = setup_model(args, VOCAB)
    multi = steps.build_multi_step(steps.build_train_step(args, CPU), CPU)
    m = multi(s2, _torch(_stack(batches)))
    assert torch.equal(torch.stack(seq), m["loss"])
    p1, p2 = s1.model.state_dict(), s2.model.state_dict()
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert torch.equal(s1.generator.get_state(), s2.generator.get_state())


def _tiny_trainer(corpus_path, tmp_path, **kw):
    kw = {"max_seq_len": 16, "fuse_steps": 4, **kw}
    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                data_limit=420,
                log_every=10 ** 6, vocab_path=str(tmp_path / "v.txt"),
                output_dir=str(tmp_path / "out"), **kw)
    train_loader, dev_loader, tok = setup_data(args)
    cfg, state = setup_model(args, tok.vocab_size,
                             total_steps=len(train_loader))
    trainer = Trainer(args, cfg, state, steps.build_train_step(args, CPU),
                      steps.build_eval_step(args), CPU)
    return trainer, train_loader


def _recording(trainer):
    """Wrap the trainer's steps to record ``(n, fused, width)`` per call."""
    calls = []
    single, multi = trainer.train_step, trainer.multi_step

    def one(state, batch):
        calls.append((1, False, int(batch["input_ids"].shape[-1])))
        return single(state, batch)

    class Multi:
        stage, graphs = multi.stage, multi.graphs

        def __call__(self, state, batch):
            calls.append((int(batch["input_ids"].shape[0]), True,
                          int(batch["input_ids"].shape[-1])))
            return multi(state, batch)

    trainer.train_step, trainer.multi_step = one, Multi()
    return calls


def test_trainer_fuses_with_remainder(corpus_path, tmp_path):
    """The Trainer groups K batches and runs the remainder step by step;
    the epoch covers every batch once (``tests/test_fuse.py:34``)."""
    trainer, loader = _tiny_trainer(corpus_path, tmp_path)
    calls = _recording(trainer)
    trainer.train(loader)
    n = len(loader)
    assert sum(c[0] for c in calls) == n and trainer.state.step == n
    assert [c[0] for c in calls] == [4] * (n // 4) + [1] * (n % 4)
    assert n % 4 and trainer.state.scheduler is None


@pytest.mark.parametrize("fuse", [1, 4])
def test_probe_leaves_the_trained_state_unchanged(corpus_path, tmp_path,
                                                  capsys, fuse):
    """``--probe_steps 3`` runs its steps on the live state and puts it
    back: the run ends bit for bit where a run without the probe ends —
    params, AdamW's state, the EMA, the scheduler and the dropout
    generator — with a schedule and dropout on, so a rate or a generator
    left advanced would show."""
    kw = dict(fuse_steps=fuse, dropout=0.1, attn_dropout=0.1,
              lr_schedule="warmup_linear", learning_rate=1e-3,
              ema_decay=0.9)
    runs = []
    for probe in (0, 3):
        trainer, loader = _tiny_trainer(corpus_path, tmp_path / str(probe),
                                        probe_steps=probe, **kw)
        trainer.train(loader)
        runs.append(trainer.state)
    assert "probe steps/s" in capsys.readouterr().out
    a, b = runs
    assert a.step == b.step == len(loader)
    for got, want in ((b.model.state_dict(), a.model.state_dict()),
                      (b.ema, a.ema)):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(x, y) for x, y in
               zip(steps.state_tensors(b), steps.state_tensors(a)))
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    assert b.scheduler.state_dict() == a.scheduler.state_dict()
    assert [g["lr"] for g in b.optimizer.param_groups] == \
        [g["lr"] for g in a.optimizer.param_groups]


def test_bucket_boundary_never_stacks_mixed_widths(corpus_path, tmp_path):
    """Under bucket mode a group holds one width: the Trainer's calls are
    JAX's ``host_macro_batches`` cut of the same epoch (a width change
    flushes a partial run as single steps)."""
    trainer, loader = _tiny_trainer(corpus_path, tmp_path,
                                    length_mode="bucket", max_seq_len=32,
                                    length_buckets="16,32")
    calls = _recording(trainer)
    trainer.train(loader)
    loader.set_epoch(0)
    want = [(n, fused, int(b["input_ids"].shape[-1])) for b, n, fused, _ in
            jpipeline.host_macro_batches(list(loader), 4)]
    assert calls == want
    assert {w for _, f, w in calls if f} == {16, 32}
    assert any(not f for _, f, _ in calls[:-1])      # a flushed partial run


@pytest.mark.parametrize("name", ["warmup_linear", "warmup_cosine"])
def test_group_rates_equal_lambdalr_step_by_step(name):
    """The rates a captured group is fed (``optim.group_lrs``) are the
    ones ``LambdaLR`` sets update by update, for both groups; moving the
    schedule on by K (``advance_schedule``) is K scheduler steps."""
    args = Args(lr_schedule=name, learning_rate=5e-5, warmup_ratio=0.2)
    total, k = 23, 4
    opt_a, sched_a = optim.build_optimizer(torch.nn.Linear(2, 2), args,
                                           total)
    opt_b, sched_b = optim.build_optimizer(torch.nn.Linear(2, 2), args,
                                           total)
    for start in range(0, total, k):
        rows = optim.group_lrs(sched_a, k)
        assert len(rows) == k + 1
        for i in range(k + 1):
            assert rows[i] == [g["lr"] for g in opt_b.param_groups], \
                (start, i)
            if i < k:
                opt_b.step()
                sched_b.step()
        optim.advance_schedule(sched_a, k)
        assert sched_a.last_epoch == sched_b.last_epoch
        assert sched_a.get_last_lr() == sched_b.get_last_lr()


def test_resume_inside_a_group_raises(corpus_path, tmp_path):
    """A restored step that falls inside a fused group is refused with
    JAX's error: running the group would re-apply updates the restored
    state holds."""
    trainer, loader = _tiny_trainer(corpus_path, tmp_path)
    trainer.state.step = 2
    with pytest.raises(ValueError, match=re.escape(
            "resume step 2 is not a fused-group boundary under "
            "fuse_steps=4 (group covers steps 1..4)")):
        trainer.train(loader)


def test_ema_matches_jax(tiny_params):
    """The port's EMA against the JAX step's ``ema`` tree over three
    bert-tiny steps at dropout 0 (``pdnlp_tpu/train/steps.py:205-214``)."""
    kw = dict(model="bert-tiny", dropout=0.0, attn_dropout=0.0,
              learning_rate=1e-3, ema_decay=0.9)
    batches = _batches(n=3, seed=5)
    jargs = JArgs(**kw)
    jcfg, tx, jstate = _jax_state(tiny_params, jargs, 3, ema=True)
    jstep = jax.jit(jsteps.build_train_step(jcfg, tx, jargs))
    args = Args(device="cpu", **kw)
    state = _port_state(tiny_params, args, 3)
    step = steps.build_train_step(args, CPU)
    for b in batches:
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        step(state, _torch(b))
    _assert_tree_close(state.ema, jstate["ema"], 3e-6)
    _assert_tree_close(state.model.state_dict(), jstate["params"], 2e-6)
    assert steps.ema_coefficients(0.9) == (float(np.float32(0.9)), float(
        np.float32(1.0) - np.float32(0.9)))


def _update_rel_errors(got_sd, want_tree, start_tree):
    """Per leaf, ``|Δgot − Δwant| / |Δwant|`` with ``Δ = end − start``
    (the update the steps made, not the weights, which hide it), and the
    same over the whole tree.  The attention key biases are left out:
    softmax is blind to a shift along the keys, so their gradient is 0 and
    their update is rounding noise in both frameworks."""
    got = {k: v.numpy() for k, v in got_sd.items()}
    want = {k: v.float().numpy() for k, v in convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, want_tree)).items()}
    start = {k: v.numpy() for k, v in
             convert.from_jax_params(start_tree).items()}
    keys = [k for k in got if not k.endswith(".k.bias")]
    dg = {k: got[k] - start[k] for k in keys}
    dw = {k: want[k] - start[k] for k in keys}
    per = {k: float(np.linalg.norm(dg[k] - dw[k]) / np.linalg.norm(dw[k]))
           for k in keys}
    whole = float(np.sqrt(sum(np.sum((dg[k] - dw[k]) ** 2) for k in keys)
                          / sum(np.sum(dw[k] ** 2) for k in keys)))
    return per, whole


def test_compute_grads_match_jax_at_bf16(tiny_params, monkeypatch):
    """``--grads_dtype compute`` under bf16 against JAX's compute path over
    three steps, with the EMA.

    What the setting changes is where the matmul weights' gradients
    materialize: in bf16 leaves cast outside autograd
    (``steps.matmul_weights``), whose gradients are widened for AdamW.
    The forward is the same bits under both settings (JAX's own comment,
    ``pdnlp_tpu/train/steps.py:170-177``), and the widened bf16 gradient
    is what the ``param`` path's cast hands back, so in the port the two
    settings train to the same bits: the numbers cannot tell them apart,
    and the test checks the leaves instead — every step of the compute
    path makes bf16 leaves with bf16 gradients, the ``param`` path makes
    none.

    Against JAX, the updates (end − start) are compared by relative norm.
    This test's readings (printed; params / EMA): whole tree 0.026 /
    0.029, matmul weights at most 0.053 / 0.061, any leaf at most 0.18 /
    0.21 (an MLP bias): bf16 rounding of the activations in two
    frameworks, and JAX squaring the bf16 gradient in bf16 for Adam's
    second moment where the port squares the widened one.  Limits are
    about twice those: 0.06, 0.15 and 0.4.  A port that dropped half the
    update reads 0.5 whole."""
    kw = dict(model="bert-tiny", dropout=0.0, attn_dropout=0.0,
              learning_rate=1e-3, dtype="bfloat16", grads_dtype="compute",
              ema_decay=0.5)
    batches = _batches(n=3, seed=7)
    jargs = JArgs(**kw)
    jcfg, tx, jstate = _jax_state(tiny_params, jargs, 3, ema=True)
    jstep = jax.jit(jsteps.build_train_step(jcfg, tx, jargs))
    leaves = []
    real = torch.func.functional_call

    def spy(module, tensors, *a, **k):
        leaves.append(tensors)
        return real(module, tensors, *a, **k)

    monkeypatch.setattr(torch.func, "functional_call", spy)
    runs = {}
    for mode in ("param", "compute"):
        args = Args(device="cpu", **{**kw, "grads_dtype": mode})
        state = _port_state(tiny_params, args, 3)
        step = steps.build_train_step(args, CPU)
        params = dict(state.model.named_parameters())
        leaves.clear()
        for i, b in enumerate(batches):
            m = step(state, _torch(b))
            if mode == "param":
                continue
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            assert abs(float(m["loss"]) - float(jm["loss"])) <= 2e-2
            assert len(leaves) == i + 1
            names = steps.matmul_weights(state.model)
            assert sorted(leaves[i]) == sorted(f"model.{n}" for n in names)
            for n in names:
                g = leaves[i][f"model.{n}"].grad
                assert g.dtype == torch.bfloat16, n
                assert params[n].grad.dtype == torch.float32
                assert torch.equal(params[n].grad, g.float()), n
        if mode == "param":
            assert not leaves
        runs[mode] = state
    assert steps.compute_grads(args)
    assert not steps.compute_grads(args.replace(dtype="float32"))
    assert len(steps.matmul_weights(state.model)) == 6 * 2 + 2
    sp, sc = runs["param"], runs["compute"]
    for got, want in ((sc.model.state_dict(), sp.model.state_dict()),
                      (sc.ema, sp.ema)):
        assert all(torch.equal(got[k], want[k]) for k in want)
    mm = set(steps.matmul_weights(sc.model))
    for got, want in ((sc.model.state_dict(), jstate["params"]),
                      (sc.ema, jstate["ema"])):
        per, whole = _update_rel_errors(got, want, tiny_params)
        print(f"update vs JAX: whole {whole:.4f}, matmul "
              f"{max(per[k] for k in mm):.4f}, leaf {max(per.values()):.4f}")
        assert whole <= 0.06, whole
        for k, e in per.items():
            assert e <= (0.15 if k in mm else 0.4), (k, e)
    # with --remat the recompute reads the bf16 casts the forward read:
    # the same bits as the compute path without it
    args = args.replace(remat=True)
    state = _port_state(tiny_params, args, 3)
    step = steps.build_train_step(args, CPU)
    for b in batches:
        step(state, _torch(b))
    got, want = state.model.state_dict(), sc.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
