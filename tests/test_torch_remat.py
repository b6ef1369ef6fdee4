"""Rematerialization (``--remat true``) in the port's train step on the CPU,
where a fused group runs its K steps one by one (the captured graph's
recompute is held to eager on the card, ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phases 8 and 17a):

- the dp step with remat against the same step without it, at dropout
  0.1 on the hidden states and the attention probabilities, eager and in
  fused groups, fp32 and bf16: losses, params, EMA and the dropout
  generator bit for bit — the recompute draws the forward's masks again
  and leaves the generator where the forward left it;
- ``--grads_dtype compute --remat true`` (refused before: the recompute
  was said to run on the fp32 weights) against JAX's same configuration
  at dropout 0, in the band of ``tests/test_torch_fuse.py``'s compute
  test (losses 2e-2, updates by relative norm: whole tree 0.06, matmul
  weights 0.15, any leaf 0.4), and against the port's compute step
  without remat bit for bit;
- zero's strategy keeps its ``--remat true`` default under
  ``--fuse_steps`` above 1, as ``multi-tpu-zero-cls.py`` does;
- the recompute's capture bookkeeping (``models.bert.remat_rng``) is per
  thread and nests.

Bit-for-bit comparisons run on one thread.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdnlp_tpu.train import steps as jsteps
from pdnlp_tpu.utils.config import Args as JArgs
from pdnlp_tpu_torch.models import bert
from pdnlp_tpu_torch.train import multi, steps
from pdnlp_tpu_torch.train.setup import setup_model
from pdnlp_tpu_torch.utils.config import Args
from tests.test_torch_fuse import (  # noqa: F401 (fixtures)
    VOCAB, _batches, _jax_state, _port_state, _stack, _torch,
    _update_rel_errors, one_thread, tiny_params,
)

CPU = torch.device("cpu")


def _train(args, batches, fuse):
    _, state = setup_model(args, VOCAB, total_steps=len(batches))
    step = steps.build_train_step(args, CPU)
    if fuse == 1:
        losses = [step(state, _torch(b))["loss"] for b in batches]
    else:
        run = steps.build_multi_step(step, CPU)
        losses = [run(state, _torch(_stack(batches[i:i + fuse])))["loss"]
                  for i in range(0, len(batches), fuse)]
    return state, torch.cat([x.reshape(-1) for x in losses])


@pytest.mark.parametrize("fuse", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_step_without_it_bit_for_bit(dtype, fuse):
    """The dp step with ``--remat true`` against ``--remat false`` from the
    same seed at dropout 0.1 (hidden and attention), four steps: losses,
    params, EMA and the generator's position bit for bit."""
    kw = dict(device="cpu", model="bert-tiny", dropout=0.1,
              attn_dropout=0.1, learning_rate=1e-3, ema_decay=0.9,
              dtype=dtype, fuse_steps=fuse)
    batches = _batches(seed=11)
    on, lon = _train(Args(remat=True, **kw), batches, fuse)
    off, loff = _train(Args(remat=False, **kw), batches, fuse)
    assert torch.equal(lon, loff)
    pon, poff = on.model.state_dict(), off.model.state_dict()
    assert all(torch.equal(pon[k], poff[k]) for k in poff)
    assert all(torch.equal(on.ema[k], off.ema[k]) for k in off.ema)
    assert torch.equal(on.generator.get_state(), off.generator.get_state())
    assert on.step == off.step == 4


def test_compute_grads_with_remat_match_jax(tiny_params):
    """``--grads_dtype compute --remat true`` under bf16 against JAX's
    compute path with remat (its kernels cast outside the grad, so the
    ``jax.checkpoint`` recompute sees bf16), three steps at dropout 0;
    the port's run also ends on its compute run without remat bit for
    bit (the recompute reads the bf16 casts the forward read)."""
    kw = dict(model="bert-tiny", dropout=0.0, attn_dropout=0.0,
              learning_rate=1e-3, dtype="bfloat16", grads_dtype="compute",
              ema_decay=0.5)
    batches = _batches(n=3, seed=7)
    jargs = JArgs(remat=True, **kw)
    jcfg, tx, jstate = _jax_state(tiny_params, jargs, 3, ema=True)
    jstep = jax.jit(jsteps.build_train_step(jcfg, tx, jargs))
    runs = {}
    for remat in (True, False):
        args = Args(device="cpu", remat=remat, **kw)
        state = _port_state(tiny_params, args, 3)
        step = steps.build_train_step(args, CPU)
        for b in batches:
            m = step(state, _torch(b))
            if remat:
                jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                            for k, v in b.items()})
                assert abs(float(m["loss"]) - float(jm["loss"])) <= 2e-2
        runs[remat] = state
    got, want = runs[True].model.state_dict(), runs[False].model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    mm = set(steps.matmul_weights(runs[True].model))
    for got, want in ((runs[True].model.state_dict(), jstate["params"]),
                      (runs[True].ema, jstate["ema"])):
        per, whole = _update_rel_errors(got, want, tiny_params)
        print(f"update vs JAX: whole {whole:.4f}, matmul "
              f"{max(per[k] for k in mm):.4f}, leaf {max(per.values()):.4f}")
        assert whole <= 0.06, whole
        for k, e in per.items():
            assert e <= (0.15 if k in mm else 0.4), (k, e)


@pytest.mark.parametrize("argv,remat", [
    (["--strategy", "zero", "--fuse_steps", "4"], True),
    (["--strategy", "zero", "--fuse_steps", "4", "--remat", "false"], False),
    (["--strategy", "dp", "--fuse_steps", "4", "--remat", "true"], True)])
def test_fused_strategies_keep_remat(argv, remat):
    """zero's strategy default ``--remat true`` holds at K = 4 (JAX's
    ``multi-tpu-zero-cls.py`` runs remat at every K); an explicit flag
    still wins."""
    args, _ = multi.parse(argv)
    assert args.remat is remat and args.fuse_steps == 4


def test_remat_rng_is_per_thread_and_nests():
    """The capture's recompute states reach ``_remat`` through a per-thread
    slot: a gang's rank on another thread sees none, an inner block's
    states give way to the outer's when it ends."""
    outer, inner = bert.RematRng(["a"]), bert.RematRng(["b"])
    seen = []
    with bert.remat_rng(outer):
        with bert.remat_rng(inner):
            seen.append(bert._REMAT.rng)
        seen.append(bert._REMAT.rng)
        t = threading.Thread(
            target=lambda: seen.append(getattr(bert._REMAT, "rng", None)))
        t.start()
        t.join()
    seen.append(bert._REMAT.rng)
    assert seen == [inner, outer, None, None]
    assert inner.states == ["b"] and inner.offsets == []
