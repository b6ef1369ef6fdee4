"""Resume snapshots and the checkpoint durability protocol of the PyTorch
port, on the CPU — the twins of ``tests/test_resume.py`` and of the
unit cases of ``tests/test_chaos.py``:

- interrupt-and-resume equals an uninterrupted run bit for bit (params,
  AdamW's state, the schedule, the dropout generator and the EMA round-trip
  through the file), through the Trainer and through ``train.single``'s
  resume flags, and for the ``dp`` and ``zero`` strategies in 2-rank gloo
  gangs (``parallel.local.run_gang``; under ``zero`` the state is
  consolidated at the save and resharded at the load);
- the async writer never blocks, keeps one write in flight, surfaces
  errors, and writes nothing on a rank other than 0;
- a corrupt file falls back to ``.prev``, an undecodable manifest routes
  to the fallback, a torn publish keeps the good ``.prev``, a checksum
  mismatch is caught, a shape mismatch is not called corruption;
- the profiler window and ``StepStats``;
- one snapshot format for every mode: each mode's snapshot resumes under
  the others, held to the file and to JAX's restore (ROADMAP C4).

Bit-for-bit comparisons run on one intra-op thread (the CPU backward with
several threads differs run to run in the last bit).
"""
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.train.async_ckpt import AsyncCheckpointer
from pdnlp_tpu_torch.train.setup import setup_model
from pdnlp_tpu_torch.train.steps import build_train_step
from pdnlp_tpu_torch.train.trainer import Trainer
from pdnlp_tpu_torch.utils.config import Args

VOCAB = 120
CPU = torch.device("cpu")
GANG_TIMEOUT = 600


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


def _batches(n, B=8, S=32, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        mask = np.zeros((B, S), np.int32)
        for b in range(B):
            mask[b, : r.randint(4, S + 1)] = 1
        out.append({k: torch.from_numpy(v) for k, v in {
            "input_ids": (r.randint(5, VOCAB, (B, S)) * mask).astype(np.int32),
            "token_type_ids": np.zeros((B, S), np.int32),
            "attention_mask": mask,
            "label": r.randint(0, 6, B).astype(np.int32),
            "example_weight": np.ones(B, np.float32)}.items()})
    return out


def _args(**kw):
    kw = {"ema_decay": 0.9, **kw}
    return Args(device="cpu", model="bert-tiny", dropout=0.1,
                attn_dropout=0.1, learning_rate=1e-3,
                lr_schedule="warmup_linear", **kw)


def _equal_params(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def test_resume_is_bitwise(tmp_path):
    """2 steps + save + restore into a fresh state + 2 steps == 4 steps
    straight, with dropout on, a schedule and an EMA (twin of
    ``tests/test_resume.py:30``); the manifest carries the step."""
    args = _args()
    batches = _batches(4)
    _, straight = setup_model(args, VOCAB, total_steps=4)
    step = build_train_step(args, CPU)
    for b in batches:
        step(straight, b)

    _, half = setup_model(args, VOCAB, total_steps=4)
    for b in batches[:2]:
        step(half, b)
    path = str(tmp_path / "resume.pt")
    Trainer(args, None, half, step, None, CPU).save_resume(path)
    assert ckpt.load_manifest(path)["meta"] == {"step": 2}

    _, fresh = setup_model(args, VOCAB, total_steps=4)
    t = Trainer(args, None, fresh, step, None, CPU)
    t.load_resume(path)
    assert t.state.step == 2 and t.state.scheduler.last_epoch == 2
    for b in batches[2:]:
        step(t.state, b)
    assert _equal_params(straight, t.state)
    assert all(torch.equal(straight.ema[k], t.state.ema[k])
               for k in straight.ema)
    assert torch.equal(straight.generator.get_state(),
                       t.state.generator.get_state())
    assert t.state.step == 4


def test_single_resume_flags_are_bitwise(corpus_path, tmp_path, capsys):
    """``train.single --resume_every 4`` over 8 steps, then a run with
    ``--resume_from`` the step-4 snapshot (retained as ``.prev`` when step
    8's was published) trains steps 5-8 to the same final weights, bit for
    bit, at ``--fuse_steps`` 1 and 2; a snapshot from another steps-per-
    epoch resumes with its step remapped by epoch fraction, as JAX's
    ``Trainer._remap_elastic_width`` does (4 of 8 -> 8 of 16)."""
    from pdnlp_tpu_torch.train import single

    vocab = str(tmp_path / "vocab.txt")
    for fuse in (1, 2):
        base = _args(data_path=corpus_path, vocab_path=vocab,
                     data_limit=140, train_batch_size=16, fuse_steps=fuse)
        a1 = base.replace(output_dir=str(tmp_path / f"a{fuse}"),
                          resume_every=4)
        single.main(a1)
        snap = a1.resume_path()
        assert ckpt.load_manifest(ckpt.prev_path(snap))["meta"] == {
            "step": 4, "steps_per_epoch": 8}
        copy = str(tmp_path / f"step4_{fuse}.pt")
        shutil.copyfile(ckpt.prev_path(snap), copy)
        shutil.copyfile(ckpt.manifest_path(ckpt.prev_path(snap)),
                        ckpt.manifest_path(copy))
        a2 = base.replace(output_dir=str(tmp_path / f"b{fuse}"),
                          resume_from=copy)
        single.main(a2)
        w1 = torch.load(a1.ckpt_path(), weights_only=True)["state_dict"]
        w2 = torch.load(a2.ckpt_path(), weights_only=True)["state_dict"]
        assert all(torch.equal(w1[k], w2[k]) for k in w1), fuse
    capsys.readouterr()
    single.main(base.replace(output_dir=str(tmp_path / "c"),
                             train_batch_size=8, resume_from=copy))
    out = capsys.readouterr().out
    assert "elastic resume: remapped step 4 (of 8/epoch at save time) -> 8 " \
        "(of 16/epoch at this width)" in out
    assert "step：16/16" in out


def _resume_gang(rank, world, args, payload):
    """One rank: train 4 steps snapshotting every 2, then a second trainer
    resumed from the step-2 snapshot trains steps 3-4; rank 0 returns
    whether the two runs' consolidated weights are bit-equal."""
    from pdnlp_tpu_torch.parallel import collectives
    from pdnlp_tpu_torch.train.run import build_parallel_trainer, try_resume

    torch.set_num_threads(1)                 # bit for bit on the CPU
    mode, d = payload["mode"], payload["dir"]
    a1 = args.replace(output_dir=os.path.join(d, "full"), resume_every=2)
    t1, loader, _ = build_parallel_trainer(a1, mode=mode)
    t1.train(loader)
    full = ckpt.consolidate(t1.state.model)
    copy = os.path.join(d, "step2.pt")
    if rank == 0:
        snap = a1.resume_path()
        shutil.copyfile(ckpt.prev_path(snap), copy)
        shutil.copyfile(ckpt.manifest_path(ckpt.prev_path(snap)),
                        ckpt.manifest_path(copy))
    collectives.barrier()
    a2 = args.replace(output_dir=os.path.join(d, "resumed"), resume_from=copy)
    t2, loader2, _ = build_parallel_trainer(a2, mode=mode)
    try_resume(t2, a2)
    assert t2.state.step == 2
    t2.train(loader2)
    resumed = ckpt.consolidate(t2.state.model)
    if rank != 0:
        return None
    return {"steps": t2.state.step,
            "equal": all(torch.equal(full[k], resumed[k]) for k in full),
            "keys": len(full)}


@pytest.mark.parametrize("mode", ["dp", "zero"])
def test_strategy_resume_is_bitwise_in_a_gang(corpus_path, tmp_path, mode):
    """dp (DDP) and zero (ZeRO-3) at two gloo ranks: a run resumed from the
    step-2 snapshot ends on the uninterrupted run's weights, bit for bit
    (every rank's dropout generator and, under zero, the resharded params
    and moments come back from the one consolidated file)."""
    from pdnlp_tpu_torch.data.tokenizer import get_or_build_vocab
    from pdnlp_tpu_torch.parallel import local

    args = _args(data_path=corpus_path, vocab_path=str(tmp_path / "v.txt"),
                 data_limit=70, train_batch_size=8, max_seq_len=16,
                 strategy=mode, mode=mode, dist_backend="gloo",
                 ema_decay=0.0)
    get_or_build_vocab(args)
    res = local.run_gang(_resume_gang, 2, args,
                         {"mode": mode, "dir": str(tmp_path)},
                         timeout=GANG_TIMEOUT)
    assert res[0] == {"steps": 4, "equal": True, "keys": res[0]["keys"]}
    assert res[0]["keys"] > 10


# ----------------------------------------------------------- async writer


def test_async_checkpointer_never_blocks_and_publishes(tmp_path,
                                                       monkeypatch):
    """submit() returns while the publish is held; one write in flight; a
    same-path re-submit supersedes the queued one; wait() drains and the
    file verifies (twin of ``tests/test_chaos.py:39``)."""
    gate = threading.Event()
    entered = threading.Event()
    concurrent = []
    real_publish = ckpt.publish

    def gated_publish(path, data, meta=None):
        concurrent.append(1)
        assert sum(concurrent) == 1, "more than one save in flight"
        entered.set()
        assert gate.wait(10)
        try:
            real_publish(path, data, meta=meta)
        finally:
            concurrent.pop()

    monkeypatch.setattr(ckpt, "publish", gated_publish)
    w = AsyncCheckpointer(process_index=0)
    path = str(tmp_path / "snap.pt")
    w.submit(path, {"x": torch.ones(4)}, meta={"step": 1})
    assert entered.wait(10)
    assert not os.path.exists(path)
    w.submit(path, {"x": torch.full((4,), 2.0)}, meta={"step": 2})
    w.submit(path, {"x": torch.full((4,), 3.0)}, meta={"step": 3})
    assert w.stats()["superseded"] == 1
    gate.set()
    assert w.wait(timeout=30)
    assert w.stats()["published"] == 2
    ok, reason = ckpt.verify(path)
    assert ok, reason
    assert ckpt.load_manifest(path)["meta"] == {"step": 3}
    assert torch.equal(ckpt.load_raw(path)["x"], torch.full((4,), 3.0))


def test_async_checkpointer_surfaces_write_errors(tmp_path, monkeypatch):
    def broken_publish(path, data, meta=None):
        raise OSError("disk on fire")

    monkeypatch.setattr(ckpt, "publish", broken_publish)
    w = AsyncCheckpointer(process_index=0)
    w.submit(str(tmp_path / "a.pt"), {"x": torch.ones(2)})
    deadline = time.time() + 10
    while not w.stats()["errors"] and time.time() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="async checkpoint publish"):
        w.submit(str(tmp_path / "b.pt"), {"x": torch.ones(2)})


def test_async_checkpointer_nonzero_rank_never_writes(tmp_path):
    w = AsyncCheckpointer(process_index=1)
    w.submit(str(tmp_path / "r1.pt"), {"x": torch.ones(2)})
    assert w.wait(timeout=5)
    assert not os.path.exists(tmp_path / "r1.pt")
    assert w.stats()["submitted"] == 0


def test_in_loop_snapshot_pays_only_the_host_copy(tmp_path, monkeypatch):
    """The trainer's in-loop snapshot hands host copies to the writer and
    returns before the write: the live state may move on meanwhile."""
    args = _args()
    _, state = setup_model(args, VOCAB, total_steps=4)
    t = Trainer(args, None, state, build_train_step(args, CPU), None, CPU)
    gate = threading.Event()
    real_publish = ckpt.publish
    monkeypatch.setattr(ckpt, "publish", lambda p, d, meta=None: (
        gate.wait(10), real_publish(p, d, meta=meta)))
    path = str(tmp_path / "loop.pt")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    t._snapshot_resume(path)
    assert not os.path.exists(path)
    t.train_step(state, _batches(1)[0])          # the state moves on
    gate.set()
    t._ckpt_writer.wait(timeout=30)
    saved, meta, _ = ckpt.load_state(path)
    assert meta == {"step": 0}
    assert all(torch.equal(saved["model"][k], before[k]) for k in before)


# ------------------------------------------------- publish and fallback


def test_corrupt_checkpoint_falls_back_to_previous_snapshot(tmp_path, capfd):
    path = str(tmp_path / "state.pt")
    ckpt.save(path, {"w": torch.arange(6.0)}, meta={"step": 2})
    ckpt.save(path, {"w": torch.arange(6.0) * 10}, meta={"step": 4})
    with open(path, "r+b") as f:
        f.truncate(8)
    assert torch.equal(ckpt.load(path)["w"], torch.arange(6.0))
    assert "falling back" in capfd.readouterr().err
    lone = str(tmp_path / "lone.pt")
    ckpt.save(lone, {"w": torch.ones(3)})
    with open(lone, "r+b") as f:
        f.truncate(4)
    with pytest.raises(ckpt.CorruptCheckpointError, match="manifest"):
        ckpt.load(lone)


def test_corrupt_manifest_json_routes_to_fallback_not_crash(tmp_path):
    path = str(tmp_path / "mrot.pt")
    ckpt.save(path, {"w": torch.zeros(4)})
    ckpt.save(path, {"w": torch.ones(4)})
    with open(ckpt.manifest_path(path), "w") as f:
        f.write("{not json")
    ok, reason = ckpt.verify(path)
    assert not ok and "manifest" in reason
    assert torch.equal(ckpt.load(path)["w"], torch.zeros(4))


def test_torn_publish_never_destroys_the_good_prev(tmp_path):
    """New bytes under the old manifest (a crash between the two writes):
    the next publish must not retain that pair as ``.prev``."""
    path = str(tmp_path / "torn.pt")
    ckpt.save(path, {"w": torch.zeros(4)})
    with open(path, "wb") as f:
        f.write(ckpt.encode(path, {"w": torch.ones(4)}))
    ckpt._published_crc.clear()   # the restarted process trusts nothing
    assert not ckpt.verify(path)[0]
    assert not os.path.exists(ckpt.prev_path(path))
    ckpt.save(path, {"w": torch.full((4,), 3.0)})
    assert ckpt.verify(path)[0]
    assert not os.path.exists(ckpt.prev_path(path))
    ckpt.save(path, {"w": torch.full((4,), 4.0)})
    assert ckpt.verify(ckpt.prev_path(path))[0]


def test_checksum_mismatch_detected_not_just_truncation(tmp_path):
    path = str(tmp_path / "flip.pt")
    ckpt.save(path, {"w": torch.zeros(64)})
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\xff\xff")
    ok, reason = ckpt.verify(path)
    assert not ok and "crc32" in reason


def test_shape_mismatch_is_not_corruption(tmp_path):
    """A template mismatch raises ValueError (another model), never falls
    back to ``.prev``."""
    from pdnlp_tpu_torch.models.bert import BertClassifier
    from pdnlp_tpu_torch.models.config import get_config

    path = str(tmp_path / "tmpl.pt")
    model = BertClassifier(get_config("bert-tiny", vocab_size=VOCAB))
    for _ in range(2):                       # .prev now exists
        ckpt.save_params(path, model.state_dict(), model_name="bert-tiny",
                         vocab_size=VOCAB)
    other = BertClassifier(get_config("bert-tiny", vocab_size=VOCAB + 8))
    with pytest.raises(ValueError, match="does not match"):
        ckpt.load_params(path, other.state_dict())


def test_latest_orders_a_step_family_by_step(tmp_path):
    for step in (5, 40, 100):
        ckpt.save(str(tmp_path / f"ckpt-{step}.pt"), {"s": step})
    os.utime(tmp_path / "ckpt-5.pt", (2e9, 2e9))       # newest mtime
    assert ckpt.latest(str(tmp_path)).endswith("ckpt-100.pt")
    assert ckpt.latest(str(tmp_path / "none")) is None


# ------------------------------------------------------------- profiling


def test_profiler_writes_trace(tmp_path):
    """``--profile_dir`` writes a trace of the window (twin of
    ``tests/test_resume.py:104``); a dispatch that jumps the window opens
    it for the next one."""
    from pdnlp_tpu_torch.utils.profiling import Profiler

    d = str(tmp_path / "trace")
    p = Profiler(d, start_step=1, num_steps=1)
    x = torch.ones(64, 64)
    p.step(1)
    assert p.active
    x @ x
    p.step(2)
    assert not p.active and os.path.exists(p.path)
    found = [f for _, _, fs in os.walk(d) for f in fs]
    assert found == ["trace_proc0.pt.trace.json"]
    jump = Profiler(str(tmp_path / "jump"), start_step=2, num_steps=2)
    jump.step(8)                       # one K-step dispatch over the window
    assert jump.active
    jump.step(12)
    assert not jump.active and os.path.exists(jump.path)


def test_step_stats_rates():
    from pdnlp_tpu.utils.profiling import StepStats as JStepStats
    from pdnlp_tpu_torch.utils.profiling import StepStats

    s = StepStats(steps=288, examples=9200, minutes=0.5)
    assert s.steps_per_second == pytest.approx(9.6)
    assert s.examples_per_second == pytest.approx(306.67, rel=1e-3)
    assert "steps/s" in s.line()
    assert s.line() == JStepStats(288, 9200, 0.5).line()
    assert StepStats(0, 0, 0.0).line() == JStepStats(0, 0, 0.0).line()


# ------------------------------------------- one snapshot format (C4)

#: each placement a snapshot is written or resumed under: name -> (mode,
#: mesh), for the dense model and for the MoE model
CROSS_DENSE = {"single": ("single", None), "dp": ("dp", {"data": 2}),
               "tp": ("tp", {"data": 1, "model": 2}),
               "zero": ("zero", {"data": 2}), "pp": ("pp", {"stage": 2}),
               "zero4": ("zero", {"data": 2})}
#: sources and resumes run at ``--fuse_steps`` 4: zero's step in the
#: K-step dispatch a CUDA graph captures on the card
CROSS_FUSED = {"zero4": 4}
CROSS_MOE = {"ep": ("ep", {"data": 1, "expert": 2}),
             "zero": ("zero", {"data": 2}), "pp": ("pp", {"stage": 2})}
#: (snapshot, resume) pairs: single, dp, tp and ep snapshots under zero
#: and pp, and zero and pp snapshots under dp, tp and ep ("legacy" is
#: the single snapshot in the index-keyed format written before); zero's
#: snapshots at ``--fuse_steps`` 4 ("zero4") under dp, zero and pp, and
#: dp's and zero's under it
CROSS_PAIRS = {
    "bert-tiny": [(s, t) for s in ("single", "legacy", "dp", "tp")
                  for t in ("zero", "pp")]
    + [(s, t) for s in ("zero", "pp") for t in ("dp", "tp")]
    + [("zero4", "dp"), ("zero4", "zero"), ("zero4", "pp"),
       ("dp", "zero4"), ("zero", "zero4")],
    "bert-tiny-moe": [("ep", "zero"), ("ep", "pp"), ("zero", "ep"),
                      ("pp", "ep")]}


def _cross_trainer(args, mode, mesh):
    from pdnlp_tpu_torch.train.run import (
        build_parallel_trainer, build_pipeline_trainer, build_single_trainer,
    )

    if mode == "single":
        return build_single_trainer(args)
    a = args.replace(mode=mode, mesh_shape=mesh)
    if mode == "pp":
        return build_pipeline_trainer(a)
    return build_parallel_trainer(a, mode=mode)


def _cross_gang(rank, world, args, payload):
    """Every source mode of each model trains 2 steps and snapshots; every
    resume mode loads each snapshot its pairs name onto a fresh state and
    gathers it back whole: (params, AdamW's state by name, step), which
    rank 0 returns with the snapshots' own values."""
    from pdnlp_tpu_torch.parallel import collectives
    from pdnlp_tpu_torch.train.trainer import _host_copy

    torch.set_num_threads(1)
    d = payload["dir"]
    out = {}
    for model, modes in (("bert-tiny", CROSS_DENSE),
                         ("bert-tiny-moe", CROSS_MOE)):
        pairs = CROSS_PAIRS[model]
        margs = args.replace(model=model)
        paths = {}
        for src in dict.fromkeys(s for s, _ in pairs):
            if src == "legacy":
                continue
            mode, mesh = modes[src]
            t, loader, _ = _cross_trainer(
                margs.replace(fuse_steps=CROSS_FUSED.get(src, 1)), mode,
                mesh)
            for batch in list(loader)[:2]:
                t.train_step(t.state, t.put(batch))
            paths[src] = os.path.join(d, f"{model}-{src}.pt")
            t.save_resume(paths[src])
            if src == "single":
                # the format before: AdamW's state_dict, keyed by index
                legacy = t._resume_payload()
                legacy["optimizer"] = _host_copy(
                    t.state.optimizer.state_dict())
                paths["legacy"] = os.path.join(d, f"{model}-legacy.pt")
                if rank == 0:
                    ckpt.save_state(paths["legacy"], legacy,
                                    meta={"step": 2})
            collectives.barrier()
        for dst in dict.fromkeys(t for _, t in pairs):
            mode, mesh = modes[dst]
            t, _, _ = _cross_trainer(
                margs.replace(fuse_steps=CROSS_FUSED.get(dst, 1)), mode,
                mesh)
            for src in [s for s, x in pairs if x == dst]:
                t.load_resume(paths[src])
                got = {"params": ckpt.consolidate(t.state.model),
                       "optim": t._named_optimizer_state()["state"],
                       "step": t.state.step}
                if rank == 0:
                    raw, _, _ = ckpt.load_state(paths[src])
                    out[(model, src, dst)] = _numpy(
                        {"got": got, "raw": raw})
            collectives.barrier()
    return out if rank == 0 else None


def _numpy(obj):
    """``obj`` with its tensors as numpy arrays (what leaves a gang)."""
    if torch.is_tensor(obj):
        return obj.detach().numpy().copy()
    if isinstance(obj, dict):
        return {k: _numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy(v) for v in obj)
    return obj


def _equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _moments(optim, names):
    from pdnlp_tpu_torch.train.trainer import index_to_names

    state = index_to_names(optim, names)["state"]
    return {m: {n: state[n][m] for n in names}
            for m in ("exp_avg", "exp_avg_sq")}


def _jax_restores(corpus_path, vocab, work, snapshots):
    """JAX's restore of each snapshot's values under zero (2 virtual
    devices) and pp at ``{"stage": 2}``: the values are put in a JAX
    train state, saved with JAX's ``save_resume`` and loaded by a zero
    and a pp trainer (``Trainer.load_resume``); their (params, mu, nu,
    count) as the port's state dict names."""
    import jax
    import optax

    from pdnlp_tpu.train.run import (
        build_parallel_trainer, build_pipeline_trainer,
    )
    from pdnlp_tpu.utils.config import Args as JArgs
    from pdnlp_tpu_torch.models import convert

    out = {}
    for model in ("bert-tiny", "bert-tiny-moe"):
        base = JArgs(strategy="dp", data_path=corpus_path, vocab_path=vocab,
                     output_dir=str(work), model=model, data_limit=70,
                     max_seq_len=16, train_batch_size=8, dropout=0.0,
                     attn_dropout=0.0)
        jt = {"zero": build_parallel_trainer(base.replace(num_devices=2),
                                             mode="zero")[0],
              "pp": build_pipeline_trainer(base.replace(
                  mode="pp", mesh_shape={"stage": 2}))[0]}
        for (m, src), (params, moments, step) in snapshots.items():
            if m != model:
                continue
            live = jt["zero"].state
            adam = live["opt_state"][0]
            state = {"params": convert.to_jax_params(params),
                     "opt_state": (adam._replace(
                         count=np.asarray(step, np.int32),
                         mu=convert.to_jax_params(moments["exp_avg"]),
                         nu=convert.to_jax_params(moments["exp_avg_sq"])),
                     ) + tuple(live["opt_state"][1:]),
                     "rng": live["rng"], "step": np.asarray(step, np.int32)}
            path = str(work / f"{model}-{src}.msgpack")
            jt["zero"].state, keep = state, jt["zero"].state
            jt["zero"].save_resume(path)
            jt["zero"].state = keep
            for dst, t in jt.items():
                t.load_resume(path)
                got = jax.device_get(t.state)
                adam = next(x for x in got["opt_state"]
                            if isinstance(x, optax.ScaleByAdamState))
                back = {k: convert.from_jax_params(
                    jax.tree_util.tree_map(np.asarray, tree))
                    for k, tree in (("params", got["params"]),
                                    ("exp_avg", adam.mu),
                                    ("exp_avg_sq", adam.nu))}
                out[(model, src, dst)] = (back, int(adam.count))
    return out


def test_every_mode_resumes_every_other_mode(corpus_path, tmp_path):
    """One snapshot format for every mode (ROADMAP C4): bert-tiny
    snapshots of single, dp and tp (and the single one in the index-keyed
    format written before) resume under zero and under pp at ``{"stage":
    2}``, zero and pp ones under dp and tp, zero's at ``--fuse_steps`` 4
    under dp, zero and pp, and dp's and zero's under it, and
    bert-tiny-moe's ep ones under zero and pp and back, in two-rank gloo
    gangs.  Each resumed
    state, gathered whole, holds the snapshot's params, AdamW moments and
    step bit for bit, as JAX's restore of the same values does on its
    virtual devices (``Trainer.load_resume`` under zero and pp, compared
    bit for bit too)."""
    from pdnlp_tpu_torch.data.tokenizer import get_or_build_vocab
    from pdnlp_tpu_torch.parallel import local

    vocab = str(tmp_path / "v.txt")
    args = _args(data_path=corpus_path, vocab_path=vocab, data_limit=70,
                 train_batch_size=8, max_seq_len=16, dist_backend="gloo",
                 ema_decay=0.0, pipeline="sync",
                 output_dir=str(tmp_path / "out")).replace(
        dropout=0.0, attn_dropout=0.0)
    get_or_build_vocab(args)
    res = local.run_gang(_cross_gang, 2, args, {"dir": str(tmp_path)},
                         timeout=GANG_TIMEOUT)[0]
    assert len(res) == sum(len(p) for p in CROSS_PAIRS.values())
    snaps = {}
    for (model, src, dst), r in res.items():
        raw, got = r["raw"], r["got"]
        names = list(raw["model"])
        want = _moments(raw["optimizer"], names)
        assert got["step"] == raw["step"] == 2, (model, src, dst)
        assert all(_equal(got["params"][k], raw["model"][k])
                   for k in names), (model, src, dst)
        for m, tree in want.items():
            assert all(_equal(got["optim"][n][m], tree[n])
                       for n in names), (model, src, dst, m)
        if dst in ("zero", "pp"):
            snaps[(model, src)] = (
                {k: torch.from_numpy(v) for k, v in raw["model"].items()},
                {m: {n: torch.from_numpy(v) for n, v in tree.items()}
                 for m, tree in want.items()}, raw["step"])
    # the legacy file holds the single snapshot's state, in the old format
    single = res[("bert-tiny", "single", "zero")]
    assert all(_equal(res[("bert-tiny", "legacy", t)]["got"]["optim"][n][m],
                      single["got"]["optim"][n][m])
               for t in ("zero", "pp") for n in single["raw"]["model"]
               for m in ("exp_avg", "exp_avg_sq"))
    jax_res = _jax_restores(corpus_path, vocab, tmp_path, snaps)
    assert len(jax_res) == 2 * len(snaps)
    for (model, src, dst), (back, count) in jax_res.items():
        got = res[(model, src, dst)]["got"]
        assert count == got["step"]
        for n, v in back["params"].items():
            assert _equal(got["params"][n], v), (model, src, dst, n)
        for m in ("exp_avg", "exp_avg_sq"):
            for n, v in back[m].items():
                assert _equal(got["optim"][n][m], v), (src, dst, m, n)
