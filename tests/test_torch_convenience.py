"""The managed trainers of the PyTorch port — ``Accelerator`` and
``AutoTrainer`` — a twin of each test of ``tests/test_convenience.py``,
on the CPU with bert-tiny and the ``corpus_path`` corpus, plus
``AutoTrainer``'s per-step losses against JAX's ``AutoTrainer`` on the same
``TrainerArgs`` from the same weights.

Multi-rank cases (``prepare`` under two processes, ``mode="zero"``) run in
2-rank gloo gangs (``parallel.local.run_gang``).  Tolerances: the
accelerator's step loss against the framework's own dp step, rel 1e-5 (the
JAX test's); fused against unfused runs, and a resumed run against an
uninterrupted one, bit for bit on one intra-op thread (the CPU backward
with several threads differs in the last bit run to run); the per-step
losses against JAX's, 1e-5 (``tests/test_torch_train.py::
test_train_steps_match_jax``'s bound).
"""
import json
import os

import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.data.pipeline import to_device
from pdnlp_tpu_torch.train.accel import Accelerator
from pdnlp_tpu_torch.train.auto import AutoTrainer, TrainerArgs
from pdnlp_tpu_torch.utils.config import Args

VOCAB = 100
SEQ = 16
CPU = torch.device("cpu")
GANG_TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tiny_args(**kw):
    base = dict(device="cpu", model="bert-tiny", max_seq_len=SEQ,
                train_batch_size=4, dropout=0.0, attn_dropout=0.0)
    base.update(kw)
    return Args(**base)


def fake_batch(n, seed=0):
    r = np.random.RandomState(seed)
    return {
        "input_ids": r.randint(0, VOCAB, (n, SEQ)).astype(np.int32),
        "token_type_ids": np.zeros((n, SEQ), np.int32),
        "attention_mask": np.ones((n, SEQ), np.int32),
        "label": r.randint(0, 6, (n,)).astype(np.int32),
        "example_weight": np.ones((n,), np.float32),
    }


def managed(corpus_path, tmp_path, name, **kw):
    base = dict(output_dir=str(tmp_path / name), model="bert-tiny",
                data_path=corpus_path, data_limit=400, max_seq_len=16,
                logging_steps=10 ** 6, num_train_epochs=1, device="cpu",
                vocab_path=str(tmp_path / "vocab.txt"))
    base.update(kw)
    return TrainerArgs(**base)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ----------------------------------------------------------- Accelerator


def test_accelerator_prepare_and_step():
    """The user's single-device pieces after ``prepare``: the step's loss
    equals the framework's own dp step's (rel 1e-5), and the eval step
    returns every example's prediction."""
    from pdnlp_tpu_torch.parallel.execution import (
        make_parallel_train_step, setup_sharded_model,
    )
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_eval_step, build_train_step

    args = tiny_args()
    batch = to_device(fake_batch(32), CPU)
    acc = Accelerator(args)
    assert acc.num_devices == 1 and acc.is_main_process
    _, state = setup_model(args, VOCAB)
    (state,) = acc.prepare(state)
    step = acc.compile_step(build_train_step(args, CPU))
    m = step(state, batch)
    _, ref = setup_sharded_model(args, VOCAB, acc.mesh, "dp")
    ref_m = make_parallel_train_step(args, acc.mesh, CPU)(ref, batch)
    assert float(m["loss"]) == pytest.approx(float(ref_m["loss"]), rel=1e-5)
    ev = acc.compile_eval(build_eval_step(args, forward=state.objective))
    em = acc.gather(ev(state.model, None, batch))
    assert em["pred"].shape == (32,)
    fresh = Accelerator(args)
    with pytest.raises(RuntimeError, match="prepare"):
        fresh.compile_step(build_train_step(args, CPU))
    assert TrainerArgs().device == "cuda" and Args().device == "cuda"
    if not torch.cuda.is_available():     # cuda by default, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            setup_model(tiny_args(device="cuda"), VOCAB)


def _accel_gang(rank, world, args, payload):
    """Rank ``rank`` of an accelerated 2-rank run: the prepared loaders'
    lengths and first-batch rows, and the global loss of one step on this
    rank's block of the global batch."""
    from pdnlp_tpu_torch.parallel.local import rank_block
    from pdnlp_tpu_torch.train.setup import setup_data, setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step

    acc = Accelerator(args)
    out = {"devices": acc.num_devices}
    for mode in ("full", "bucket"):
        loader, _, _ = setup_data(args.replace(length_mode=mode))
        _, prepared = acc.prepare(None, loader)
        first = next(iter(prepared))
        out[mode] = (len(prepared), tuple(first["input_ids"].shape),
                     type(prepared._loader.sampler).__name__,
                     getattr(prepared._loader.sampler, "num_shards", None))
    _, state = setup_model(args, VOCAB)
    (state,) = acc.prepare(state)
    step = acc.compile_step(build_train_step(args, CPU))
    block = rank_block(payload["batch"], rank, world)
    out["loss"] = float(step(state, to_device(block, CPU))["loss"])
    return out


def test_accelerator_prepare_rescales_loader(corpus_path, tmp_path):
    """``prepare`` at world 1 keeps the loader's steps; under two ranks it
    reshards the plain sampler and rebuilds the length-grouped one at the
    scaled batch, so ``len`` is the global step count (the reference's
    ``total_step`` division), and one step on the two blocks of a global
    batch has the single-process loss."""
    from pdnlp_tpu_torch.data.tokenizer import get_or_build_vocab
    from pdnlp_tpu_torch.parallel import local
    from pdnlp_tpu_torch.train.setup import setup_data, setup_model
    from pdnlp_tpu_torch.train.steps import build_train_step

    args = tiny_args(data_path=corpus_path, data_limit=600,
                     vocab_path=str(tmp_path / "vocab.txt"),
                     train_batch_size=32, dist_backend="gloo")
    get_or_build_vocab(args)
    loader, _, _ = setup_data(args)
    single = len(loader)
    acc = Accelerator(args)
    _, prepared = acc.prepare(None, loader)
    assert len(prepared) == single
    b = next(iter(prepared))
    assert isinstance(b["input_ids"], torch.Tensor)
    assert b["input_ids"].shape[0] == 32
    batch = fake_batch(32, seed=4)
    r0, r1 = local.run_gang(_accel_gang, 2, args, {"batch": batch},
                            timeout=GANG_TIMEOUT)
    assert r0["devices"] == 2
    assert r0["full"] == r1["full"] == (-(-single * 32 // 64), (32, 16),
                                        "DistributedShardSampler", 2)
    assert r0["bucket"][2] == "LengthGroupedSampler" and \
        r0["bucket"][3] == 2 and r0["bucket"][0] == r1["bucket"][0]
    _, state = setup_model(args, VOCAB)
    want = build_train_step(args, CPU)(state, to_device(batch, CPU))
    assert r0["loss"] == r1["loss"]
    assert r0["loss"] == pytest.approx(float(want["loss"]), rel=1e-5)


def test_accelerator_from_config_file(tmp_path, monkeypatch):
    """The machine config as a file: precision and the mesh from JSON; YAML
    with DeepSpeed picks zero; a mesh axis the port does not have is
    refused by name; without ``yaml`` a YAML file raises naming it."""
    p = tmp_path / "machine.json"
    p.write_text('{"compute_environment": "LOCAL_MACHINE",'
                 ' "distributed_type": "MULTI_GPU",'
                 ' "mixed_precision": "bf16", "num_processes": 1}')
    acc = Accelerator.from_config(str(p), args=tiny_args())
    assert acc.num_devices == 1
    assert acc.dtype == "bfloat16" and acc.args.dtype == "bfloat16"
    assert acc.mode == "dp"
    y = tmp_path / "machine.yaml"
    y.write_text("mixed_precision: 'no'\ndistributed_type: DEEPSPEED\n"
                 "mesh_shape:\n  data: 1\n")
    acc = Accelerator.from_config(str(y), args=tiny_args())
    assert acc.mode == "zero" and acc.dtype == "float32"
    assert dict(zip(acc.mesh.mesh_dim_names, acc.mesh.shape)) == {"data": 1}
    # a tp mesh: two devices this world of one does not have (JAX's
    # make_mesh message); a stage axis of one rank is replicated over, as
    # JAX's Accelerator places dp on it
    tp = tmp_path / "tp.yaml"
    tp.write_text("mesh_shape:\n  data: 1\n  model: 2\n")
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Accelerator.from_config(str(tp), args=tiny_args())
    pp = tmp_path / "pp.yaml"
    pp.write_text("mesh_shape:\n  data: 1\n  stage: 1\n")
    acc = Accelerator.from_config(str(pp), args=tiny_args())
    assert acc.mode == "dp" and acc.num_devices == 1
    assert dict(zip(acc.mesh.mesh_dim_names, acc.mesh.shape)) == {
        "data": 1, "stage": 1}
    import builtins

    real_import = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml":
            raise ImportError("no yaml")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(ValueError, match="machine.yaml"):
        Accelerator.from_config(str(y), args=tiny_args())


# ----------------------------------------------------------- AutoTrainer


def test_autotrainer_declarative_run(corpus_path, tmp_path):
    """A declared run: an eval and a save every step, rotation to one dir
    plus the best, the best weights adopted at full precision and written
    over the best dir, which ``tools.evaluate`` discovers."""
    from pdnlp_tpu_torch.tools.evaluate import discover_checkpoints
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    targs = managed(corpus_path, tmp_path, "auto", eval_steps=1,
                    save_steps=1, save_total_limit=1)
    at = AutoTrainer(targs)
    m = at.train()
    assert m["global_step"] == len(at.train_loader) > 1
    assert m["train_runtime"] > 0 and m["train_samples_per_second"] > 0
    e = at.evaluate()
    assert 0.0 <= e["eval_accuracy"] <= 1.0
    assert at.best_ckpt is not None and os.path.isdir(at.best_ckpt)
    dirs = sorted(os.listdir(targs.output_dir))
    assert len(dirs) <= 2 and os.path.basename(at.best_ckpt) in dirs
    best_file = os.path.join(at.best_ckpt, "model.msgpack")
    assert best_file in discover_checkpoints(str(tmp_path))
    live = at._trainer.state.model.state_dict()
    saved = ckpt.load_params(best_file, live)
    assert all(torch.equal(saved[k], live[k]) for k in live)
    assert e["eval_accuracy"] == pytest.approx(at.best_metric)


def test_sweep_discovers_and_validates_checkpoints(tmp_path):
    """The sweep's loads check shapes against the model (a mismatch is a
    ``ValueError``, not corruption) and round-trip the weights."""
    from pdnlp_tpu_torch.tools.evaluate import discover_checkpoints
    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train.setup import setup_model

    _, state = setup_model(tiny_args(), VOCAB)
    good = state.model.state_dict()
    path = str(tmp_path / "x-cls.msgpack")
    ckpt.save_params(path, good, model_name="bert-tiny", vocab_size=VOCAB)
    bad = dict(good, **{"classifier.weight": torch.zeros(5, 128)})
    with pytest.raises(ValueError, match="does not match"):
        ckpt.load_params(path, bad)
    back = ckpt.load_params(path, good)
    assert _same(back, {k: v for k, v in good.items()})
    assert discover_checkpoints(str(tmp_path)) == [path]


def _losses_of(trainer):
    """Wrap the trainer's step (and the one its K-step dispatch runs on the
    CPU) to record each step's loss."""
    seen = []
    step = trainer.train_step

    def recording(state, batch, **kw):
        m = step(state, batch, **kw)
        seen.append(float(m["loss"]))
        return m

    trainer.train_step = recording
    if trainer.multi_step is not None:
        trainer.multi_step.train_step = recording
    return seen


def test_autotrainer_fused_steps(corpus_path, tmp_path):
    """``fuse_steps`` 2: the cadences hold, the global step, the losses
    and the eval equal the unfused run's; a ``fuse_steps`` that does not
    divide a cadence is refused, and so is one above 1 under zero (a
    captured step cannot hold FSDP2's collectives)."""
    common = dict(eval_steps=2, save_steps=2, save_total_limit=2,
                  logging_steps=2, attn_dropout=0.0)
    fused = AutoTrainer(managed(corpus_path, tmp_path, "fused",
                                fuse_steps=2, **common))
    fl = _losses_of(fused._trainer)
    fm = fused.train()
    fe = fused.evaluate()
    plain = AutoTrainer(managed(corpus_path, tmp_path, "plain", **common))
    pl = _losses_of(plain._trainer)
    pm = plain.train()
    pe = plain.evaluate()
    assert fm["global_step"] == pm["global_step"] == len(fl) == len(pl)
    assert fl == pl
    assert fe["eval_loss"] == pytest.approx(pe["eval_loss"], rel=1e-5)
    assert fused.best_ckpt is not None and os.path.isdir(fused.best_ckpt)
    with pytest.raises(ValueError, match="must divide"):
        AutoTrainer(managed(corpus_path, tmp_path, "bad", fuse_steps=3,
                            **common))
    with pytest.raises(ValueError, match="ROADMAP A7"):
        AutoTrainer(managed(corpus_path, tmp_path, "zero2", fuse_steps=2,
                            mode="zero", **common))


def _zero_gang(rank, world, args, payload):
    """An AutoTrainer run under ``mode="zero"`` in rank ``rank``."""
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    torch.set_num_threads(1)
    at = AutoTrainer(payload["targs"])
    sharded = ckpt.is_sharded(at._trainer.state.model)
    local = sum(p.to_local().numel() for p in
                at._trainer.state.model.parameters())
    total = sum(p.numel() for p in at._trainer.state.model.parameters())
    m = at.train()
    e = at.evaluate()
    return {"sharded": sharded, "fraction": local / total,
            "global_step": m["global_step"], "steps": len(at.train_loader),
            "accuracy": e["eval_accuracy"], "best": at.best_ckpt,
            "best_exists": bool(at.best_ckpt)
            and os.path.isdir(at.best_ckpt)}


def test_autotrainer_zero_mode(corpus_path, tmp_path):
    """``mode="zero"`` (FSDP2, the DeepSpeed delegation) in two ranks: the
    state is sharded (about half the parameters per rank), the run trains
    the epoch, rotates and adopts the best model on every rank."""
    from pdnlp_tpu_torch.data.tokenizer import get_or_build_vocab
    from pdnlp_tpu_torch.parallel import local

    targs = managed(corpus_path, tmp_path, "auto0", mode="zero",
                    eval_steps=2, save_steps=2, save_total_limit=2)
    get_or_build_vocab(targs.to_args())
    res = local.run_gang(_zero_gang, 2,
                         tiny_args(dist_backend="gloo"), {"targs": targs},
                         timeout=GANG_TIMEOUT)
    for r in res:
        assert r["sharded"] and r["fraction"] < 0.75, r
        assert r["global_step"] == r["steps"] > 0
        assert 0.0 <= r["accuracy"] <= 1.0
    assert res[0]["best"] == res[1]["best"] and res[0]["best_exists"]


def test_autotrainer_resume_from_checkpoint(corpus_path, tmp_path):
    """``save_optimizer_state`` + ``resume_from_checkpoint="latest"``: a run
    stopped after step 4 and resumed from ``checkpoint-4`` ends on the
    uninterrupted run's params bit for bit (AdamW's state, the step, the
    dropout generator and the data order come back); a dir without a
    train state is refused naming ``save_optimizer_state``; resuming with
    params-only rotation saves is refused."""
    common = dict(eval_steps=4, save_steps=2, save_total_limit=None,
                  save_optimizer_state=True, load_best_model_at_end=False)
    full = AutoTrainer(managed(corpus_path, tmp_path, "full", **common))
    full.train()
    want = _params(full._trainer.state.model)

    first = AutoTrainer(managed(corpus_path, tmp_path, "r", **common))
    t = first._trainer
    first.train_loader.set_epoch(0)
    for gstep, batch in enumerate(first.train_loader, start=1):
        t.train_step(t.state, t.put(batch))
        if gstep % 2 == 0:
            first._save_checkpoint(gstep)
        if gstep == 4:
            break
    first._drain_writers()
    resumed = AutoTrainer(managed(corpus_path, tmp_path, "r",
                                  resume_from_checkpoint="latest", **common))
    m = resumed.train()
    assert m["global_step"] == len(resumed.train_loader)
    assert _same(_params(resumed._trainer.state.model), want)
    with pytest.raises(FileNotFoundError, match="save_optimizer_state"):
        AutoTrainer(managed(corpus_path, tmp_path, "p",
                            resume_from_checkpoint=str(tmp_path / "nope"),
                            **common)).train()
    with pytest.raises(ValueError, match="rotate away"):
        AutoTrainer(managed(corpus_path, tmp_path, "q",
                            resume_from_checkpoint="latest",
                            **dict(common, save_optimizer_state=False,
                                   save_total_limit=2)))


def test_autotrainer_resume_restores_best_tracking(corpus_path, tmp_path):
    """``trainer_state.json`` survives the crash: the resumed run inherits
    the pre-crash best metric and dir, rotation keeps that dir, and the
    best adopted at the end is its file's."""
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    common = dict(eval_steps=4, save_steps=4, save_total_limit=None,
                  save_optimizer_state=True, load_best_model_at_end=True)
    out = tmp_path / "bt"
    first = AutoTrainer(managed(corpus_path, tmp_path, "bt", **common))
    t = first._trainer
    first.train_loader.set_epoch(0)
    for i, batch in enumerate(first.train_loader):
        t.train_step(t.state, t.put(batch))
        if i + 1 == 4:
            break
    first.best_metric = 0.999
    first.best_ckpt = first._ckpt_dir(4)
    first._save_checkpoint(4)
    first._drain_writers()
    with open(out / "checkpoint-4" / "trainer_state.json") as f:
        assert json.load(f)["best_metric"] == 0.999
    resumed = AutoTrainer(managed(corpus_path, tmp_path, "bt",
                                  resume_from_checkpoint="latest", **common))
    resumed.train()
    assert resumed.best_metric == 0.999
    assert resumed.best_ckpt == str(out / "checkpoint-4")
    assert (out / "checkpoint-4").is_dir()
    live = resumed._trainer.state.model.state_dict()
    best = ckpt.load_params(str(out / "checkpoint-4" / "model.msgpack"), live)
    assert all(torch.equal(best[k], live[k]) for k in live)


def test_autotrainer_losses_match_jax(corpus_path, tmp_path, ndev,
                                      monkeypatch):
    """The same ``TrainerArgs`` through JAX's ``AutoTrainer`` and the
    port's, fp32 at dropout 0, from the same weights (a JAX-initialised
    classifier tree loaded through ``init_from`` / ``init_head``): every
    step's loss within 1e-5 and the final eval loss too.  JAX's global
    batch is its per-device batch over the 8 virtual devices, so its
    per-device batch is 32 / 8."""
    import jax

    from pdnlp_tpu.data.tokenizer import get_or_build_vocab as jvocab
    from pdnlp_tpu.models import bert as jbert
    from pdnlp_tpu.models import get_config as jax_get_config
    from pdnlp_tpu.train import auto as jauto
    from pdnlp_tpu.train import checkpoint as jckpt
    from pdnlp_tpu.utils.config import Args as JArgs

    vocab_path = "output/vocab.txt"     # where JAX's TrainerArgs reads it
    vocab_size = len(jvocab(JArgs(data_path=corpus_path)))
    jcfg = jax_get_config("bert-tiny", vocab_size=vocab_size)
    init = str(tmp_path / "init.msgpack")
    jckpt.save_params(init, {"params": jbert.init_params(
        jax.random.PRNGKey(0), jcfg)})
    common = dict(model="bert-tiny", data_path=corpus_path, data_limit=400,
                  max_seq_len=16, eval_steps=4, save_steps=4,
                  save_total_limit=1, logging_steps=10 ** 6,
                  init_from=init, init_head=True, learning_rate=1e-3)
    for cls in (jauto.TrainerArgs, TrainerArgs):
        monkeypatch.setattr(cls, "to_args", lambda self, f=cls.to_args: f(
            self).replace(dropout=0.0, attn_dropout=0.0))
    jat = jauto.AutoTrainer(jauto.TrainerArgs(
        output_dir=str(tmp_path / "jax"), per_device_train_batch_size=32
        // ndev, per_device_eval_batch_size=32 // ndev, **common))
    jlosses = []
    jstep = jat._trainer.train_step

    def jrecord(state, batch):
        state, m = jstep(state, batch)
        jlosses.append(float(m["loss"]))
        return state, m

    jat._trainer.train_step = jrecord
    jat.train()
    je = jat.evaluate()
    at = AutoTrainer(TrainerArgs(
        output_dir=str(tmp_path / "port"), device="cpu",
        vocab_path=vocab_path, **common))
    losses = _losses_of(at._trainer)
    at.train()
    e = at.evaluate()
    assert len(losses) == len(jlosses) > 4
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    assert abs(e["eval_loss"] - je["eval_loss"]) <= 1e-5
    assert at.best_ckpt.endswith(os.path.basename(jat.best_ckpt))
