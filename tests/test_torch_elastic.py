"""The elastic gang in the PyTorch port against the JAX package's
(``pdnlp_tpu/parallel/watchdog.py:GangSupervisor``,
``Trainer._remap_elastic_width``, ``multi-tpu-spawn-cls.py --elastic``;
the twins of ``tests/test_chaos.py:233-330, 430-478``):

- ``GangSupervisor`` and ``GangMonitor`` against JAX's own on the same
  scripted fake launches and injected clock (the five cases of
  ``test_chaos.py:233-290``): the same widths launched, restarts, return
  code, ``[elastic]`` lines and verdicts;
- a zero run at 4 ranks snapshotted at step 4 and resumed at 2 ranks: the
  remapped step, AdamW's state resharded exactly, and the final params
  against JAX's same 4 -> 2 run in process (atol 2e-5), from the same
  weights (the port's seeded init, carried to JAX by ``models.convert``);
- ``train.spawn --device cpu --elastic true --num_processes 2`` with rank 1
  SIGKILLed at step 5: the supervisor evicts it, the gang resumes at width
  1 with the remapped step and finishes; a solo elastic run (width 1,
  SIGKILL at step 3) ends on an undisturbed run's params bit for bit.

JAX's cross-process elastic tests have no passing run on the CPU backend
(a limit of the reference: ROADMAP §C), so the spawned runs are held to
the lines JAX's test asserts and to an undisturbed run of the port.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.parallel import local
from pdnlp_tpu_torch.train import checkpoint as ckpt
from pdnlp_tpu_torch.utils.config import Args
from tests.test_chaos import KillableProc, ScriptedLaunch
from tests.test_elastic import FakeClock, FakeProc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT = 300


# ------------------------------------------------------------- supervisor

def _supervise(cls, outcomes, tmp_path, n, **kw):
    """``cls`` (JAX's or the port's supervisor) over a scripted launch on
    an injected clock: (widths, restarts, rc, lines, backoff sleeps)."""
    launch = ScriptedLaunch(outcomes)
    clk = FakeClock()
    sleeps, lines = [], []

    def sleep(s):
        sleeps.append(s)
        clk.advance(s)

    sup = cls(launch, str(tmp_path), n, stall_timeout=30.0, clock=clk,
              sleep=sleep, log=lines.append, **kw)
    rc = sup.run()
    return (launch.widths, sup.restarts, rc, lines,
            [s for s in sleeps if s != sup.poll_interval])


@pytest.mark.parametrize("outcomes,n,kw", [
    (["crash1", "done"], 2, {"max_restarts": 2}),
    (["crash0", "done"], 2, {"shrink": False}),
    (["crash0", "done"], 2, {"min_processes": 2}),
    (["crash0"] * 4, 3, {"max_restarts": 3, "backoff": 1.0,
                         "backoff_cap": 3.0})],
    ids=["evict-shrink", "no-shrink", "min-width", "budget-backoff"])
def test_supervisor_decides_as_jax(tmp_path, outcomes, n, kw):
    """Both supervisors on one script make the same decisions: widths
    launched, restarts, return code, backoffs and ``[elastic]`` lines."""
    from pdnlp_tpu.parallel.watchdog import GangSupervisor as JaxSupervisor
    from pdnlp_tpu_torch.parallel.watchdog import GangSupervisor

    want = _supervise(JaxSupervisor, outcomes, tmp_path / "jax", n, **kw)
    got = _supervise(GangSupervisor, outcomes, tmp_path / "port", n, **kw)
    assert got == want
    assert any(line.startswith("[elastic]") for line in got[3])


def test_monitor_stall_verdict_as_jax(tmp_path):
    """Slow against dead at the rank level: the rank whose beats stopped
    is named dead, the slow one never, by both monitors."""
    from pdnlp_tpu.parallel import watchdog as jw
    from pdnlp_tpu_torch.parallel import watchdog as pw

    verdicts = []
    for mod, sub in ((jw, "jax"), (pw, "port")):
        clk = FakeClock()
        d = str(tmp_path / sub)
        mon = mod.GangMonitor([FakeProc(), FakeProc()], d, 2,
                              stall_timeout=30.0, clock=clk)
        hb0 = mod.Heartbeat(d, 0, interval=0.0, clock=clk)
        hb1 = mod.Heartbeat(d, 1, interval=0.0, clock=clk)
        clk.advance(1.0)
        hb0.beat(force=True, step=4)
        hb1.beat(force=True, step=4)
        clk.advance(31.0)
        hb0.beat(force=True, step=5, steps_per_sec=0.16)
        verdicts.append(mon.poll())
    assert verdicts[0] == verdicts[1]
    assert verdicts[1]["kind"] == "stalled"
    assert verdicts[1]["dead_ranks"] == [1]


def test_supervisor_kills_the_gang_on_failure(tmp_path):
    """A failure verdict terminates the survivors before the relaunch."""
    from pdnlp_tpu_torch.parallel.watchdog import GangSupervisor

    gangs = []

    def launch(width):
        gang = [KillableProc(None) for _ in range(width)]
        if not gangs:
            gang[1].code = 13
        else:
            gang = [KillableProc(0) for _ in range(width)]
        gangs.append(gang)
        return gang

    clk = FakeClock()
    sup = GangSupervisor(launch, str(tmp_path), 2, clock=clk,
                         sleep=clk.advance, log=lambda m: None)
    assert sup.run() == 0
    assert gangs[0][0].code == -15 and sup.widths_launched == [2, 1]


# -------------------------------------------- resume across widths (zero)

BASE = dict(model="bert-tiny", data_limit=192, max_seq_len=32,
            train_batch_size=8, dtype="float32", dropout=0.0,
            attn_dropout=0.0, epochs=1, log_every=10 ** 9, resume_every=4,
            pipeline="sync", learning_rate=1e-3)


def _width_rank(rank, world, args, payload):
    """One incarnation of the zero run: ``resume`` loads the snapshot
    first (returning the step before and after the remap, and whether
    AdamW's state, gathered, is the snapshot's bit for bit)."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_optimizer_state_dict,
    )

    from pdnlp_tpu_torch.parallel.sharding import shard_fraction
    from pdnlp_tpu_torch.train.run import build_parallel_trainer

    torch.set_num_threads(1)
    trainer, loader, _ = build_parallel_trainer(args, mode="zero")
    out = {"spe": len(loader)}
    if payload["resume"]:
        trainer.load_resume(args.resume_path())
        out["loaded_step"] = trainer.state.step
        st = trainer.state
        full = get_optimizer_state_dict(st.model, st.optimizer,
                                        options=StateDictOptions(
                                            full_state_dict=True,
                                            cpu_offload=True))
        raw, _, _ = ckpt.load_state(args.resume_path())
        saved = raw["optimizer"]["state"]
        out["moments_exact"] = rank != 0 or all(
            torch.equal(full["state"][k][m], saved[k][m])
            for k in saved for m in ("exp_avg", "exp_avg_sq"))
        out["remapped"] = trainer._resume_start(len(loader))
    trainer.train(loader)
    out["final_step"] = trainer.state.step
    out["shard_fraction"] = shard_fraction(trainer.state.model,
                                           trainer.state.optimizer)
    params = ckpt.consolidate(trainer.state.model)
    if rank == 0:
        out["params"] = {k: v.numpy() for k, v in params.items()}
    return out


def _jax_width_run(corpus_path, vocab, out_dir, port_params):
    """JAX's 4 -> 2 zero run in process (``test_chaos.py:293``'s, at the
    port's weights): (spe at 4, spe at 2, the final params)."""
    import jax

    from pdnlp_tpu.train.run import build_parallel_trainer
    from pdnlp_tpu.utils.config import Args as JArgs
    from pdnlp_tpu_torch.models import convert

    base = JArgs(strategy="dp", data_path=corpus_path, vocab_path=vocab,
                 output_dir=str(out_dir), **BASE)
    t4, l4, _ = build_parallel_trainer(base.replace(num_devices=4),
                                       mode="zero")
    params = convert.to_jax_params(port_params)
    t4.state["params"] = jax.tree_util.tree_map(
        lambda live, p: jax.device_put(p, live.sharding),
        t4.state["params"], params)
    t4.train(l4)
    t2, l2, _ = build_parallel_trainer(base.replace(num_devices=2),
                                       mode="zero")
    t2.load_resume(base.resume_path())
    t2.train(l2)
    return len(l4), len(l2), jax.device_get(t2.state["params"])


def test_resume_across_widths_matches_jax(corpus_path, tmp_path):
    """zero at 4 ranks (6 steps an epoch) snapshots at step 4; at 2 ranks
    (11 steps an epoch) the run resumes with the step remapped by epoch
    fraction (ceil(4 x 11 / 6) = 8), AdamW's moments gathered back are the
    snapshot's bit for bit, each rank holds about half of them, and the
    final params are JAX's same 4 -> 2 run's within 2e-5."""
    import jax

    from pdnlp_tpu_torch.models import convert

    vocab = str(tmp_path / "vocab.txt")
    args = Args(device="cpu", strategy="dp", data_path=corpus_path,
                vocab_path=vocab, output_dir=str(tmp_path / "port"), **BASE)
    r4 = local.run_gang(_width_rank, 4, args, {"resume": False},
                        timeout=GANG_TIMEOUT)
    assert r4[0]["spe"] == 6 and r4[0]["final_step"] == 6
    assert ckpt.load_manifest(args.resume_path())["meta"] == {
        "step": 4, "steps_per_epoch": 6}
    r2 = local.run_gang(_width_rank, 2, args, {"resume": True},
                        timeout=GANG_TIMEOUT)
    assert [r["spe"] for r in r2] == [11, 11]
    assert all(r["loaded_step"] == 4 and r["remapped"] == 8 for r in r2)
    assert all(r["moments_exact"] for r in r2)
    assert all(r["final_step"] == 11 for r in r2)
    assert r2[0]["shard_fraction"] < 1.5 / 2
    spe4, spe2, jparams = _jax_width_run(corpus_path, vocab,
                                         tmp_path / "jax", _port_init(args))
    assert (spe4, spe2) == (6, 11)
    got = convert.to_jax_params({k: torch.from_numpy(v) for k, v in
                                 r2[0]["params"].items()})
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(
                                     jparams)):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5,
                                   err_msg=str(path))


def _port_init(args):
    """The seeded init every rank of the port's zero run starts from."""
    from pdnlp_tpu_torch.train import setup

    _, _, tok = setup.setup_data(args)
    _, state = setup.setup_model(args, tok.vocab_size)
    return state.model.state_dict()


# ------------------------------------------- chaos (real processes, CPU)

COMMON = ["--device", "cpu", "--model", "bert-tiny", "--data_limit", "256",
          "--max_seq_len", "32", "--train_batch_size", "4", "--dropout", "0",
          "--attn_dropout", "0", "--epochs", "1", "--log_every", "1",
          "--strategy", "dp", "--elastic", "true", "--resume_every", "2",
          "--stall_timeout", "300", "--restart_backoff", "0.2"]


def _start(out, data, width, fault=None, extra=()):
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "PDNLP_FAULT_STEP", "PDNLP_FAULT_PROC",
                        "PDNLP_FAULT_KIND", "PDNLP_SPAWN_PORT")}
    # one intra-op thread a worker: the bit-equality check needs the CPU
    # backward to be the same bits from run to run
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1")
    if fault:
        env.update(PDNLP_FAULT_STEP=str(fault[0]),
                   PDNLP_FAULT_PROC=str(fault[1]), PDNLP_FAULT_KIND="sigkill")
    return subprocess.Popen(
        [sys.executable, "-m", "pdnlp_tpu_torch.train.spawn", *COMMON,
         *data, *extra, "--num_processes", str(width), "--output_dir",
         str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)


@pytest.fixture(scope="module", autouse=True)
def chaos_started(corpus_path, tmp_path_factory):
    """The spawned runs, started with the module (they run beside its
    in-process tests): rank 1 of 2 SIGKILLed at step 5; a solo run
    SIGKILLed at step 3; the solo run undisturbed."""
    import signal

    from pdnlp_tpu_torch.data.tokenizer import get_or_build_vocab

    base = tmp_path_factory.mktemp("chaos")
    data = ["--data_path", corpus_path, "--vocab_path",
            str(base / "vocab.txt")]
    # the vocabulary first, so the three runs do not race to build it
    get_or_build_vocab(Args(data_path=corpus_path,
                            vocab_path=str(base / "vocab.txt")))
    # the solo runs save in the loop: under load an asynchronous snapshot
    # may not be published one step after its submit, and a restart that
    # finds none is a fresh incarnation, which the fault hook kills again
    sync = ("--ckpt_async", "false")
    runs = {"shrink": (base / "shrink", 2, (5, 1), ()),
            "solo": (base / "solo", 1, (3, 0), sync),
            "control": (base / "control", 1, None, sync)}
    procs = {k: (_start(out, data, w, f, x), out)
             for k, (out, w, f, x) in runs.items()}
    yield procs
    for p, _ in procs.values():
        if p.poll() is None:
            os.killpg(os.getpgid(p.pid), signal.SIGKILL)
            p.wait()


@pytest.fixture(scope="module")
def chaos(chaos_started):
    """The spawned runs' ``(rc, stdout, stderr, output dir)``."""
    done = {}
    for k, (p, out) in chaos_started.items():
        stdout, stderr = p.communicate(timeout=300)
        done[k] = (p.returncode, stdout, stderr, out)
    return done


def test_spawn_elastic_evicts_and_resumes_at_reduced_width(chaos):
    """JAX's chaos test's lines (``test_chaos.py:430-478``): rank 1 evicted,
    the gang resumed at width 1 with the step remapped onto more steps per
    epoch, every remaining step run, the checkpoint verified."""
    rc, stdout, stderr, out = chaos["shrink"]
    assert rc == 0, (stdout[-2000:], stderr[-3000:])
    assert "evicting dead rank(s) [1]" in stderr
    assert "resuming at width 1" in stderr
    assert "restart 1/" in stderr
    m = re.search(r"elastic resume: remapped step \d+ \(of (\d+)/epoch at "
                  r"save time\) -> \d+ \(of (\d+)/epoch", stdout)
    assert m, stdout[-3000:]
    assert int(m.group(2)) > int(m.group(1))
    last = re.findall(r"step：(\d+)/(\d+)", stdout)[-1]
    assert last[0] == last[1], last
    ok, reason = ckpt.verify(str(out / "dp-cls.pt"))
    assert ok, reason


def test_spawn_elastic_solo_restart_bit_for_bit(chaos):
    """A gang of one is supervised too: SIGKILLed at step 3, restarted at
    its width from the step-2 snapshot, it ends on the undisturbed run's
    params bit for bit."""
    rc, stdout, stderr, out = chaos["solo"]
    assert rc == 0, (stdout[-2000:], stderr[-3000:])
    assert "restart 1/" in stderr and "evicting" not in stderr
    assert "resumed from" in stdout and "remapped" not in stdout
    crc, cout, cerr, cdir = chaos["control"]
    assert crc == 0, cerr[-3000:]
    got = torch.load(str(out / "dp-cls.pt"), weights_only=True)["state_dict"]
    want = torch.load(str(cdir / "dp-cls.pt"),
                      weights_only=True)["state_dict"]
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)


def test_remap_reads_the_payload_when_the_manifest_is_missing(corpus_path,
                                                              tmp_path):
    """A snapshot published just before the gang died may lack its
    manifest (the data file is replaced first, the manifest after); the
    payload carries the steps per epoch too, so the resume at another
    width still remaps (JAX's manifest-only rule would not)."""
    import os

    from pdnlp_tpu_torch.train.run import build_single_trainer

    args = Args(device="cpu", model="bert-tiny", data_path=corpus_path,
                vocab_path=str(tmp_path / "v.txt"), data_limit=100,
                max_seq_len=16, train_batch_size=8, dropout=0.0,
                attn_dropout=0.0, output_dir=str(tmp_path),
                log_every=10 ** 9, pipeline="sync", ckpt_async=False)
    trainer, loader, _ = build_single_trainer(args)
    spe = len(loader)
    trainer.train(loader)
    path = str(tmp_path / "snap.pt")
    trainer.save_resume(path)
    os.remove(ckpt.manifest_path(path))
    fresh, _, _ = build_single_trainer(args)
    fresh.load_resume(path)
    assert fresh.state.step == spe
    assert fresh._resume_start(2 * spe) == 2 * spe
    assert fresh.state.step == 2 * spe
