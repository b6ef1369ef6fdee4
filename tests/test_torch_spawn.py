"""The data-parallel entry points of the PyTorch port run as a user runs
them — ``python -m pdnlp_tpu_torch.train.spawn`` forking two real ranks
over gloo on the CPU (bert-tiny) — and match a single process: the twins
of ``tests/test_spawn.py``'s dp and zero cases.

The spawned global batch (4 rows x 2 ranks) is the single process's
8-row batch, example for example, so at dropout 0 the loss lines and the
final weights agree up to the order of fp32 sums: the JAX twin's bounds
(losses rtol 2e-4 / atol 2e-5, params rtol 1e-3 / atol 1e-5); the dev
set splits evenly over the ranks, so the test accuracy is the same.
"""
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pdnlp_tpu_torch.train import multi, spawn
from pdnlp_tpu_torch.utils.config import Args

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMON = ["--device", "cpu", "--model", "bert-tiny", "--data_limit", "600",
          "--max_seq_len", "32", "--dropout", "0", "--attn_dropout", "0",
          "--learning_rate", "1e-3", "--dev", "true", "--eval_step", "30"]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
                        "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    # two intra-op threads a process: the suite runs several workers on the
    # machine's cores at once, and a process that starts one thread per
    # core spins them against the others' (a 240 s timeout was hit so)
    env["OMP_NUM_THREADS"] = "2"
    return env


def _run(module, argv, timeout=240):
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(scope="module")
def data(corpus_path, tmp_path_factory):
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    return ["--data_path", corpus_path, "--vocab_path", str(vocab)]


def _losses(out):
    return [float(x) for x in re.findall(r"【train】 .* loss：(\S+)", out)]


def _params(path):
    return torch.load(path, weights_only=True)["state_dict"]


@pytest.fixture(scope="module")
def single_run(data, tmp_path_factory):
    """The single-process reference: ``train.single`` at the spawned
    gang's global batch of 8."""
    out = tmp_path_factory.mktemp("single")
    r = _run("pdnlp_tpu_torch.train.single",
             COMMON + data + ["--train_batch_size", "8", "--output_dir",
                              str(out)])
    assert r.returncode == 0, r.stderr[-3000:]
    return r, out / "single-cls.pt"


@pytest.fixture(scope="module", params=["dp", "zero"])
def spawn_run(request, data, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"spawn_{request.param}")
    r = _run("pdnlp_tpu_torch.train.spawn",
             COMMON + data + ["--strategy", request.param,
                              "--num_processes", "2", "--train_batch_size",
                              "4", "--output_dir", str(out)])
    return request.param, r, out / f"{request.param}-cls.pt"


def test_spawn_completes_and_checkpoints(spawn_run, data, tmp_path):
    """Two ranks in one process group; 【train】 lines from rank 0 only, a
    dev line, the report over the global dev set, one checkpoint that
    ``serve.cli`` serves."""
    strategy, r, ckpt = spawn_run
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    head = next(ln for ln in out.splitlines() if ln.startswith("mesh:"))
    assert "mesh: {'data': 2}  process 0/2" in head
    assert f"mode: {strategy}" in head and "backend: gloo" in head
    steps = int(re.search(r"steps/epoch: (\d+)", head).group(1))
    assert len(_losses(out)) == steps
    assert out.count("mesh:") == 1 and out.count("耗时：") == 1
    assert any(ln.startswith("【dev】") for ln in out.splitlines())
    support = re.search(r"accuracy\s+\S+\s+(\d+)", out)
    assert support and int(support.group(1)) == 48     # the whole dev split
    assert ckpt.exists()
    served = subprocess.run(
        [sys.executable, "-m", "pdnlp_tpu_torch.serve.cli", "--device",
         "cpu", "--model", "bert-tiny", "--vocab_path", data[-1],
         "--checkpoint", str(ckpt)],
        input="天地人\n你好\n", capture_output=True, text=True, timeout=120,
        cwd=str(tmp_path), env=_env())
    assert served.returncode == 0, served.stderr[-2000:]
    assert len(served.stdout.splitlines()) == 2


def test_spawn_matches_single_process(spawn_run, single_run):
    """Loss lines, final weights and test accuracy of the 2-rank run equal
    the single process's at the same global batch."""
    _, r, ckpt = spawn_run
    assert r.returncode == 0, r.stderr[-3000:]
    ref, ref_ckpt = single_run
    got, want = _losses(r.stdout), _losses(ref.stdout)
    assert len(got) == len(want) >= 60
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    a, b = _params(ckpt), _params(ref_ckpt)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    acc = re.compile(r"test loss：\S+ accuracy：(\S+)")
    assert acc.search(r.stdout).group(1) == acc.search(ref.stdout).group(1)


@pytest.mark.parametrize("argv,match", [
    (["--strategy", "pp", "--model", "bert-tiny", "--mesh_shape",
      '{"stage": 3}'], "must divide num_layers"),
    (["--strategy", "sp", "--model", "bert-tiny-moe"],
     "MoE layers are not supported"),
    (["--offload_opt_state", "true", "--fuse_steps", "2"],
     "works with the jit dp/zero strategies, not shard_map"),
    (["--offload_opt_state", "true", "--strategy", "tp"],
     "works with the jit dp/zero strategies, not shard_map"),
    (["--mode", "pp", "--mesh_shape", '{"data": 2}'],
     "pp needs a 'stage' mesh axis"),
    (["--strategy", "fsdp"], "--strategy must be one of")])
def test_refusals_name_the_missing_path(argv, match):
    """What the launcher refuses, by name: JAX's own refusals on the pp
    and sp paths and of offload (with fused steps, with tp), and an
    unknown strategy."""
    with pytest.raises(SystemExit, match=match):
        multi.parse(argv, prog="train.spawn")


@pytest.mark.parametrize("argv,fuse", [
    (["--strategy", "zero", "--fuse_steps", "2"], 2),
    (["--mode", "zero", "--fuse_steps", "4"], 4),
    (["--strategy", "zero", "--dtype", "bfloat16", "--grads_dtype",
      "compute", "--fuse_steps", "2"], 2)])
def test_zero_takes_fused_steps(argv, fuse):
    """zero with ``--fuse_steps`` above 1, refused before (ROADMAP A7), is
    taken as ``train.spawn`` is typed, the strategy's ``--remat true``
    default kept under ``--strategy`` (the captured step replays the
    recompute's masks on the card, ``models.bert.RematRng``; ``--mode
    zero`` has no remat default), and the zero step it builds on the CPU
    runs its K steps."""
    from pdnlp_tpu_torch.parallel.execution import check_capture_backend

    args, knobs = multi.parse(argv, prog="train.spawn")
    assert knobs["mode"] == "zero" and args.fuse_steps == fuse
    assert args.remat is (argv[0] == "--strategy")
    check_capture_backend(args, knobs["mode"], torch.device("cpu"))


@pytest.mark.parametrize("argv,field,value", [
    (["--elastic", "true"], "elastic", True),
    (["--heartbeat_interval", "2"], "heartbeat_interval", 2.0),
    (["--stall_timeout", "60"], "stall_timeout", 60.0),
    (["--strategy", "pp"], "mesh_shape", {"stage": 1}),
    (["--strategy", "sp"], "mesh_shape", {"data": 1, "seq": 1}),
    (["--strategy", "sp", "--ema_decay", "0.9"], None, "--ema_decay")])
def test_elastic_and_model_axis_flags_parse(argv, field, value):
    """The elastic flags and the pp / sp strategies parse, with JAX's
    default meshes at the world of one; EMA on sp is JAX's refusal."""
    if field is None:
        with pytest.raises(SystemExit, match=value):
            multi.parse(argv, prog="train.spawn")
        return
    args, knobs = multi.parse(argv, prog="train.spawn")
    assert getattr(args, field) == value


@pytest.mark.parametrize("strategy,want", [
    ("dp", {"mode": "dp"}),
    ("dataparallel", {"mode": "dp", "scale_batch": False}),
    ("zero", {"mode": "zero"}),
    ("shardmap", {"mode": "dp", "explicit_collectives": True}),
    ("amp", {"mode": "dp"})])
def test_strategy_defaults_follow_the_jax_scripts(strategy, want):
    # --mode tp, refused before this slice, is accepted now
    assert multi.parse(["--mode", "tp"])[1] == {"mode": "tp"}
    args, knobs = multi.parse(["--strategy", strategy])
    assert knobs == want
    assert args.strategy == strategy and args.device == "cuda"
    assert args.remat == (strategy == "zero")
    assert args.dtype == ("bfloat16" if strategy == "amp" else "float32")
    assert args.ckpt_path().endswith(f"{strategy}-cls.pt")
    args, _ = multi.parse(["--strategy", "zero", "--remat", "false",
                           "--mesh_shape", '{"data": 2}'])
    assert args.remat is False and args.mesh_shape == {"data": 2}


def test_shardmap_refuses_length_modes_and_ema_and_zero_refuses_ema():
    """JAX's refusals (``run.py:54-67``, ``execution.py:203-207``); the
    EMA under zero is no longer refused (its tree takes the params'
    placement), and neither are its fused steps (refused before, ROADMAP
    A7): the EMA rides in zero's step."""
    from pdnlp_tpu_torch.parallel.execution import (
        check_strategy, make_shardmap_train_step,
    )
    from pdnlp_tpu_torch.train.run import build_parallel_trainer

    with pytest.raises(ValueError, match="length_mode"):
        build_parallel_trainer(Args(device="cpu", length_mode="pack"),
                               explicit_collectives=True)
    ema = Args(device="cpu", ema_decay=0.5)
    with pytest.raises(ValueError, match="shard_map step"):
        make_shardmap_train_step(ema, None, torch.device("cpu"))
    check_strategy(ema.replace(fuse_steps=2), "zero")
    from pdnlp_tpu_torch.train import multi

    args, _ = multi.parse(["--strategy", "zero", "--ema_decay", "0.5",
                           "--dtype", "bfloat16", "--grads_dtype",
                           "compute", "--offload_opt_state", "true"])
    assert args.ema_decay == 0.5 and args.offload_opt_state


def test_a_failing_worker_stops_the_gang(monkeypatch):
    """One worker exits 3 while another waits: the parent stops the
    survivor and exits with the failure's code."""
    procs = []

    def fake_gang(argv, width, port):
        procs.extend([
            subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(120)"]),
            subprocess.Popen([sys.executable, "-c",
                              "import sys, time; time.sleep(0.5); "
                              "sys.exit(3)"])])
        return procs

    monkeypatch.setattr(spawn, "launch_gang", fake_gang)
    t0 = time.monotonic()
    assert spawn.spawn([], 2) == 3
    assert time.monotonic() - t0 < 60
    assert all(p.poll() is not None for p in procs)


def test_workers_that_fail_make_the_launcher_fail(data, tmp_path):
    """A rank that raises (a mesh wider than the gang) fails the command."""
    r = _run("pdnlp_tpu_torch.train.spawn",
             COMMON + data + ["--num_processes", "2", "--mesh_shape",
                              '{"data": 4}', "--output_dir", str(tmp_path)])
    assert r.returncode != 0
    assert "needs 4 devices, have 2" in r.stderr
    assert "【train】" not in r.stdout


def test_free_port_is_bindable():
    import socket

    port = spawn.free_port()
    with socket.socket() as s:
        s.bind(("localhost", port))
