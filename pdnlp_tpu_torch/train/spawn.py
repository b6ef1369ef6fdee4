"""Self-spawning launcher — the twin of ``multi-tpu-spawn-cls.py`` (the
``mp.spawn`` analog): one command forks ``--num_processes`` workers that
rendezvous over TCP on localhost and run ``train.multi``'s strategy.

    python -m pdnlp_tpu_torch.train.spawn --strategy dp --num_processes 2
    python -m pdnlp_tpu_torch.train.spawn --device cpu --num_processes 2 \\
        --strategy zero --model bert-tiny
    python -m pdnlp_tpu_torch.train.spawn --strategy tp|ep|pp|sp \
        --num_processes 2
    python -m pdnlp_tpu_torch.train.spawn --strategy dp --num_processes 2 \
        --elastic true [--resume_every 2] [--stall_timeout 300]

The parent is only a process manager: each worker is this module again
with ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID`` and
``LOCAL_RANK`` set.  The port is ``PDNLP_SPAWN_PORT`` or else a free one.
When a worker fails, the parent stops the whole gang and exits with its
code: a rank whose peer died would otherwise wait in a collective.
Worker ``r`` gets ``LOCAL_RANK=r`` and so takes card ``r``
(``parallel.runtime.init_runtime``): one rank per card, over NCCL (four
H100s in ``chip_smoke.py --phase 17``).  On one card, two workers can
share it only over ``--dist_backend gloo`` (NCCL refuses a second rank of
one group on a card).

``--elastic true`` makes the parent a gang supervisor
(``parallel.watchdog.GangSupervisor``, JAX's ``multi-tpu-spawn-cls.py
:52-112``), for a gang of any width, one included: the workers beat
every ``--heartbeat_interval`` seconds and snapshot the whole train state
every ``--resume_every`` steps; when a worker dies or the stalest beat is
older than ``--stall_timeout``, the parent kills the gang, evicts the dead
ranks (``--elastic_shrink``) and relaunches the rest from the newest
snapshot (``--resume_from auto``), with a capped exponential backoff and
``--max_restarts`` restarts.  A snapshot from another width resumes with
its data position remapped by epoch fraction (``train.trainer``).
"""
from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import time
from typing import List

#: seconds a stopped gang gets to exit before it is killed
GRACE = 10.0


def free_port() -> int:
    """A localhost TCP port nobody listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _stop(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + GRACE
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_gang(argv, width: int, port: int) -> List[subprocess.Popen]:
    """Start ``width`` workers of this module on ``argv``."""
    procs = []
    # workers share the machine's cores (torchrun's rule): a CPU gang whose
    # ranks each start one thread per core spins them against each other
    threads = str(max(1, (os.cpu_count() or 1) // width))
    for rank in range(width):
        env = {"OMP_NUM_THREADS": threads, **os.environ,
               "COORDINATOR_ADDRESS": f"localhost:{port}",
               "NUM_PROCESSES": str(width), "PROCESS_ID": str(rank),
               "LOCAL_RANK": str(rank)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pdnlp_tpu_torch.train.spawn", *argv],
            env=env))
    return procs


def spawn(argv, width: int) -> int:
    """Run a gang of ``width`` workers to its end: 0 when every worker
    exits 0, else the first failure's code, after stopping the rest."""
    port = int(os.environ.get("PDNLP_SPAWN_PORT") or free_port())
    procs = launch_gang(argv, width, port)
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    finally:
        _stop(procs)


def elastic(argv, args) -> int:
    """Run the gang under the supervisor (module docstring): a previous
    run's ``auto`` snapshot is discarded (a fresh gang would "resume" at its
    last step), the heartbeat directory cleared, and every incarnation
    launched with the heartbeat, snapshot and resume flags at its width."""
    from pdnlp_tpu_torch.parallel.watchdog import (
        GangSupervisor, heartbeat_dir,
    )
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    # a user-supplied --resume_from is the opposite intent (continue THAT
    # run) and is left alone
    if not args.resume_from or args.resume_from == "auto":
        ckpt.discard(args.resume_path())
        ckpt.discard(args.resume_path() + "-best")
        best_json = args.resume_path() + "-best.json"
        if os.path.exists(best_json):
            os.remove(best_json)
    shutil.rmtree(heartbeat_dir(args.output_dir), ignore_errors=True)
    worker = list(argv) + [
        "--heartbeat_interval", str(args.heartbeat_interval or 2.0),
        "--resume_every", str(args.resume_every or 10)]
    if not args.resume_from:
        worker += ["--resume_from", "auto"]
    port = os.environ.get("PDNLP_SPAWN_PORT")

    def launch(width):
        # --num_processes last wins; each incarnation rendezvouses at its
        # width on a port of its own (a killed gang's listener may linger)
        return launch_gang(worker + ["--num_processes", str(width)], width,
                           int(port) if port else free_port())

    return GangSupervisor(
        launch, args.output_dir, args.num_processes or 1,
        stall_timeout=args.stall_timeout, max_restarts=args.max_restarts,
        shrink=args.elastic_shrink, min_processes=args.min_processes,
        backoff=args.restart_backoff,
        backoff_cap=args.restart_backoff_cap).run()


def main(argv) -> int:
    from pdnlp_tpu_torch.train import multi

    args, _ = multi.parse(argv, prog="train.spawn")
    if os.environ.get("PROCESS_ID") is None and args.process_id is None:
        if args.elastic:
            return elastic(argv, args)
        return spawn(argv, args.num_processes or 1)
    multi.main(argv, prog="train.spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
