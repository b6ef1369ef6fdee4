"""Self-spawning launcher — the twin of ``multi-tpu-spawn-cls.py`` (the
``mp.spawn`` analog): one command forks ``--num_processes`` workers that
rendezvous over TCP on localhost and run ``train.multi``'s strategy.

    python -m pdnlp_tpu_torch.train.spawn --strategy dp --num_processes 2
    python -m pdnlp_tpu_torch.train.spawn --device cpu --num_processes 2 \\
        --strategy zero --model bert-tiny

The parent is only a process manager: each worker is this module again
with ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID`` and
``LOCAL_RANK`` set.  The port is ``PDNLP_SPAWN_PORT`` or else a free one.
When a worker fails, the parent stops the whole gang and exits with its
code: a rank whose peer died would otherwise wait in a collective.
On one card, two workers share it over ``--dist_backend gloo`` (NCCL
refuses a second rank on a card).  ``--elastic`` and the heartbeat flags
(the gang supervisor) are refused: ROADMAP A11.
"""
from __future__ import annotations

import os
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


def main(argv) -> int:
    from pdnlp_tpu_torch.train import multi

    args, _ = multi.parse(argv, prog="train.spawn")
    if os.environ.get("PROCESS_ID") is None and args.process_id is None:
        return spawn(argv, args.num_processes or 1)
    multi.main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
