"""Process-group init — the rendezvous layer (``pdnlp_tpu/parallel/
runtime.py``).

JAX collapses rendezvous into ``jax.distributed.initialize(coordinator, n,
id)`` and picks its transport itself.  Here each rank is one process that
drives one card, and ``torch.distributed.init_process_group`` joins them
over a backend named by ``--dist_backend``: ``auto`` is NCCL on ``cuda``
and gloo on ``cpu``.  gloo on the card is used only when asked for by name
(two ranks on one card: NCCL refuses a card it already has a rank on), and
a failing NCCL init raises — it never switches to gloo.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

#: every process group is made with a timeout, so a rank whose peer died
#: fails its collective instead of waiting for ever
TIMEOUT = datetime.timedelta(seconds=300)

BACKENDS = ("auto", "nccl", "gloo")


def resolve_backend(name: str, device) -> str:
    """``--dist_backend`` -> the backend that runs: ``auto`` is NCCL on a
    card and gloo on the CPU; NCCL on the CPU is refused."""
    if name not in BACKENDS:
        raise ValueError(f"dist_backend must be one of {BACKENDS}, got "
                         f"{name!r}")
    kind = torch.device(device).type
    if name == "auto":
        return "nccl" if kind == "cuda" else "gloo"
    if name == "nccl" and kind != "cuda":
        raise ValueError("dist_backend nccl needs --device cuda")
    return name


def _int_env(*names) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return int(v)
    return None


def world_size_of(args) -> int:
    """The world size ``args`` and the environment name (:func:`rendezvous`
    's rule), without joining anything."""
    return args.num_processes or _int_env("NUM_PROCESSES", "WORLD_SIZE") \
        or 1


def rendezvous(args) -> Tuple[Optional[str], int, int, int]:
    """``(init_method, world, rank, local_rank)`` from, in order: the
    ``Args`` fields (``coordinator_address``, ``num_processes``,
    ``process_id``); the JAX package's env vars (``COORDINATOR_ADDRESS``,
    ``NUM_PROCESSES``, ``PROCESS_ID``); torchrun's (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  An address
    is ``host:port`` (TCP) or an ``init_method`` URL (``file://...``); none
    at world 1 gives ``None``: an in-process store."""
    coord = args.coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not coord and os.environ.get("MASTER_ADDR"):
        coord = (f"{os.environ['MASTER_ADDR']}:"
                 f"{os.environ.get('MASTER_PORT', '29500')}")
    world = world_size_of(args)
    rank = args.process_id if args.process_id is not None \
        else (_int_env("PROCESS_ID", "RANK") or 0)
    local = _int_env("LOCAL_RANK")
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    if world > 1 and not coord:
        raise ValueError(
            f"{world} processes need a rendezvous address: pass "
            "--coordinator_address host:port (or COORDINATOR_ADDRESS, or "
            "torchrun's MASTER_ADDR/MASTER_PORT)")
    if coord and "://" not in coord:
        coord = f"tcp://{coord}"
    return coord, world, rank, rank if local is None else local


def init_runtime(args) -> Tuple[int, int]:
    """Join the process group described by ``args`` and the environment
    (:func:`rendezvous`); returns ``(rank, world)``.

    Always forms a group, at world 1 too, so the strategies run the same
    DDP / ZeRO-3 code as under ``torchrun --nproc_per_node 1``.  On
    ``cuda`` each rank takes card ``local_rank`` (``set_device``): one
    rank per card under ``train.spawn`` (``LOCAL_RANK`` = the worker's
    rank), ``torchrun`` (its ``LOCAL_RANK``) and ``parallel.local.
    run_gang`` (no ``LOCAL_RANK``: the rank itself).  Ranks past the card
    count share cards round-robin, which gloo allows and NCCL refuses at
    its first collective.  Idempotent: a second call returns the group
    already joined."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    from pdnlp_tpu_torch.utils.config import resolve_device

    device = resolve_device(args.device)
    backend = resolve_backend(args.dist_backend, device)
    init_method, world, rank, local = rendezvous(args)
    if device.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    if backend == "nccl" and getattr(args, "fuse_steps", 1) > 1:
        # the captured K-step graphs hold NCCL collectives: PyTorch's notes
        # on CUDA graphs ask for the group's async error handling off
        # before the group is made
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank, timeout=TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Leave the process group (entry points call it at exit)."""
    if dist.is_initialized():
        dist.destroy_process_group()
