"""Data-parallel training — the twins of ``multi-tpu-jax-cls.py`` (DDP),
``multi-tpu-dataparallel-cls.py`` (``nn.DataParallel``),
``multi-tpu-zero-cls.py`` (DeepSpeed ZeRO-3), ``multi-tpu-shardmap-cls.py``
(Horovod) and ``multi-tpu-amp-cls.py`` (DDP + AMP), one process per rank:

    torchrun --nproc_per_node 2 -m pdnlp_tpu_torch.train.multi --strategy dp
    COORDINATOR_ADDRESS=host0:29500 NUM_PROCESSES=2 PROCESS_ID=$RANK \\
        python -m pdnlp_tpu_torch.train.multi --strategy zero
    python -m pdnlp_tpu_torch.train.spawn --strategy dp --num_processes 2

``--strategy`` sets what the JAX scripts set:

- ``dp``: DDP, every rank ``train_batch_size`` rows (144 steps at 2 ranks);
- ``dataparallel``: one ``train_batch_size``-row global batch split over
  the ranks (288 steps at any width);
- ``zero``: FSDP2 with ``--remat true``;
- ``shardmap``: the hand-written bf16 gradient all-reduce;
- ``amp``: DDP with ``--dtype bfloat16`` (bf16 needs no loss scaler).

Explicit flags override those defaults (``--remat false``, ``--dtype``,
``--mode zero``).  Runs on ``cuda`` unless ``--device cpu`` is given, over
NCCL there and gloo on the CPU (``--dist_backend`` names another); every
run forms a process group, of one rank too.  Each rank's step runs the
flash kernels and the fused CE kernels at ``--attn_dropout 0``.  The
checkpoint (``<output_dir>/<strategy>-cls.pt``, written by rank 0) is the
port's own format, which ``serve.cli --checkpoint`` serves.
"""
from __future__ import annotations

import sys

from pdnlp_tpu_torch.parallel.execution import check_zero
from pdnlp_tpu_torch.parallel.sharding import check_mode
from pdnlp_tpu_torch.train.single import NOT_PORTED, refuse_not_ported

#: --strategy -> (Args defaults, run_parallel knobs), as the JAX scripts
STRATEGIES = {
    "dp": ({"mode": "dp"}, {}),
    "dataparallel": ({"mode": "dp"}, {"scale_batch": False}),
    "zero": ({"mode": "zero", "remat": True}, {}),
    "shardmap": ({"mode": "dp"}, {"explicit_collectives": True}),
    "amp": ({"mode": "dp", "dtype": "bfloat16"}, {}),
}

#: what this entry point refuses by name: the single-device table (less
#: what it has), plus the data-parallel paths still to port
MULTI_NOT_PORTED = {
    **{k: v for k, v in NOT_PORTED.items()
       if k not in ("--elastic", "--heartbeat_interval")},
    "--fuse_steps": ("1", "K steps per dispatch under a process group: "
                     "the captured graph needs NCCL's capturable "
                     "collectives (ROADMAP A7)"),
    "--offload_opt_state": ("false", "Adam moments in host memory, FSDP2's "
                            "CPUOffloadPolicy (ROADMAP A7)"),
    "--elastic": (None, "elastic restart (ROADMAP A11)"),
    "--heartbeat_interval": (None, "heartbeats (ROADMAP A11)"),
    "--stall_timeout": (None, "the gang supervisor (ROADMAP A11)"),
}


def parse(argv, prog: str = "train.multi"):
    """``(args, knobs)`` for ``argv``: ``--strategy`` first (it picks the
    defaults), then the refusals, then every ``Args`` flag."""
    from pdnlp_tpu_torch.utils.config import Args, parse_cli, pop_cli_flag

    argv, strategy = pop_cli_flag(argv, "--strategy", "dp")
    if strategy not in STRATEGIES:
        raise SystemExit(f"{prog}: --strategy must be one of "
                         f"{sorted(STRATEGIES)}, got {strategy!r}")
    defaults, knobs = STRATEGIES[strategy]
    argv = refuse_not_ported(argv, MULTI_NOT_PORTED, prog=prog)
    args = parse_cli(argv, base=Args(strategy=strategy, **defaults))
    try:
        check_mode(args.mode)
        check_zero(args, args.mode)
    except ValueError as e:
        raise SystemExit(f"{prog}: {e}") from None
    return args, {"mode": args.mode, **knobs}


def main(argv) -> float:
    from pdnlp_tpu_torch.parallel.runtime import shutdown
    from pdnlp_tpu_torch.train.run import run_parallel

    args, knobs = parse(argv)
    try:
        return run_parallel(args, **knobs)
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
