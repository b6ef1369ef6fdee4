"""Multi-rank training — the twins of ``multi-tpu-jax-cls.py`` (DDP),
``multi-tpu-dataparallel-cls.py`` (``nn.DataParallel``),
``multi-tpu-zero-cls.py`` (DeepSpeed ZeRO-3), ``multi-tpu-shardmap-cls.py``
(Horovod), ``multi-tpu-amp-cls.py`` (DDP + AMP), ``multi-tpu-tp-cls.py``
(tensor parallelism), ``multi-tpu-moe-cls.py`` (an MoE model under
expert parallelism), ``multi-tpu-pp-cls.py`` (GPipe stages) and
``multi-tpu-sp-cls.py`` (ring attention over a seq axis), one process per
rank:

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
- ``amp``: DDP with ``--dtype bfloat16`` (bf16 needs no loss scaler);
- ``tp``: heads and MLP features split over a ``model`` axis, default
  mesh ``{"data": 1, "model": world}``;
- ``ep``: ``bert-base-moe`` with its experts split over an ``expert``
  axis; the default mesh gives the axis the largest degree that divides
  both the world and the expert count, and the rest of the ranks to
  ``data`` (one card: ``{"data": 1, "expert": 1}``);
- ``pp``: the layers in ``world`` contiguous stage slices, default mesh
  ``{"stage": world}``, ``--microbatches`` M (4) per step;
- ``sp``: the sequence split over a ``seq`` axis with ring attention,
  default mesh ``{"data": 1, "seq": world}``.

``--mode pp|sp`` (the JAX spawn launcher's flag) runs the same paths.

Explicit flags override those defaults (``--remat false``, ``--dtype``,
``--mode zero``); ``--init_from`` / ``--init_head`` warm-start the model
before it is placed (under zero the loaded weights are what is sharded).  Runs on ``cuda`` unless ``--device cpu`` is given, over
NCCL there and gloo on the CPU (``--dist_backend`` names another); every
run forms a process group, of one rank too.  Each rank's step runs the
flash kernels and the fused CE kernels at ``--attn_dropout 0``.  The
checkpoint (``<output_dir>/<strategy>-cls.pt``, written by rank 0) is the
port's own format, which ``serve.cli --checkpoint`` serves.
"""
from __future__ import annotations

import sys

from pdnlp_tpu_torch.parallel.execution import check_sp, check_zero
from pdnlp_tpu_torch.parallel.runtime import world_size_of
from pdnlp_tpu_torch.parallel.sharding import check_mode
from pdnlp_tpu_torch.train.single import NOT_PORTED, refuse_not_ported

#: --strategy -> (Args defaults, run_parallel knobs), as the JAX scripts
STRATEGIES = {
    "dp": ({"mode": "dp"}, {}),
    "dataparallel": ({"mode": "dp"}, {"scale_batch": False}),
    "zero": ({"mode": "zero", "remat": True}, {}),
    "shardmap": ({"mode": "dp"}, {"explicit_collectives": True}),
    "amp": ({"mode": "dp", "dtype": "bfloat16"}, {}),
    "tp": ({"mode": "tp"}, {}),
    "ep": ({"mode": "ep", "model": "bert-base-moe"}, {}),
    "pp": ({"mode": "pp"}, {}),
    "sp": ({"mode": "sp"}, {}),
}

#: what this entry point refuses by name: the single-device table, plus
#: the data-parallel paths still to port
MULTI_NOT_PORTED = {
    **NOT_PORTED,
    "--fuse_steps": ("1", "K steps per dispatch under a process group: "
                     "the captured graph needs NCCL's capturable "
                     "collectives (ROADMAP A7)"),
    "--offload_opt_state": ("false", "Adam moments in host memory, FSDP2's "
                            "CPUOffloadPolicy (ROADMAP A7)"),
}


def default_mesh(args, world: int):
    """The mesh a strategy takes when ``--mesh_shape`` is not given, as the
    JAX scripts choose it: ``tp`` ``{"data": 1, "model": world}``
    (``multi-tpu-tp-cls.py:29-31``); ``ep`` the largest expert degree
    ``d <= min(world, experts)`` dividing both, the rest to ``data``
    (``multi-tpu-moe-cls.py:30-42``); ``pp`` ``{"stage": world}`` and
    ``sp`` ``{"data": 1, "seq": world}`` (JAX ``train/run.py:188, 234``);
    else None (one data axis)."""
    from pdnlp_tpu_torch.models.config import args_overrides, get_config

    if args.mode == "tp":
        return {"data": 1, "model": world}
    if args.mode == "pp":
        return {"stage": world}
    if args.mode == "sp":
        return {"data": 1, "seq": world}
    if args.mode == "ep":
        experts = get_config(args.model, **args_overrides(args)).moe_experts
        e = next((d for d in range(min(world, experts), 0, -1)
                  if experts % d == 0 and world % d == 0), 1)
        return {"data": world // e, "expert": e}
    return None


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
        if args.mesh_shape is None:
            args = args.replace(mesh_shape=default_mesh(
                args, world_size_of(args)))
        # the axes and degrees the mode needs (their sizes against the
        # world are checked when the mesh is made)
        from pdnlp_tpu_torch.models.config import args_overrides, get_config
        from pdnlp_tpu_torch.parallel.sharding import check_mesh, check_model

        dims = args.mesh_shape or {"data": -1}
        check_mesh(args.mode, dims)
        cfg = get_config(args.model, **args_overrides(args))
        check_model(cfg, args.mode, dims, args.model)
        if args.mode == "pp" and dims["stage"] > 0:
            from pdnlp_tpu_torch.parallel.pp import check_pp

            check_pp(args, cfg, dims["stage"])
        if args.mode == "sp":
            check_sp(args, cfg)
    except ValueError as e:
        raise SystemExit(f"{prog}: {e}") from None
    return args, {"mode": args.mode, **knobs}


def main(argv, prog: str = "train.multi") -> float:
    from pdnlp_tpu_torch.parallel.runtime import shutdown
    from pdnlp_tpu_torch.train import run

    args, knobs = parse(argv, prog=prog)
    try:
        if args.mode == "pp":
            return run.run_pipeline(args)
        if args.mode == "sp":
            return run.run_sp(args)
        return run.run_parallel(args, **knobs)
    finally:
        shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
