"""Sharded experiment assembly and the parallel steps — the twin of
``pdnlp_tpu/parallel/execution.py``.

- :func:`setup_sharded_model`: the train state with its placement — the
  same seeded weights on every rank (a CPU generator), cut to the rank's
  share under ``tp`` and ``ep`` (``parallel.sharding.shard_model``),
  dropout seeded from ``(seed, data coordinate)``, the
  :class:`~pdnlp_tpu_torch.train.steps.TrainObjective` wrapped by the mode
  (``parallel.sharding.wrap``), and the optimizer built on the placed
  parameters (zero's shards, or the tp/ep slices).  On the CPU a rank of
  a tp/ep group of two or more runs one intra-op thread.
- :func:`make_parallel_train_step` / :func:`make_parallel_eval_step`: the
  single-device step and eval through the wrapper, which inserts the
  gradient all-reduce (DDP) or all-gather / reduce-scatter (zero's
  ``parallel.sharding.ZeroObjective``); under
  ``tp`` and ``ep`` the step all-reduces the gradients over the data axis
  after the backward; the step's loss and accuracy are summed over the
  data axis.
- ``pp`` and ``sp`` place here too (the stage's layer slice, or the whole
  model on every rank of a seq group); their steps are
  ``parallel.pp.make_pp_train_step`` and ``parallel.sp.make_sp_train_step``.
- :func:`make_shardmap_train_step`: the explicit-collectives flavour
  (Horovod's analog): no wrapper; after ``backward`` one hand-written
  all-reduce of every gradient, optionally bf16 on the wire, then the same
  optimizer update on every rank.

Each rank's step is the single-device step: at attention dropout 0 it runs
the flash kernels K1-K3 in every layer (on the rank's heads under ``tp``)
and the fused CE kernels K4/K5.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from pdnlp_tpu_torch.models.bert import BertClassifier
from pdnlp_tpu_torch.models.config import BertConfig, args_overrides, get_config
from pdnlp_tpu_torch.parallel import collectives
from pdnlp_tpu_torch.parallel.mesh import (
    DATA_AXIS, SEQ_AXIS, STAGE_AXIS, axis_group, axis_index, axis_size,
    mesh_shape,
)
from pdnlp_tpu_torch.parallel.sharding import (
    MODE_AXIS, check_mesh, check_mode, check_model, model_shards,
    shard_model, wrap,
)
from pdnlp_tpu_torch.train.optim import build_optimizer
from pdnlp_tpu_torch.train.precision import resolve_dtype
from pdnlp_tpu_torch.train.setup import warm_start
from pdnlp_tpu_torch.train.steps import (
    TrainObjective, TrainState, build_eval_step, build_train_step,
    compute_grads, init_ema, matmul_weights,
)
from pdnlp_tpu_torch.utils.config import resolve_device
from pdnlp_tpu_torch.utils.seeding import set_seed


def dropout_seed(seed: int, rank: int) -> int:
    """The dropout seed of data coordinate ``rank``: distinct per data
    shard, as JAX's shard_map step folds ``axis_index`` into its key; 0
    keeps ``seed``.  Every rank of one model or expert group has the same
    data coordinate, so it draws the same masks, and the activations its
    ranks replicate stay equal."""
    return int(seed) + int(rank) * 2 ** 32


def dropout_coordinate(mesh, mode: str) -> int:
    """The coordinate a rank's dropout stream folds in: its data index, and
    under ``pp`` and ``sp`` its place along ``stage`` or ``seq`` too (JAX
    folds ``axis_index`` of both into the key), so each stage and each
    sequence slice draws its own masks."""
    coord = axis_index(mesh, DATA_AXIS)
    axis = {"pp": STAGE_AXIS, "sp": SEQ_AXIS}.get(mode)
    if axis is not None:
        coord = coord * axis_size(mesh, axis) + axis_index(mesh, axis)
    return coord


def check_sp(args, cfg) -> None:
    """JAX's sequence-parallel refusals: the EMA (``sp.py:106-109``) and
    MoE layers (``bert.py:333-335``)."""
    if args.ema_decay > 0:
        raise ValueError("--ema_decay runs on the jit strategies (dp/zero/"
                         "tp/ep) — the sequence-parallel step does not "
                         "maintain the EMA tree")
    if cfg.moe_experts:
        raise ValueError("MoE layers are not supported on the "
                         "sequence-parallel (ring attention) path")


#: the modes whose step ``--fuse_steps`` K > 1 captures as one CUDA graph
#: (K steps, their collectives inside); pp, sp and the explicit-
#: collectives step run K = 1, as JAX's ``eff_k`` does
CAPTURED_MODES = ("dp", "zero", "tp", "ep")

OFFLOAD_REFUSAL = (
    "--offload_opt_state works with the jit dp/zero strategies, not "
    "shard_map, fused multi-steps, or tp — the staged host<->device "
    "transfers are only wired into the plain data-axis train step")


def check_strategy(args, mode: str, explicit_collectives: bool = False
                   ) -> None:
    """What the multi-rank paths refuse: JAX's offload rule
    (``train/run.py:54-59``, its wording)."""
    fuse = getattr(args, "fuse_steps", 1)
    if getattr(args, "offload_opt_state", False) and (
            explicit_collectives or fuse > 1 or mode == "tp"):
        raise ValueError(OFFLOAD_REFUSAL)


def fused_reduce(args, mesh, mode: str,
                 explicit_reduce: Optional[bool] = None) -> bool:
    """Does the dp step reduce its gradients itself?  ``explicit_reduce``
    when given (True forces it, at data width 1 too), else under
    ``--fuse_steps`` K > 1 over several data ranks: no DDP (its reducer's
    hooks and futures do not capture), the explicit bucketed all-reduce of
    ``collectives.grad_reduce`` instead, in DDP's bucket order and at its
    values (a mean of fp32 gradients), which a CUDA graph holds on NCCL.
    Never for another mode."""
    if mode != "dp":
        return False
    if explicit_reduce is not None:
        return explicit_reduce
    return getattr(args, "fuse_steps", 1) > 1 and \
        axis_size(mesh, DATA_AXIS) > 1


def check_capture_backend(args, mode: str, device, group=None,
                          explicit_reduce: bool = False) -> None:
    """A captured step on the card holds its collectives, which only NCCL
    can put in a CUDA graph: refuse ``--fuse_steps`` K > 1 on ``cuda``
    over another backend where the step has a collective (zero's always
    has)."""
    if device.type != "cuda" or getattr(args, "fuse_steps", 1) <= 1 or \
            mode not in CAPTURED_MODES or not dist.is_initialized():
        return
    if (collectives.world_size() > 1 or explicit_reduce
            or mode == "zero") and dist.get_backend(group) != "nccl":
        raise ValueError(
            f"--fuse_steps {args.fuse_steps} on cuda captures each group of "
            "steps, its collectives included, in one CUDA graph, which needs "
            f"NCCL; this process group runs {dist.get_backend(group)} — "
            "use --dist_backend nccl (the default on cuda) or --fuse_steps 1")


def setup_sharded_model(args, vocab_size: int, mesh, mode: str = "dp",
                        total_steps=None, explicit_collectives: bool = False,
                        explicit_reduce: Optional[bool] = None
                        ) -> Tuple[BertConfig, TrainState]:
    """``(cfg, state)`` on this rank's card (or the CPU), placed by
    ``mode``; ``explicit_collectives`` leaves the objective unwrapped (the
    shard_map step reduces the gradients itself) after broadcasting rank
    0's weights, and so does ``explicit_reduce`` under dp (default
    :func:`fused_reduce`; ``True`` forces it, a process group of one
    rank included, so a captured step holds a real all-reduce).  zero's
    objective always runs its collectives, at world 1 too
    (``parallel.sharding.ZeroObjective``).  ``total_steps`` sizes the optional ``--lr_schedule``.  ``--init_from``
    loads before the placement (``train.setup.warm_start``): under
    ``zero`` the loaded leaves go to their shards, and an EMA starts from
    the warm-started weights, placed as the params are (one shard per
    rank under zero).  AdamW is capturable only where ``--fuse_steps``
    captures the step (:data:`CAPTURED_MODES`), runs on the shards under
    zero (``train.optim.ZeroAdamW``), and keeps its moments in host memory under ``--offload_opt_state``."""
    check_mode(mode)
    check_strategy(args, mode, explicit_collectives)
    shape = mesh_shape(mesh)
    check_mesh(mode, shape)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.model, vocab_size=vocab_size,
                     num_labels=args.num_labels, dropout=args.dropout,
                     attn_dropout=args.attn_dropout, **args_overrides(args))
    check_model(cfg, mode, shape, args.model)
    if mode == "pp":
        from pdnlp_tpu_torch.parallel.pp import check_pp

        check_pp(args, cfg, shape[STAGE_AXIS])
    if mode == "sp":
        check_sp(args, cfg)
    if device.type == "cpu" and mode in MODE_AXIS and \
            axis_size(mesh, MODE_AXIS[mode]) > 1:
        # the weights a model or expert group replicates are updated on
        # each rank from the gradients it computes itself, and with several
        # intra-op threads the CPU backward of the embedding gather is not
        # the same bits from process to process: the replicas would drift
        torch.set_num_threads(1)
    explicit_reduce = fused_reduce(args, mesh, mode, explicit_reduce)
    init_gen, dropout_gen = set_seed(args.seed, device)
    dropout_gen.manual_seed(dropout_seed(args.seed,
                                         dropout_coordinate(mesh, mode)))
    # the full seeded init (and warm start) on the host, then this rank's
    # share of it: the model at any width is the model at width 1
    model = warm_start(BertClassifier(cfg, generator=init_gen), args)
    model = shard_model(model, model_shards(mesh, mode))
    if mode == "pp":
        from pdnlp_tpu_torch.parallel.pp import stage_model, stage_of

        model = stage_model(model, stage_of(mesh, cfg.num_layers))
    model = model.to(device)
    group = axis_group(mesh, DATA_AXIS)
    # one rank on the data axis: the single-device objective, with no
    # collective (a captured step can hold it), but for zero's, which
    # gathers and reduces its shards at any width; pp and sp steps reduce
    # their gradients themselves, and pp's MoE statistics are each
    # microbatch's own
    single = (axis_size(mesh, DATA_AXIS) == 1 or mode in ("pp", "sp")) \
        and not explicit_collectives and not explicit_reduce \
        and mode != "zero"
    objective = TrainObjective(model, args, device,
                               group=None if single else group,
                               global_aux=not explicit_collectives)
    if explicit_collectives:
        for p in model.parameters():
            dist.broadcast(p.data, src=0, group=group)
    else:
        objective = wrap(objective, mode, mesh, device,
                         compute_dtype=(resolve_dtype(args.dtype)
                                        if compute_grads(args) else None),
                         explicit_reduce=explicit_reduce)
    captured = mode in CAPTURED_MODES and not explicit_collectives
    optimizer, scheduler = build_optimizer(
        model, args, total_steps,
        capturable=captured and getattr(args, "fuse_steps", 1) > 1)
    ema = init_ema(model) if args.ema_decay > 0 else None
    return cfg, TrainState(model, optimizer, scheduler, dropout_gen, ema,
                           objective=objective, group=group)


def _metric_sum(group):
    def reduce_metrics(loss, correct):
        both = torch.stack([loss, correct.to(loss.dtype)])
        dist.all_reduce(both, group=group)
        return both[0], both[1]

    return reduce_metrics


def _grad_reduce(group, compress, compute: bool):
    """``after_backward``: every gradient mean-reduced over the ranks,
    ``compress`` on the wire; under ``--grads_dtype compute`` the matmul
    weights' gradients (bf16 values) go in bf16 whatever ``compress``, as
    JAX's all-reduce of the bf16 gradient leaves does."""
    def reduce_grads(state: TrainState) -> None:
        reduce_model_grads(state.model, group, compress, compute)

    return reduce_grads


def reduce_model_grads(model, group, compress=None,
                       compute: bool = False) -> None:
    """:func:`_grad_reduce`'s reduction of ``model``'s gradients, in
    ``collectives.grad_reduce``'s buckets."""
    named = list(model.named_parameters())
    if compute:
        mm = set(matmul_weights(model))
        collectives.grad_reduce([p.grad for n, p in named if n in mm],
                                group=group, compress_dtype=torch.bfloat16)
        named = [(n, p) for n, p in named if n not in mm]
    collectives.grad_reduce([p.grad for _, p in named], group=group,
                            compress_dtype=compress)


def make_parallel_train_step(args, mesh, device, mode: str = "dp",
                             explicit_reduce: Optional[bool] = None):
    """The dp / zero / tp / ep step: the placed objective's forward and
    backward (the wrapper's or the layers' collectives inside), the
    optimizer on the rank's replica, shard or slices, and the loss and
    correct count summed over the data axis (each rank's share is already
    scaled by ``lw / gw``).  The step reduces the gradients over the data
    axis itself under ``tp`` and ``ep`` (no wrapper) and under dp with
    ``explicit_reduce`` (default :func:`fused_reduce`: the fused dp step,
    in DDP's buckets; under ``--grads_dtype compute`` the matmul weights'
    bf16 gradients go in bf16, as through DDP the step does itself,
    ``train.steps.build_train_step``).  Under zero the step reduce-scatters
    the gradients to the shards after the backward
    (``ZeroObjective.reduce_grads``), at any width.  Where the data axis
    has one rank and nothing is forced it is the single-device step."""
    group = axis_group(mesh, DATA_AXIS)
    explicit_reduce = fused_reduce(args, mesh, mode, explicit_reduce)
    sharded = mode == "zero"
    if axis_size(mesh, DATA_AXIS) == 1 and not explicit_reduce \
            and not sharded:
        # nothing to reduce: the single-device step (which fuse_steps can
        # capture)
        return build_train_step(args, device)
    after = None
    if mode in MODE_AXIS or explicit_reduce:
        after = _grad_reduce(group, None, compute_grads(args))
    return build_train_step(args, device, after_backward=after,
                            reduce_metrics=_metric_sum(group))


def make_parallel_eval_step(args, state: TrainState):
    """The eval step through the placed objective (zero's gathers the
    weights in its forward); per-rank outputs, which the ``Trainer``
    sums and all-gathers (``collectives.output_reduce``)."""
    return build_eval_step(args, forward=state.objective)


def make_shardmap_train_step(args, mesh, device, compress_grads: bool = True):
    """Explicit-collectives train step (Horovod analog): local forward and
    backward on the rank's shard — the objective already scaled by ``world
    * lw / gw`` — then one all-reduce of all the gradients, mean over the
    ranks, in bf16 on the wire with ``compress_grads``
    (``hvd.Compression.fp16``), then the same AdamW update on every rank.
    The mean of the scaled gradients is the global weighted-mean gradient,
    exact for uneven shards.  Refuses ``--ema_decay``, as JAX does."""
    if args.ema_decay > 0:
        raise ValueError("--ema_decay runs on the dp strategies — the "
                         "shard_map step does not maintain the EMA and "
                         "would silently evaluate stale weights")
    group = axis_group(mesh, DATA_AXIS)
    compress = torch.bfloat16 if compress_grads else None
    # one wire dtype for every gradient, as JAX's shard_map step, which
    # takes no ``--grads_dtype`` (the compute path's gradients are the
    # same values: bf16 ones, widened)
    return build_train_step(
        args, device, after_backward=_grad_reduce(group, compress, False),
        reduce_metrics=_metric_sum(group))
