"""Sharded experiment assembly and the parallel steps — the twin of
``pdnlp_tpu/parallel/execution.py``.

- :func:`setup_sharded_model`: the train state with its placement — the
  same seeded weights on every rank (a CPU generator), dropout seeded from
  ``(seed, rank)``, the :class:`~pdnlp_tpu_torch.train.steps.
  TrainObjective` wrapped by the mode (``parallel.sharding.wrap``), and the
  optimizer built on the placed parameters (FSDP2's shards).
- :func:`make_parallel_train_step` / :func:`make_parallel_eval_step`: the
  single-device step and eval through the wrapper, which inserts the
  gradient all-reduce (DDP) or all-gather / reduce-scatter (FSDP2); the
  step's loss and accuracy are summed over the ranks.
- :func:`make_shardmap_train_step`: the explicit-collectives flavour
  (Horovod's analog): no wrapper; after ``backward`` one hand-written
  all-reduce of every gradient, optionally bf16 on the wire, then the same
  optimizer update on every rank.

Each rank's step is the single-device step: at attention dropout 0 it runs
the flash kernels K1-K3 in every layer and the fused CE kernels K4/K5.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from pdnlp_tpu_torch.models.bert import BertClassifier
from pdnlp_tpu_torch.models.config import BertConfig, args_overrides, get_config
from pdnlp_tpu_torch.parallel import collectives
from pdnlp_tpu_torch.parallel.sharding import check_mode, wrap
from pdnlp_tpu_torch.train.optim import build_optimizer
from pdnlp_tpu_torch.train.steps import (
    TrainObjective, TrainState, build_eval_step, build_train_step,
    compute_grads, init_ema, matmul_weights,
)
from pdnlp_tpu_torch.utils.config import resolve_device
from pdnlp_tpu_torch.utils.seeding import set_seed


def dropout_seed(seed: int, rank: int) -> int:
    """Rank ``rank``'s dropout seed: distinct per rank, as JAX's shard_map
    step folds ``axis_index`` into its key; rank 0 keeps ``seed``."""
    return int(seed) + int(rank) * 2 ** 32


def check_zero(args, mode: str) -> None:
    """Raise for what the port does not run under ``zero`` yet (ROADMAP
    A7): the EMA, and ``--grads_dtype compute``."""
    if mode != "zero":
        return
    if args.ema_decay > 0:
        raise ValueError("--ema_decay under zero is not in the PyTorch port "
                         "yet (ROADMAP A7): the EMA would shadow FSDP2's "
                         "shards; use dp")
    if compute_grads(args):
        raise ValueError("--grads_dtype compute under zero is not in the "
                         "PyTorch port yet (ROADMAP A7): FSDP2 gathers and "
                         "reduces whole modules in one dtype; use dp")


def setup_sharded_model(args, vocab_size: int, mesh, mode: str = "dp",
                        total_steps=None, explicit_collectives: bool = False
                        ) -> Tuple[BertConfig, TrainState]:
    """``(cfg, state)`` on this rank's card (or the CPU), placed by
    ``mode``; ``explicit_collectives`` leaves the objective unwrapped (the
    shard_map step reduces the gradients itself) after broadcasting rank
    0's weights.  ``total_steps`` sizes the optional ``--lr_schedule``."""
    check_mode(mode)
    check_zero(args, mode)
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(args.model, vocab_size=vocab_size,
                     num_labels=args.num_labels, dropout=args.dropout,
                     attn_dropout=args.attn_dropout, **args_overrides(args))
    init_gen, dropout_gen = set_seed(args.seed, device)
    dropout_gen.manual_seed(dropout_seed(args.seed, dist.get_rank()))
    model = BertClassifier(cfg, generator=init_gen).to(device)
    group = mesh.get_group()
    objective = TrainObjective(model, args, device, group=group)
    if explicit_collectives:
        for p in model.parameters():
            dist.broadcast(p.data, src=0, group=group)
    else:
        objective = wrap(objective, mode, mesh, device)
    optimizer, scheduler = build_optimizer(model, args, total_steps)
    ema = init_ema(model) if args.ema_decay > 0 else None
    return cfg, TrainState(model, optimizer, scheduler, dropout_gen, ema,
                           objective=objective)


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
        named = list(state.model.named_parameters())
        if compute:
            mm = set(matmul_weights(state.model))
            collectives.grad_reduce([p.grad for n, p in named if n in mm],
                                    group=group,
                                    compress_dtype=torch.bfloat16)
            named = [(n, p) for n, p in named if n not in mm]
        collectives.grad_reduce([p.grad for _, p in named], group=group,
                                compress_dtype=compress)

    return reduce_grads


def make_parallel_train_step(args, mesh, device):
    """The dp / zero step: the wrapped objective's forward and backward
    (the wrapper's collectives inside), the optimizer on the rank's
    replica or shard, and the loss and correct count summed over the
    ranks (each rank's share is already scaled by ``lw / gw``).  Under
    ``--grads_dtype compute`` DDP's reduction is off and the step reduces
    the gradients itself (``train.steps.build_train_step``)."""
    group = mesh.get_group()
    after = _grad_reduce(group, None, True) if compute_grads(args) else None
    return build_train_step(args, device, after_backward=after,
                            reduce_metrics=_metric_sum(group))


def make_parallel_eval_step(args, state: TrainState):
    """The eval step through the placed objective (FSDP2 unshards the
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
    group = mesh.get_group()
    compress = torch.bfloat16 if compress_grads else None
    # one wire dtype for every gradient, as JAX's shard_map step, which
    # takes no ``--grads_dtype`` (the compute path's gradients are the
    # same values: bf16 ones, widened)
    return build_train_step(
        args, device, after_backward=_grad_reduce(group, compress, False),
        reduce_metrics=_metric_sum(group))
