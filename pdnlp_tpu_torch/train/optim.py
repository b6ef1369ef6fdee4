"""AdamW with the reference's two weight-decay groups, and the learning-
rate schedules (``pdnlp_tpu/train/optim.py``).

The JAX package runs one ``optax.adamw`` with a decay mask; here the mask
becomes two ``torch.optim.AdamW`` parameter groups — decay
``weight_decay`` for every matrix and embedding, 0 for every bias and for
LayerNorm ``scale``/``bias``.  The two updates are the same decoupled
AdamW: ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, with ``eps``
outside the square root in both (``tests/test_torch_train.py`` holds one
step against optax).  The schedules give optax's values at every step.

Under ``--fuse_steps`` above 1 on a card, for weights that are not
sharded, AdamW is built ``capturable=True`` with each group's learning
rate in a 0-d fp32 tensor on the card: a captured step graph
(``train.steps.build_multi_step``) then reads the step counts and the
rate from device memory, which the schedule fills before each replay
(:func:`group_lrs`), instead of baking host floats into the graph.  The
run's eager steps (a group's remainder) use the same optimizer, so eager
and captured steps run the same arithmetic.  Otherwise the eager step
keeps the host-float rate: capturable AdamW's bias correction on the card
cost the eager step time (PERF.md, PR 8).  The moments are allocated up
front on every device (:func:`init_state`).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch


def is_decayed(name: str) -> bool:
    """Weight decay for parameter ``name``?  Not for any ``bias``, nor for
    anything under a LayerNorm (``ln`` or ``*_ln``) — ``decay_mask``'s
    rule."""
    parts = name.split(".")
    return parts[-1] != "bias" and not any(
        p == "ln" or p.endswith("_ln") for p in parts[:-1])


def decay_groups(model: torch.nn.Module, weight_decay: float
                 ) -> List[Dict]:
    """The two AdamW parameter groups: decayed, then exempt."""
    named = list(model.named_parameters())
    return [
        {"params": [p for n, p in named if is_decayed(n)],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named if not is_decayed(n)],
         "weight_decay": 0.0},
    ]


def count_decayed(model: torch.nn.Module) -> Tuple[int, int]:
    """(decayed, exempt) parameter counts."""
    dec = sum(is_decayed(n) for n, _ in model.named_parameters())
    return dec, len(list(model.parameters())) - dec


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """``optax.linear_schedule``: held at ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def make_schedule(args, total_steps) -> Optional[Callable[[int], float]]:
    """``--lr_schedule`` -> the learning rate at each update count (0 for
    the first update), optax's values; ``None`` for the reference's
    constant rate.  Raises when a schedule is set without a positive
    ``total_steps`` (a silently constant rate is the failure it guards)."""
    if not getattr(args, "lr_schedule", None):
        return None
    if not total_steps:
        raise ValueError(
            f"--lr_schedule {args.lr_schedule!r} needs a positive "
            f"total_steps to size warmup/decay; got {total_steps!r}")
    lr = args.learning_rate
    w = max(1, int(total_steps * args.warmup_ratio))
    if args.lr_schedule == "warmup_linear":
        return lambda c: (_linear(0.0, lr, w, c) if c < w
                          else _linear(lr, 0.0, total_steps - w, c - w))
    if args.lr_schedule == "warmup_cosine":
        decay = total_steps - w
        if decay <= 0:
            raise ValueError(f"warmup_cosine needs total_steps > warmup "
                             f"steps, got {total_steps} <= {w}")

        def cosine(c):
            if c < w:
                return _linear(0.0, lr, w, c)
            t = min(c - w, decay)
            return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return cosine
    raise ValueError(f"unknown lr_schedule {args.lr_schedule!r} "
                     "(warmup_linear|warmup_cosine)")


def build_optimizer(model: torch.nn.Module, args, total_steps=None):
    """``(AdamW, LambdaLR or None)`` from ``Args`` (lr 3e-5, betas
    0.9/0.999, eps 1e-6, decay 0.01 by default).  Step the scheduler after
    each optimizer step: update ``k`` (from 0) then runs at
    ``schedule(k)``.  Capturable on a card under ``--fuse_steps`` above
    1 (module docstring); the state is allocated up front on every device
    (:func:`init_state`)."""
    params = list(model.parameters())
    capturable = (params[0].device.type == "cuda"
                  and getattr(args, "fuse_steps", 1) > 1
                  and not any(hasattr(p, "to_local") for p in params))
    lr = args.learning_rate
    if capturable:
        lr = torch.tensor(float(lr), dtype=torch.float32,
                          device=params[0].device)
    groups = decay_groups(model, args.weight_decay)
    if capturable:      # one rate tensor per group, as LambdaLR fills them
        for g in groups[1:]:
            g["lr"] = lr.clone()
    opt = torch.optim.AdamW(
        groups, lr=lr, betas=(args.adam_b1, args.adam_b2), eps=args.adam_eps,
        capturable=capturable)
    init_state(opt)
    schedule = make_schedule(args, total_steps)
    if schedule is None:
        return opt, None
    lr = args.learning_rate
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda c: schedule(c) / lr)
    if capturable:
        # host-float bases, as on the CPU: the rates are computed in Python
        # (no device arithmetic, no fetch) and filled into the tensors
        sched.base_lrs = [float(lr)] * len(opt.param_groups)
        for g, r in zip(opt.param_groups, group_lrs(sched, 0)[0]):
            g["lr"].fill_(r)
        sched._last_lr = group_lrs(sched, 0)[0]
    return opt, sched


def init_state(opt: torch.optim.Optimizer) -> None:
    """Allocate AdamW's state for every parameter now, as its first
    ``step`` would (zero moments, a zero step count on the parameter's
    device when capturable): a graph captured before that step must find
    the state in place, and a copy of the state taken before the first
    step (``train.steps.snapshot_state``) holds every tensor a step
    writes."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if st:
                continue
            dev = p.device if group["capturable"] else "cpu"
            st["step"] = torch.zeros((), dtype=torch.float32, device=dev)
            st["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)


def group_lrs(scheduler, k: int) -> List[List[float]]:
    """The learning rates the next ``k`` updates of each parameter group
    run at, as ``LambdaLR`` would set them step by step: update ``i``
    runs at ``base_lr * lambda(last_epoch + i)``.  Row ``i`` holds the
    groups' rates for update ``i``; row ``k`` those after the last one."""
    c = scheduler.last_epoch
    return [[base * fn(c + i) for fn, base in
             zip(scheduler.lr_lambdas, scheduler.base_lrs)]
            for i in range(k + 1)]


def advance_schedule(scheduler, k: int) -> None:
    """Move ``LambdaLR``'s count on by ``k`` updates without touching the
    groups' rate tensors (a replayed graph has written them)."""
    scheduler.last_epoch += k
    scheduler._last_lr = [base * fn(scheduler.last_epoch) for fn, base in
                          zip(scheduler.lr_lambdas, scheduler.base_lrs)]
