"""AdamW with the reference's two weight-decay groups, and the learning-
rate schedules (``pdnlp_tpu/train/optim.py``).

The JAX package runs one ``optax.adamw`` with a decay mask; here the mask
becomes two ``torch.optim.AdamW`` parameter groups — decay
``weight_decay`` for every matrix and embedding, 0 for every bias and for
LayerNorm ``scale``/``bias``.  The two updates are the same decoupled
AdamW: ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, with ``eps``
outside the square root in both (``tests/test_torch_train.py`` holds one
step against optax).  The schedules give optax's values at every step.
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
    ``schedule(k)``."""
    opt = torch.optim.AdamW(
        decay_groups(model, args.weight_decay), lr=args.learning_rate,
        betas=(args.adam_b1, args.adam_b2), eps=args.adam_eps)
    schedule = make_schedule(args, total_steps)
    if schedule is None:
        return opt, None
    lr = args.learning_rate
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda c: schedule(c) / lr)
