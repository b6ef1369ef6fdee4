"""Rank-0 printing with the reference's line formats, byte for byte
(``pdnlp_tpu/utils/logging.py``; the rates line is
``utils.profiling.StepStats.line``):
``【train】 epoch：1/1 step：10/288 loss：1.791759``, ``【dev】 loss：...
accuracy：...``, ``【best accuracy】 ...`` and ``耗时：X分钟``.
"""
from __future__ import annotations

import sys

import torch


def is_rank0() -> bool:
    return not (torch.distributed.is_available()
                and torch.distributed.is_initialized()) \
        or torch.distributed.get_rank() == 0


def rank0_print(*args, **kw) -> None:
    if is_rank0():
        print(*args, **kw)
        sys.stdout.flush()


def fmt_train(epoch, epochs, step, total_step, loss) -> str:
    return f"【train】 epoch：{epoch}/{epochs} step：{step}/{total_step} loss：{loss:.6f}"


def fmt_dev(loss, accuracy) -> str:
    return f"【dev】 loss：{loss:.6f} accuracy：{accuracy:.4f}"


def fmt_best(accuracy) -> str:
    return f"【best accuracy】 {accuracy:.4f}"


def fmt_elapsed_minutes(minutes: float) -> str:
    return f"耗时：{minutes}分钟"
