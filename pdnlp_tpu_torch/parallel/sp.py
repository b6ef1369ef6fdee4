"""Sequence parallelism — training over a ``{"data": D, "seq": N}`` mesh,
the twin of ``pdnlp_tpu/parallel/sp.py``.

Every rank holds the whole model.  Each rank of a data shard takes its
``[B, S / N]`` slice of the shard's token channels (:func:`sp_local`),
attention runs as ring attention over the ``seq`` group (``ops.ring``),
and the head reads the [CLS] rows through a ``psum`` over the group, so
every rank of the group computes the same logits (``models.bert.
BertClassifier.classify``).  The loss is gated to seq-shard 0: its
backward reaches every shard through the ``psum``, each shard
backpropagates its own slice, and the plain sum of the gradients over
``seq`` counts the head once.  Over ``data`` the gradients are
weight-averaged, as the explicit-collectives dp step does: each shard's
objective is scaled by its weight over the global weight (``max(·, 1)``
guarded), and one all-reduce sums the gradients over the whole mesh.

No TPU kernel is on this path: the ring's block attention is plain
PyTorch, as JAX's is XLA (``ops.ring``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from pdnlp_tpu_torch.parallel import collectives
from pdnlp_tpu_torch.parallel.mesh import (
    DATA_AXIS, SEQ_AXIS, axis_group, axis_index, axis_size,
)
from pdnlp_tpu_torch.train.precision import resolve_dtype

#: [B, S] per-TOKEN channels split along the sequence; everything else —
#: flat [B] labels and the packed rows' per-SEGMENT [B, M] channels
#: (``cls_positions``/``label``/``example_weight``, whose second dim is the
#: segment slot count) — is the data shard's whole
TOKEN_KEYS = ("input_ids", "attention_mask", "token_type_ids",
              "segment_ids", "position_ids")


def sp_spec(key: str, val) -> tuple:
    """The mesh axes one batch channel splits over: ``("data", "seq")``
    for a 2-D token channel, else ``("data",)``."""
    if getattr(val, "ndim", 0) == 2 and key in TOKEN_KEYS:
        return (DATA_AXIS, SEQ_AXIS)
    return (DATA_AXIS,)


def sp_local(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of its data shard's batch: each token channel's
    ``[B, S / N]`` slice at its place along ``seq``, the other channels
    whole."""
    n = axis_size(mesh, SEQ_AXIS)
    i = axis_index(mesh, SEQ_AXIS)
    out = {}
    for key, val in batch.items():
        if len(sp_spec(key, val)) == 2:
            S = val.shape[1]
            if S % n:
                raise ValueError(f"sequence {S} does not split over {n} "
                                 "seq ranks")
            val = val[:, i * (S // n): (i + 1) * (S // n)]
        out[key] = val
    return out


def make_sp_train_step(args, mesh, device):
    """The sequence-parallel train step: ``step(state, batch)`` on this
    rank's data shard (full length), returning the global ``{"loss",
    "accuracy"}`` on every rank (the state keeps no EMA:
    ``parallel.execution.check_sp``)."""
    from pdnlp_tpu_torch.train.steps import flat_examples, weighted_ce

    dtype = resolve_dtype(args.dtype)
    smoothing = args.label_smoothing
    seq_group = axis_group(mesh, SEQ_AXIS)
    data_group = axis_group(mesh, DATA_AXIS)
    on0 = float(axis_index(mesh, SEQ_AXIS) == 0)
    remat = bool(getattr(args, "remat", False))

    def train_step(state, batch):
        model = state.model
        local = sp_local(batch, mesh)
        logits = model.classify(local, dtype=dtype, deterministic=False,
                                generator=state.generator, remat=remat,
                                seq_group=seq_group)
        logits, labels, w = flat_examples(logits, local["label"],
                                          local["example_weight"])
        loss, correct, objective = weighted_ce(logits, labels, w,
                                               smoothing=smoothing)
        # the shard's weight over the global weight (every seq rank of the
        # shard holds the same rows' weights)
        scale, gw = collectives.weighted_shard_scale(w.sum(), data_group)
        state.optimizer.zero_grad(set_to_none=True)
        # gated to seq-shard 0: the head's gradient counted once
        (objective * (on0 * scale)).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in model.parameters()]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)       # over seq (sum) and data (weighted)
        off = 0
        for p in model.parameters():
            p.grad = flat[off: off + p.numel()].view_as(p).clone()
            off += p.numel()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        stats = torch.stack([(loss * scale).detach(),
                             correct.detach().to(torch.float32)])
        dist.all_reduce(stats, group=data_group)
        return {"loss": stats[0], "accuracy": stats[1] / gw}

    return train_step


def make_sp_eval_step(args, mesh):
    """The sequence-parallel eval step with ``build_eval_step``'s metric
    contract: this data shard's sums and per-example arrays (the same on
    every seq rank of it), which the ``Trainer`` sums and gathers over
    ``data`` (JAX ``sp.py:168-205``)."""
    from pdnlp_tpu_torch.train.steps import flat_examples, weighted_ce

    dtype = resolve_dtype(args.dtype)
    seq_group = axis_group(mesh, SEQ_AXIS)

    def eval_step(model, params, batch):
        if params is not None:
            raise ValueError("the sequence-parallel eval step runs the live "
                             "weights (sp keeps no EMA)")
        with torch.no_grad():
            local = sp_local(batch, mesh)
            logits = model.classify(local, dtype=dtype, seq_group=seq_group)
            logits, labels, w = flat_examples(logits, local["label"],
                                              local["example_weight"])
            loss, correct, _ = weighted_ce(logits, labels, w)
            return {"loss_sum": loss * w.sum().clamp_min(1.0),
                    "weight": w.sum(), "correct": correct,
                    "pred": logits.argmax(-1), "label": labels, "ew": w}

    return eval_step
