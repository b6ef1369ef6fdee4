"""Train and eval steps (``pdnlp_tpu/train/steps.py``).

The JAX step is one jitted program: forward, weighted CE, backward, AdamW.
Here it runs eagerly on the train state, in place: the training forward
and loss (:class:`TrainObjective`, dropout from the state's generator),
``backward``, the optimizer step, the schedule step and the optional EMA.
Under bf16 the fp32 master weights are cast at each matmul inside the
forward, so their gradients land in fp32 (the JAX ``grads_dtype="param"``
default; ``"compute"`` is not ported).

Loss semantics: per-example cross-entropy weighted by ``example_weight``,
so the filler rows of the last batch contribute nothing.  Packed rows give
per-segment outputs ``[B, M, ·]`` with ``[B, M]`` labels and weights; both
steps flatten them to ``[B·M]`` example rows before either CE, so the loss
is the unpacked loss over the same examples (empty slots weigh 0).  The
reported loss is always the bare CE; label smoothing enters the objective
only.

Folding K steps into one dispatch (JAX ``build_multi_step``) becomes CUDA
graph capture in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from pdnlp_tpu_torch.models.bert import BertClassifier
from pdnlp_tpu_torch.ops.fused_ce import fused_weighted_ce, resolve_fused_ce
from pdnlp_tpu_torch.train.precision import resolve_dtype

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """What the JAX state dict holds, as live objects: the params (the
    model), the optimizer moments, the schedule, the dropout stream, the
    optional EMA of the params and the step count."""

    model: BertClassifier
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler]
    generator: torch.Generator
    ema: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0
    #: the module the step calls: a :class:`TrainObjective` over ``model``,
    #: wrapped in DDP or FSDP2 under data parallelism
    objective: Optional[torch.nn.Module] = None

    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The weights eval and checkpoints use: the EMA when kept, else
        the live params."""
        if self.ema is not None:
            return self.ema
        return {k: v.detach() for k, v in self.model.state_dict().items()}


def init_ema(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """An EMA initialised to the params (distinct fp32 buffers)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor, smoothing: float = 0.0):
    """(weighted mean bare CE, weighted correct count, training objective);
    filler rows weigh 0.  ``smoothing`` > 0 mixes the one-hot target with
    uniform mass in the objective only."""
    logp = torch.log_softmax(logits.to(torch.float32), -1)
    ce = -logp.gather(-1, labels.long()[:, None])[:, 0]
    wsum = weights.sum().clamp_min(1.0)
    loss = (ce * weights).sum() / wsum
    objective = loss
    if smoothing:
        uniform = ((-logp.mean(-1)) * weights).sum() / wsum
        objective = (1.0 - smoothing) * loss + smoothing * uniform
    correct = ((logits.argmax(-1) == labels.long()) * weights).sum()
    return loss, correct, objective


def flat_examples(out: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor):
    """Packed rows' per-segment ``[B, M, ·]`` outputs and ``[B, M]``
    labels and weights -> ``[B·M]`` example rows; padded batches pass
    through."""
    if out.dim() == 3:
        return (out.reshape(-1, out.shape[-1]), labels.reshape(-1),
                weights.reshape(-1))
    return out, labels, weights


class TrainObjective(torch.nn.Module):
    """The training forward and its loss as one module (the loss function of
    JAX's step): ``forward(batch, generator)`` runs ``classify`` and the
    fused (K4/K5) or plain weighted CE and returns ``(loss, correct,
    objective, weight)`` — the weighted mean bare CE, the weighted correct
    count, what ``backward`` starts from and the batch's weight mass.

    DDP and FSDP2 act only through the forward of the module they wrap, so
    the whole loss runs in here, the fused CE kernels included: FSDP2's
    root unit unshards the pooler and the classifier for them.

    With a process ``group`` the batch is this rank's shard of a global
    batch.  The objective is then scaled by ``world * lw / gw`` (``lw`` the
    shard's weight, ``gw`` the all-reduced global weight, at least 1), so
    the wrappers' *mean* of the ranks' gradients is the gradient of the
    global weighted mean ``sum(w * ce) / sum(w)`` that JAX's jitted step
    takes, even when the ranks carry different weight mass (packed rows,
    filler rows); ``loss`` is scaled by ``lw / gw``, so its sum over the
    ranks is the global loss, and ``weight`` is ``gw``
    (``collectives.weighted_shard_scale``).

    ``forward(batch)`` without a generator is the deterministic eval
    forward: fp32 logits, through the same wrapper."""

    def __init__(self, model: BertClassifier, args, device,
                 group=None):
        super().__init__()
        self.model = model
        self.dtype = resolve_dtype(args.dtype)
        self.attn_impl = args.attention_impl
        self.smoothing = args.label_smoothing
        self.fused = resolve_fused_ce(args.fused_ce, device) == "pallas"
        self.remat = bool(getattr(args, "remat", False))
        self.group = group

    def forward(self, batch: Batch,
                generator: Optional[torch.Generator] = None):
        model = self.model
        if generator is None:
            return model.classify(batch, dtype=self.dtype,
                                  attn_impl=self.attn_impl)
        out = model.classify(batch, dtype=self.dtype,
                             attn_impl=self.attn_impl, deterministic=False,
                             generator=generator, return_pooled=self.fused,
                             remat=self.remat)
        out, labels, weights = flat_examples(out, batch["label"],
                                             batch["example_weight"])
        if self.fused:
            # out is the pooled features: the kernels apply the classifier
            # themselves, so the [T, C] logits never reach device memory
            loss, correct, objective = fused_weighted_ce(
                out, model.classifier.weight.to(self.dtype),
                model.classifier.bias.to(self.dtype), labels, weights,
                smoothing=self.smoothing)
        else:
            loss, correct, objective = weighted_ce(out, labels, weights,
                                                   smoothing=self.smoothing)
        weight = weights.sum().detach()
        if self.group is not None:
            from pdnlp_tpu_torch.parallel.collectives import (
                weighted_shard_scale,
            )

            share, weight = weighted_shard_scale(weight, self.group)
            world = torch.distributed.get_world_size(self.group)
            objective = objective * (world * share)
            loss = loss * share
        return loss, correct, objective, weight


def build_train_step(args, device, after_backward=None, reduce_metrics=None
                     ) -> Callable[[TrainState, Batch], Metrics]:
    """The train step for ``args``: ``step(state, batch)`` calls
    ``state.objective`` (which resolved the routes for ``device``), runs
    ``backward``, then ``after_backward(state)`` (the explicit gradient
    all-reduce of the shard_map twin), the optimizer, the schedule and the
    EMA, and returns ``{"loss", "accuracy"}`` as device scalars (fetching
    them is the caller's choice).  ``reduce_metrics(loss, correct)`` sums
    the ranks' shares first."""
    ema_decay = args.ema_decay

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        loss, correct, objective, weight = state.objective(batch,
                                                           state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        objective.backward()
        if after_backward is not None:
            after_backward(state)
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        if state.ema is not None:
            with torch.no_grad():
                ema = list(state.ema.values())
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(
                    ema, [p.detach()
                          for p in state.model.state_dict().values()],
                    alpha=1.0 - ema_decay)
        state.step += 1
        loss, correct = loss.detach(), correct.detach()
        if reduce_metrics is not None:
            loss, correct = reduce_metrics(loss, correct)
        return {"loss": loss, "accuracy": correct / weight.clamp_min(1.0)}

    return train_step


def build_eval_step(args, forward=None) -> Callable[..., Metrics]:
    """The deterministic eval step: ``eval_step(model, params, batch)``
    returns device sums and the per-example predictions, labels and
    weights (the host accumulates).  ``params`` (a ``state_dict``-shaped
    mapping, e.g. the EMA) replaces the model's own weights for the call.
    ``forward(batch)`` (the placed ``TrainObjective`` under data
    parallelism, whose wrapper must see the call) replaces
    ``model.classify`` when ``params`` is None."""
    dtype = resolve_dtype(args.dtype)
    attn_impl = args.attention_impl
    # FSDP2 unshards through autograd-visible tensors: no_grad, not
    # inference_mode, when a wrapper runs the forward
    no_grad = torch.inference_mode if forward is None else torch.no_grad

    def eval_step(model: BertClassifier, params, batch: Batch) -> Metrics:
        kw = {"dtype": dtype, "attn_impl": attn_impl}
        with no_grad():
            if params is not None:
                logits = torch.func.functional_call(model, dict(params),
                                                    (batch,), kw)
            elif forward is not None:
                logits = forward(batch)
            else:
                logits = model.classify(batch, **kw)
            logits, labels, w = flat_examples(logits, batch["label"],
                                              batch["example_weight"])
            loss, correct, _ = weighted_ce(logits, labels, w)
            return {"loss_sum": loss * w.sum().clamp_min(1.0),
                    "weight": w.sum(), "correct": correct,
                    "pred": logits.argmax(-1), "label": labels, "ew": w}

    return eval_step
