"""Pipeline parallelism — GPipe stages over a ``stage`` mesh axis, the twin
of ``pdnlp_tpu/parallel/pp.py``.

- :func:`stage_model` cuts the full seeded model to this stage's
  contiguous slice of ``num_layers / S`` layers (registered under their
  global indices, so its ``state_dict`` names are the full model's); the
  embeddings, pooler and classifier stay whole on every stage.
- :func:`make_pp_train_step` runs the GPipe schedule, the PyTorch idiom
  in place of JAX's single-program tick loop (which recomputes clipped
  microbatches on its bubble ticks and discards them; at dropout 0 the two
  give the same numbers).  The batch splits into ``M`` microbatches.  The
  first stage embeds the whole batch once; every stage runs its layers on
  its ``M`` real microbatches in order, receiving activations from the
  stage before and sending to the stage after
  (``parallel.collectives.exchange``); the last stage runs the head once
  over the whole batch's [CLS] rows, and the CE normalises over the whole
  batch.  Backward runs the microbatches in reverse, each stage receiving
  the cotangent of its output and sending the cotangent of its input.
- The replicated trees get their gradient on one stage (the embeddings on
  the first, the head on the last); one all-reduce over the stage group
  makes every replica's gradient the same, so every replica and its AdamW
  state stay equal (JAX's ``psum`` over ``stage``).  On a ``{"data": D,
  "stage": S}`` mesh each data shard runs its own pipeline, the objective
  is scaled by the shard's weight over the global weight, and every
  gradient is summed over ``data`` (JAX's weighted combine).
- An MoE model's aux is each stage's layer share, the mean over its
  microbatches, summed over the stages (``pp.py:170-174, 200, 258-259``).

Each stage's layers run attention through ``ops.attention`` with the key
bias, at microbatch width: the flash kernels K1 (forward) and K2/K3
(backward) on the card at attention dropout 0, ``layers per stage x M``
launches of each per step and stage.  The CE is the plain
``weighted_ce``, as in JAX (``pp.py:253``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from pdnlp_tpu_torch.ops.attention import mask_bias
from pdnlp_tpu_torch.parallel import collectives
from pdnlp_tpu_torch.parallel.mesh import (
    DATA_AXIS, STAGE_AXIS, axis_group, axis_index, axis_size,
)
from pdnlp_tpu_torch.train.precision import resolve_dtype

#: the trees every stage holds whole (the rest are the layer slices)
REPLICATED = ("embeddings.", "pooler.", "classifier.")


@dataclasses.dataclass
class Stage:
    """This rank's place in the pipeline: its index, the stage count, the
    stage group and the global indices of the layers it holds."""

    index: int
    size: int
    group: object
    layers: range


class StageLayers(nn.Module):
    """A stage's slice of the encoder layers, each registered under its
    global index (``layers.<i>`` in the ``state_dict``, as the full model
    names it); iterates over the layers in order."""

    def __init__(self, layers: Dict[int, nn.Module]):
        super().__init__()
        for i, layer in layers.items():
            self.add_module(str(i), layer)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)

    def __getitem__(self, idx: int) -> nn.Module:
        return list(self._modules.values())[idx]


def check_pp(args, cfg, n_stages: int) -> None:
    """JAX ``setup_pp_model``'s refusals: the EMA, and a stage count that
    does not divide the layers."""
    if getattr(args, "ema_decay", 0.0) > 0:
        raise ValueError("--ema_decay runs on the jit strategies (dp/zero/"
                         "tp/ep) — the pipeline step does not maintain the "
                         "EMA tree")
    if cfg.num_layers % n_stages:
        raise ValueError(f"pipeline degree {n_stages} must divide num_layers "
                         f"({cfg.num_layers}) — stages hold contiguous "
                         "layer slices")


def stage_of(mesh, num_layers: int) -> Stage:
    """The :class:`Stage` of this rank on ``mesh``."""
    size = axis_size(mesh, STAGE_AXIS)
    index = axis_index(mesh, STAGE_AXIS)
    per = num_layers // size
    return Stage(index, size, axis_group(mesh, STAGE_AXIS),
                 range(index * per, (index + 1) * per))


@torch.no_grad()
def stage_model(model: nn.Module, stage: Stage) -> nn.Module:
    """Cut ``model`` (the full seeded init) to ``stage``'s layers, in
    place; it records ``stage`` for the step and the checkpoint."""
    model.layers = StageLayers({i: model.layers[i] for i in stage.layers})
    model.stage = stage
    return model


def is_replicated(name: str) -> bool:
    return name.startswith(REPLICATED)


def gather_stages(state: Dict[str, torch.Tensor], stage: Stage
                  ) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` from every stage's (host copies, on every
    rank of the stage group; a collective): each stage's layer slices,
    and the replicated trees of the first stage, in the full model's
    order (embeddings, layers, pooler, classifier)."""
    mine = {k: v.detach().to("cpu") for k, v in state.items()
            if stage.index == 0 or not is_replicated(k)}
    parts: List = [None] * stage.size
    dist.all_gather_object(parts, mine, group=stage.group)
    merged: Dict[str, torch.Tensor] = {}
    for part in parts:
        merged.update(part)

    def order(k):
        if k.startswith("embeddings."):
            return (0, 0)
        if k.startswith("layers."):
            return (1, int(k.split(".")[1]))
        return (2, 0)

    return {k: merged[k] for k in sorted(merged, key=order)}


def gather_optimizer_state(optimizer, model, stage: Stage) -> Dict:
    """The stage group's AdamW state as one full optimizer state dict of
    ``torch.distributed.checkpoint`` (``get_optimizer_state_dict``: keyed
    by parameter name, host copies; a collective over the stage group):
    every stage's layer slices and the first stage's replicated trees.
    ``set_optimizer_state_dict`` loads each stage's subset from it, as it
    loads zero's."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_optimizer_state_dict,
    )

    # without cpu_offload: with it, only global rank 0 gets the state back
    full = get_optimizer_state_dict(
        model, optimizer, options=StateDictOptions(full_state_dict=True))
    mine = {"state": {n: {k: (v.detach().to("cpu") if torch.is_tensor(v)
                              else v) for k, v in st.items()}
                      for n, st in full["state"].items()
                      if stage.index == 0 or not is_replicated(n)},
            "params": [g["params"] for g in full["param_groups"]]}
    parts: List = [None] * stage.size
    dist.all_gather_object(parts, mine, group=stage.group)
    state = {}
    for part in parts:
        state.update(part["state"])
    groups = [{**g, "params": list(dict.fromkeys(
        n for part in parts for n in part["params"][i]))}
        for i, g in enumerate(full["param_groups"])]
    return {"state": state, "param_groups": groups}


def _run_layers(model, x, bias, mask, attn_impl, generator, remat):
    """This stage's layers over ``x``: ``(x, aux)``, the aux summed over
    its MoE layers (0 for a dense model)."""
    from pdnlp_tpu_torch.models.bert import _remat

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in model.layers:
        if remat and torch.is_grad_enabled():
            out = _remat(layer, x, bias, None, attn_impl=attn_impl,
                         generator=generator, mask=mask)
        else:
            out = layer(x, bias, None, attn_impl=attn_impl,
                        generator=generator, mask=mask)
        if layer.moe:
            x, a = out
            aux = aux + a
        else:
            x = out
    return x, aux


class Busy:
    """Host seconds a stage spends computing (each interval between two
    synchronizes of the card): with the step's wall time, the stage's
    measured idle share — the bubble and the exchanges."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.seconds += time.perf_counter() - t0


def _forward(model, batch, n_micro: int, dtype, attn_impl, generator,
             remat: bool, busy=contextlib.nullcontext):
    """The pipelined forward of one stage: ``(ins, outs, auxs, emb)`` —
    each microbatch's input (a leaf the cotangent lands on, after the
    first stage), output and aux, and the first stage's whole-batch
    embedding with its leaf (``(emb, leaf)``, else None).  ``busy`` wraps
    each stretch of compute."""
    stage: Stage = model.stage
    cfg = model.cfg
    B, S = batch["input_ids"].shape
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} "
                         "microbatches")
    b = B // n_micro
    masks = batch["attention_mask"].split(b)
    emb = xs = None
    if stage.index == 0:
        with busy():
            e = model.embed(batch["input_ids"], batch["token_type_ids"],
                            dtype, generator=generator)
        leaf = e.detach().requires_grad_(torch.is_grad_enabled())
        emb, xs = (e, leaf), leaf.split(b)
    like = torch.empty((b, S, cfg.hidden_size), dtype=dtype,
                       device=batch["input_ids"].device)
    last = stage.index == stage.size - 1
    ins, outs, auxs = [], [], []
    for m in range(n_micro):
        if stage.index == 0:
            x = xs[m]
        else:
            x = collectives.exchange(None, None, like, stage.index - 1,
                                     stage.group)
            x.requires_grad_(torch.is_grad_enabled())
        with busy():
            y, aux = _run_layers(model, x, mask_bias(masks[m]), masks[m],
                                 attn_impl, generator, remat)
        if not last:
            collectives.exchange(y, stage.index + 1, None, None, stage.group)
        ins.append(x)
        outs.append(y)
        auxs.append(aux)
    return ins, outs, auxs, emb


def _weighted_scale(weights, mesh):
    """``(lw / gw, gw)`` over the data axis (JAX's weighted combine), or
    ``(1, max(lw, 1))`` without one."""
    lw = weights.sum()
    if DATA_AXIS not in (mesh.mesh_dim_names or ()):
        return torch.ones((), device=lw.device), lw.clamp_min(1.0)
    return collectives.weighted_shard_scale(lw, axis_group(mesh, DATA_AXIS))


def _flat_grads(params) -> torch.Tensor:
    return torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])


def _unflatten(flat: torch.Tensor, params) -> None:
    off = 0
    for p in params:
        n = p.numel()
        p.grad = flat[off: off + n].view_as(p).clone()
        off += n


def reduce_grads(model, mesh) -> None:
    """Every gradient summed over ``data`` (each already carries its
    shard's ``lw / gw``), then the replicated trees' summed over
    ``stage``: one all-reduce per group, over one flat buffer each."""
    named = list(model.named_parameters())
    params = [p for _, p in named]
    if DATA_AXIS in (mesh.mesh_dim_names or ()) and \
            axis_size(mesh, DATA_AXIS) > 1:
        flat = _flat_grads(params)
        dist.all_reduce(flat, group=axis_group(mesh, DATA_AXIS))
        _unflatten(flat, params)
    rep = [p for n, p in named if is_replicated(n)]
    flat = _flat_grads(rep)
    dist.all_reduce(flat, group=model.stage.group)
    _unflatten(flat, rep)


def make_pp_train_step(args, mesh, device, n_micro: int = 4,
                       timeline: Optional[list] = None):
    """The GPipe train step (module docstring): ``step(state, batch)`` on
    this rank's data block of the global batch, which every stage of the
    block is given; returns ``{"loss", "accuracy"}`` on every rank (the
    last stage's, summed over the data axis).  With a ``timeline`` list
    each step appends ``{"busy_s", "step_s"}``: this stage's compute
    seconds (:class:`Busy`, which synchronizes the card around each
    stretch) and the step's wall seconds."""
    from pdnlp_tpu_torch.ops.attention import routed_impl
    from pdnlp_tpu_torch.train.steps import weighted_ce

    dtype = resolve_dtype(args.dtype)
    attn_impl = routed_impl(args.attention_impl, device,
                            dropout=args.attn_dropout > 0)
    smoothing = args.label_smoothing
    remat = bool(getattr(args, "remat", False))

    def train_step(state, batch):
        model, gen = state.model, state.generator
        stage: Stage = model.stage
        cfg = model.cfg
        last = stage.index == stage.size - 1
        busy = Busy(device) if timeline is not None else None
        timed = busy if busy is not None else contextlib.nullcontext
        t0 = time.perf_counter()
        scale, gw = _weighted_scale(batch["example_weight"], mesh)
        state.optimizer.zero_grad(set_to_none=True)
        ins, outs, auxs, emb = _forward(model, batch, n_micro, dtype,
                                        attn_impl, gen, remat, timed)
        b = batch["input_ids"].shape[0] // n_micro
        stats = torch.zeros(2, dtype=torch.float32, device=device)
        if last:
            # the head once, over the whole batch's [CLS] rows
            with timed():
                cls = torch.cat([y[:, 0, :] for y in outs]).detach()
                cls.requires_grad_()
                logits = model.pooled_logits(cls, gen)
                loss, correct, objective = weighted_ce(
                    logits, batch["label"], batch["example_weight"],
                    smoothing=smoothing)
                (objective * scale).backward()
            dcls = cls.grad.split(b)
            stats = torch.stack([(loss * scale).detach(),
                                 correct.detach().to(torch.float32)])
        aux_grad = None
        if cfg.moe_experts:
            aux_grad = (cfg.moe_aux_coef / n_micro) * scale.detach()
        for m in reversed(range(n_micro)):
            if last:
                dy = torch.zeros_like(outs[m])
                dy[:, 0] = dcls[m].to(dy.dtype)
            else:
                dy = collectives.exchange(None, None, outs[m],
                                          stage.index + 1, stage.group)
            tensors, grads = [outs[m]], [dy]
            if aux_grad is not None:
                tensors.append(auxs[m])
                grads.append(aux_grad)
            with timed():
                torch.autograd.backward(tensors, grads)
            if stage.index > 0:
                collectives.exchange(ins[m].grad, stage.index - 1, None,
                                     None, stage.group)
        if emb is not None:
            with timed():
                emb[0].backward(emb[1].grad)
        reduce_grads(model, mesh)
        with timed():
            state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        # the last stage's loss and count, summed over data, on every rank
        dist.all_reduce(stats)
        if busy is not None:
            busy._sync()
            timeline.append({"busy_s": busy.seconds,
                             "step_s": time.perf_counter() - t0})
        return {"loss": stats[0], "accuracy": stats[1] / gw}

    return train_step


def make_pp_eval_step(args, mesh, device, n_micro: int = 4):
    """The pipelined eval step with ``build_eval_step``'s contract, on
    every stage: the last stage's loss sum, correct count and predictions
    (broadcast over the stage group), this data block's labels and
    weights; the ``Trainer`` sums and gathers them over ``data``."""
    from pdnlp_tpu_torch.ops.attention import routed_impl
    from pdnlp_tpu_torch.train.steps import weighted_ce

    dtype = resolve_dtype(args.dtype)
    attn_impl = routed_impl(args.attention_impl, device)

    def eval_step(model, params, batch):
        if params is not None:
            raise ValueError("the pipeline eval step runs the live weights "
                             "(pp keeps no EMA)")
        stage: Stage = model.stage
        w = batch["example_weight"]
        B = w.shape[0]
        with torch.no_grad():
            _, outs, _, _ = _forward(model, batch, n_micro, dtype, attn_impl,
                                     None, False)
            sums = torch.zeros(2, dtype=torch.float32, device=w.device)
            pred = torch.zeros(B, dtype=torch.long, device=w.device)
            if stage.index == stage.size - 1:
                logits = model.pooled_logits(
                    torch.cat([y[:, 0, :] for y in outs]))
                loss, correct, _ = weighted_ce(logits, batch["label"], w)
                sums = torch.stack([loss * w.sum().clamp_min(1.0),
                                    correct.to(torch.float32)])
                pred = logits.argmax(-1)
            dist.all_reduce(sums, group=stage.group)
            dist.all_reduce(pred, group=stage.group)
        return {"loss_sum": sums[0], "weight": w.sum(), "correct": sums[1],
                "pred": pred, "label": batch["label"], "ew": w}

    return eval_step
