"""Train and eval steps (``pdnlp_tpu/train/steps.py``).

The JAX step is one jitted program: forward, weighted CE, backward, AdamW.
Here it runs eagerly on the train state, in place: the training forward
and loss (:class:`TrainObjective`, dropout from the state's generator),
``backward``, the optimizer step, the schedule step and the optional EMA.
Under bf16 the fp32 master weights are cast at each matmul inside the
forward, so their gradients land in fp32 (JAX's ``grads_dtype="param"``);
``"compute"`` casts the matmul weights to bf16 outside autograd, so their
gradients are produced in bf16 (``steps.py:164-190`` of the JAX package).

An MoE model's objective adds ``moe_aux_coef`` times the load-balancing
aux loss (JAX ``steps.py:132-161``); the reported loss stays the bare CE.

Loss semantics: per-example cross-entropy weighted by ``example_weight``,
so the filler rows of the last batch contribute nothing.  Packed rows give
per-segment outputs ``[B, M, ·]`` with ``[B, M]`` labels and weights; both
steps flatten them to ``[B·M]`` example rows before either CE, so the loss
is the unpacked loss over the same examples (empty slots weigh 0).  The
reported loss is always the bare CE; label smoothing enters the objective
only.

K steps in one dispatch (JAX's ``build_multi_step``, a ``lax.scan``) is
:func:`build_multi_step`: on a card, one ``torch.cuda.CUDAGraph`` per (K,
batch shape) holds K whole train steps in order — the forward with K1
(and K4), the backward with K2, K3 (and K5), AdamW, the schedule and the
EMA — all graphs in one memory pool; on the CPU the same call runs the K
steps one by one (the plain version the tests hold).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pdnlp_tpu_torch.models.bert import BertClassifier, RematRng, remat_rng
from pdnlp_tpu_torch.obs.trace import get_tracer
from pdnlp_tpu_torch.ops.fused_ce import fused_weighted_ce, resolve_fused_ce
from pdnlp_tpu_torch.parallel.sharding import ZeroObjective, local_shard
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
    #: wrapped in DDP or placed by ``ZeroObjective`` under data parallelism
    objective: Optional[torch.nn.Module] = None
    #: the data axis's process group (None: the default group), over which
    #: eval sums and gathers — under tp/ep the ranks of a model group hold
    #: the same outputs
    group: Optional[object] = None

    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The weights eval and checkpoints use: the EMA when kept, else
        the live params."""
        if self.ema is not None:
            return self.ema
        return {k: v.detach() for k, v in self.model.state_dict().items()}

    @contextlib.contextmanager
    def ema_swapped(self):
        """The EMA in the sharded (zero) params' place for the block: each
        rank copies its EMA shard into its param shard, so the objective's
        forward gathers the EMA as it gathers the params, and puts the
        params back after."""
        live = self.model.state_dict()
        with torch.no_grad():
            saved = {k: local_shard(v).clone() for k, v in live.items()}
            for k, v in live.items():
                local_shard(v).copy_(local_shard(self.ema[k]))
        try:
            yield
        finally:
            with torch.no_grad():
                for k, v in live.items():
                    local_shard(v).copy_(saved[k])


def init_ema(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """An EMA initialised to the params, as distinct buffers (JAX's
    ``jnp.copy``); under zero each entry is a DTensor placed as its
    parameter: one shard per rank."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def ema_update(ema: Dict[str, torch.Tensor], model: torch.nn.Module,
               d: float, one_minus_d: float) -> None:
    """``ema = d * ema + (1 - d) * params``, in place, on each rank's
    shard of every entry (the whole entry where nothing is sharded)."""
    with torch.no_grad():
        e = [local_shard(v) for v in ema.values()]
        torch._foreach_mul_(e, d)
        torch._foreach_add_(
            e, [local_shard(p.detach()) for p in model.state_dict().values()],
            alpha=one_minus_d)


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

    DDP and zero's ``ZeroObjective`` act only through the forward of the
    module they wrap, so the whole loss runs in here, the fused CE kernels
    included.

    With a process ``group`` the batch is this rank's shard of a global
    batch.  The objective is then scaled by ``world * lw / gw`` (``lw`` the
    shard's weight, ``gw`` the all-reduced global weight, at least 1), so
    the wrappers' *mean* of the ranks' gradients is the gradient of the
    global weighted mean ``sum(w * ce) / sum(w)`` that JAX's jitted step
    takes, even when the ranks carry different weight mass (packed rows,
    filler rows); ``loss`` is scaled by ``lw / gw``, so its sum over the
    ranks is the global loss, and ``weight`` is ``gw``
    (``collectives.weighted_shard_scale``).

    An MoE model adds ``moe_aux_coef * aux`` to the objective.  With
    ``global_aux`` (the jit strategies' twin) the layers take ``group`` as
    their data group: the aux sums the routing statistics over it, so it
    is the global batch's, and the grouped dispatch's capacity is the
    global batch's, as in JAX's jitted step; the term is scaled by
    ``world`` (the wrappers average).  Otherwise (the explicit-collectives
    step, as JAX's shard_map step) each rank routes its own rows, and its
    aux joins its objective before the ``world * lw / gw`` scale.

    ``forward(batch)`` without a generator is the deterministic eval
    forward: fp32 logits, through the same wrapper."""

    def __init__(self, model: BertClassifier, args, device,
                 group=None, global_aux: bool = False):
        super().__init__()
        self.model = model
        self.dtype = resolve_dtype(args.dtype)
        self.attn_impl = args.attention_impl
        self.smoothing = args.label_smoothing
        self.fused = resolve_fused_ce(args.fused_ce, device) == "pallas"
        self.remat = bool(getattr(args, "remat", False))
        self.group = group
        self.aux_coef = model.cfg.moe_aux_coef if model.cfg.moe_experts \
            else None
        self.global_aux = global_aux and group is not None
        if self.aux_coef is not None and self.global_aux:
            for layer in model.layers:
                layer.data_group = group

    def forward(self, batch: Batch,
                generator: Optional[torch.Generator] = None):
        model = self.model
        if generator is None:
            return model.classify(batch, dtype=self.dtype,
                                  attn_impl=self.attn_impl)
        out, aux = model.classify(batch, dtype=self.dtype,
                                  attn_impl=self.attn_impl,
                                  deterministic=False, generator=generator,
                                  return_pooled=self.fused, remat=self.remat,
                                  return_aux=True)
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
        if self.aux_coef is not None and not self.global_aux:
            objective = objective + self.aux_coef * aux
        if self.group is not None:
            from pdnlp_tpu_torch.parallel.collectives import (
                weighted_shard_scale,
            )

            share, weight = weighted_shard_scale(weight, self.group)
            world = torch.distributed.get_world_size(self.group)
            objective = objective * (world * share)
            loss = loss * share
            if self.aux_coef is not None and self.global_aux:
                objective = objective + (world * self.aux_coef) * aux
        return loss, correct, objective, weight


def compute_grads(args) -> bool:
    """``--grads_dtype compute`` under a bf16 compute dtype (under fp32 the
    two settings are one)."""
    mode = getattr(args, "grads_dtype", "param")
    if mode not in ("param", "compute"):
        raise ValueError(f"grads_dtype must be 'param' or 'compute', got "
                         f"{mode!r}")
    return mode == "compute" and resolve_dtype(args.dtype) != torch.float32


def matmul_weights(model: torch.nn.Module) -> List[str]:
    """The weights every matmul casts per use — each ``nn.Linear``'s, and
    each MoE gate's and expert stack's ``kernel`` (JAX's ``cast_kernels``:
    every ``kernel`` leaf of 2 or more dims)."""
    return [f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, torch.nn.Linear)] + [
        name for name, p in model.named_parameters()
        if name.endswith(".kernel") and p.dim() >= 2]


def ema_coefficients(decay: float):
    """``(d, 1 - d)`` rounded as JAX computes them: ``d`` in fp32, then
    ``1 - d`` in fp32."""
    d = np.float32(decay)
    return float(d), float(np.float32(1.0) - d)


def build_train_step(args, device, after_backward=None, reduce_metrics=None
                     ) -> Callable[..., Metrics]:
    """The train step for ``args``: ``step(state, batch)`` calls
    ``state.objective`` (which resolved the routes for ``device``), runs
    ``backward``, then ``after_backward(state)`` (the explicit gradient
    all-reduce of the shard_map twin), the optimizer, the schedule and the
    EMA, and returns ``{"loss", "accuracy"}`` as device scalars (fetching
    them is the caller's choice).  ``reduce_metrics(loss, correct)`` sums
    the ranks' shares first.

    ``step(state, batch, next_lr=rows)`` is the form a captured graph
    records: instead of stepping the host schedule it copies ``rows`` (one
    0-d device tensor per parameter group) into the groups' rate tensors,
    which is what the schedule step would have filled.

    Under zero (``parallel.sharding.ZeroObjective``) the step reduces the
    gradients to the shards after the backward itself, before
    ``after_backward``.

    Under ``--grads_dtype compute`` the forward reads the bf16 casts of the
    matmul weights (zero's objective gathers them in bf16 itself), and so
    does ``--remat``'s recompute (``models.bert._remat``)."""
    d, one_minus_d = ema_coefficients(args.ema_decay)
    compute = compute_grads(args)
    dtype = resolve_dtype(args.dtype)

    def loss_and_backward(state: TrainState, batch: Batch):
        # under zero the objective gathers the matmul weights in bf16 and
        # reduces their gradients in bf16 itself (parallel.sharding.
        # ZeroObjective)
        if not compute or getattr(state.objective, "casts_kernels", False):
            loss, correct, objective, weight = state.objective(
                batch, state.generator)
            state.optimizer.zero_grad(set_to_none=True)
            objective.backward()
            return loss, correct, weight
        params = dict(state.model.named_parameters())
        names = matmul_weights(state.model)
        # the weights' names as the objective (maybe DDP's wrapper) holds them
        held = {id(p): n for n, p in state.objective.named_parameters()}
        with torch.no_grad():
            cast = {n: params[n].to(dtype).requires_grad_() for n in names}
        # DDP's hooks sit on the fp32 weights, which these gradients
        # bypass: its reduction is off, and the step reduces every gradient
        # itself below, the matmul weights' in bf16 (parallel.execution.
        # reduce_model_grads)
        ddp = isinstance(state.objective,
                         torch.nn.parallel.DistributedDataParallel)
        with state.objective.no_sync() if ddp else contextlib.nullcontext():
            loss, correct, objective, weight = torch.func.functional_call(
                state.objective,
                {held[id(params[n])]: w for n, w in cast.items()},
                (batch, state.generator), strict=False)
            state.optimizer.zero_grad(set_to_none=True)
            objective.backward()
        for n in names:          # the bf16 gradient, widened for AdamW
            params[n].grad = cast[n].grad.to(params[n].dtype)
        if ddp:
            from pdnlp_tpu_torch.parallel.execution import reduce_model_grads

            reduce_model_grads(state.model, state.objective.process_group,
                               compute=True)
        return loss, correct, weight

    def train_step(state: TrainState, batch: Batch,
                   next_lr: Optional[List[torch.Tensor]] = None) -> Metrics:
        tracer = get_tracer()
        with tracer.device_span("step", step=state.step):
            loss, correct, weight = loss_and_backward(state, batch)
            if isinstance(state.objective, ZeroObjective):
                state.objective.reduce_grads()
            if after_backward is not None:
                after_backward(state)
            with tracer.device_span("optimizer"):
                state.optimizer.step()
            if next_lr is not None:
                for group, rate in zip(state.optimizer.param_groups, next_lr):
                    group["lr"].copy_(rate)
            elif state.scheduler is not None:
                state.scheduler.step()
            if state.ema is not None:
                ema_update(state.ema, state.model, d, one_minus_d)
        state.step += 1
        loss, correct = loss.detach(), correct.detach()
        if reduce_metrics is not None:
            loss, correct = reduce_metrics(loss, correct)
        return {"loss": loss, "accuracy": correct / weight.clamp_min(1.0)}

    return train_step


# ------------------------------------------------------------- state copies


def state_tensors(state: TrainState) -> List[torch.Tensor]:
    """Every tensor a train step writes: params, AdamW's state (moments
    and step counts), the groups' rate tensors, the EMA."""
    out = [p.data for p in state.model.parameters()]
    for st in state.optimizer.state.values():
        out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    out += [g["lr"] for g in state.optimizer.param_groups
            if isinstance(g["lr"], torch.Tensor)]
    if state.ema is not None:
        out += list(state.ema.values())
    return out


def snapshot_state(state: TrainState) -> Dict:
    """A copy of everything a train step changes, on the state's devices:
    :func:`restore_state` puts it back bit for bit."""
    return {
        "tensors": [t.detach().clone() for t in state_tensors(state)],
        # host-float rates (off the card), which the schedule's step sets
        "lrs": [g["lr"] for g in state.optimizer.param_groups],
        "generator": state.generator.get_state(),
        "scheduler": (state.scheduler.state_dict()
                      if state.scheduler is not None else None),
        "step": state.step,
    }


def restore_state(state: TrainState, snap: Dict) -> None:
    with torch.no_grad():
        for t, saved in zip(state_tensors(state), snap["tensors"],
                            strict=True):
            t.copy_(saved)
    for g, lr in zip(state.optimizer.param_groups, snap["lrs"]):
        if not isinstance(lr, torch.Tensor):
            g["lr"] = lr
    state.generator.set_state(snap["generator"])
    if snap["scheduler"] is not None:
        state.scheduler.load_state_dict(snap["scheduler"])
    state.optimizer.zero_grad(set_to_none=True)
    state.step = snap["step"]


# ----------------------------------------------------------- K-step fusion


def _launch_counts() -> Dict[str, int]:
    from pdnlp_tpu_torch.ops import flash, fused_ce

    return {**flash.launch_counts(), **fused_ce.launch_counts()}


def _add_launches(counts: Dict[str, int], times: int) -> None:
    from pdnlp_tpu_torch.ops import flash, fused_ce

    flash.add_launches(counts, times)
    fused_ce.add_launches(counts, times)


def _counts() -> Dict[str, int]:
    """The kernels' launch counts and the collectives' call and byte
    counts now: what a capture records and each replay is credited."""
    from pdnlp_tpu_torch.parallel.collectives import stats_counts

    return {**_launch_counts(), **stats_counts()}


def _add_counts(counts: Dict[str, int], times: int) -> None:
    from pdnlp_tpu_torch.parallel.collectives import add_stats

    _add_launches(counts, times)
    add_stats({k: v for k, v in counts.items() if "." in k}, times)


class _Graph:
    """One captured group: K train steps on ``inputs``, with the per-step
    rates read from ``lrs`` (``[K + 1, groups]``) and the stacked metrics
    written to ``outputs``."""

    def __init__(self, graph, k, inputs, lrs, outputs, launches, seconds,
                 pool_bytes):
        self.graph = graph
        self.k = k
        self.inputs = inputs
        self.lrs = lrs
        self.outputs = outputs
        self.launches = launches
        self.seconds = seconds
        self.pool_bytes = pool_bytes
        self.replays = 0
        #: the collectives' call and byte counts its capture recorded
        self.collectives: Dict[str, int] = {}
        #: (recompute dropout state, offset past the main generator's at
        #: the replay's start) per remat call (models.bert.RematRng)
        self.remat: List[tuple] = []
        #: the device span marks the capture recorded (obs.device.
        #: Recording; None untraced), logged at each replay
        self.marks = None


class _MultiStep:
    """K sequential train steps in one dispatch (JAX's
    ``build_multi_step``, which builds it): ``multi(state, batches)``
    takes ``[K, rows, ...]`` batches and returns ``{"loss": [K],
    "accuracy": [K]}``, as JAX's scan does, having run the K steps in
    order.

    On a card each (K, batch shape) is captured once as a CUDA graph over
    static input buffers (``stage``, shared with the input pipeline, so a
    fused group is written straight into them), and replayed after:

    - the graphs share one memory pool; each replay's metrics are copied
      out at once, so no graph reads another's memory;
    - the dropout generator is registered with every graph, so each replay
      advances its Philox offset as K eager steps would;
    - AdamW is capturable (``build_optimizer`` under ``fuse_steps`` above
      1) and the K rates reach the graph through a device tensor filled
      from the schedule before each replay;
    - the kernels' launch counters are replay-aware: the launches a
      capture records, once per replay, and so are the collectives' call
      and byte counts (``parallel.collectives.STATS`` / ``P2P_STATS``):
      under a process group the step's all-reduces are inside the graph
      (NCCL), and a replay runs no host code;
    - before the first capture one eager step runs on the capture stream
      (the kernels' libraries load, cuBLAS sets up its workspace) from a
      copy of the state, which is then put back bit for bit: capturing
      never changes the trained state;
    - with the tracer's device spans on (``obs.trace``), the marks a
      capture records are logged at each replay with its first step, so
      each of the K steps has its own ``step`` span; the warm step runs
      without marks;
    - under ``--remat`` that step also records the generator's offset at
      each layer's forward, and again before every later capture of
      another shape: the graph's recomputes draw from states of their own
      (``models.bert.RematRng``), set from those offsets before each
      replay, so each recompute replays its forward's masks.

    A capture or a replay that fails raises; nothing falls back to eager
    steps.  On the CPU the K steps run one by one."""

    def __init__(self, train_step: Callable, device, stage=None):
        from pdnlp_tpu_torch.data.pipeline import DeviceStage

        self.train_step = train_step
        self.device = torch.device(device)
        self.stage = stage if stage is not None else DeviceStage(self.device)
        self.graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self._stream = None
        self._warmed = False
        self._remat = False

    def reset(self) -> None:
        """Drop every captured graph (after the state's tensors were
        replaced, e.g. by a resume)."""
        self.graphs.clear()
        self._pool = None

    @property
    def pool_bytes(self) -> int:
        return sum(g.pool_bytes for g in self.graphs.values())

    def __call__(self, state: TrainState, batches: Batch) -> Metrics:
        k = int(batches["input_ids"].shape[0])
        if self.device.type != "cuda":
            ms = [self.train_step(state, {key: v[i] for key, v in
                                          batches.items()})
                  for i in range(k)]
            return {m: torch.stack([x[m] for x in ms]) for m in ms[0]}
        with get_tracer().span("stage_fill"):
            inputs = self.stage.fill(batches)
        g = self.graphs.get(self._key(inputs)) or self.capture(state, inputs)
        return self._replay(state, g)

    @staticmethod
    def _key(inputs) -> tuple:
        return tuple(sorted((key, tuple(v.shape), str(v.dtype))
                            for key, v in inputs.items()))

    def _warm(self, state: TrainState, inputs: Batch) -> tuple:
        """One eager step on the capture stream, undone after (its
        launches are not counted: it trains nothing).  Returns the
        generator's offsets at the step's remat forwards and over the
        whole step, from its offset at the step's start."""
        snap = snapshot_state(state)
        before = _counts()
        start = state.generator.get_offset()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream), remat_rng(RematRng()) as rec, \
                get_tracer().device_suspended():
            self.train_step(state, {key: v[0] for key, v in inputs.items()})
        period = state.generator.get_offset() - start
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        restore_state(state, snap)
        after = _counts()
        _add_counts({n: after[n] - before[n] for n in after}, -1)
        self._warmed = True
        self._remat = bool(rec.offsets)
        return [o - start for o in rec.offsets], period

    def capture(self, state: TrainState, batches: Batch) -> _Graph:
        """Capture the K-step graph of ``batches``' shape (``batches`` are
        copied into the stage's buffers first); nothing runs."""
        inputs = self.stage.fill(batches)
        key = self._key(inputs)
        if key in self.graphs:
            return self.graphs[key]
        if not all(g["capturable"] for g in state.optimizer.param_groups):
            raise ValueError("a captured step needs a capturable AdamW: "
                             "build the optimizer with fuse_steps > 1 "
                             "(train.optim.build_optimizer)")
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        offsets, period = [], 0
        if not self._warmed or self._remat:
            offsets, period = self._warm(state, inputs)
        k = int(inputs["input_ids"].shape[0])
        groups = state.optimizer.param_groups
        lrs = None
        if state.scheduler is not None:
            lrs = torch.zeros((k + 1, len(groups)), dtype=torch.float32,
                              device=self.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        remat = [(state.generator.clone_state(), i * period + o)
                 for i in range(k) for o in offsets]
        for r, _ in remat:
            graph.register_generator_state(r)
        rng = RematRng(r for r, _ in remat)
        state.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before, step0 = _counts(), state.step
        t0 = time.perf_counter()
        with remat_rng(rng), get_tracer().device_capture(step0) as marks, \
                torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            ms = [self.train_step(
                state, {key_: v[i] for key_, v in inputs.items()},
                next_lr=None if lrs is None else list(lrs[i + 1]))
                for i in range(k)]
            outputs = {m: torch.stack([x[m] for x in ms]) for m in ms[0]}
        # torchlint: disable=R4 — times the capture's recording: a capture launches nothing
        seconds = time.perf_counter() - t0
        state.step = step0                   # the capture ran nothing
        if rng.states:
            raise RuntimeError(
                f"the capture ran {len(remat) - len(rng.states)} remat "
                f"layers of the {len(remat)} its eager step recorded")
        after = _counts()
        counted = {n: after[n] - before[n] for n in after}
        _add_counts(counted, -1)
        launches = {n: v for n, v in counted.items() if "." not in n}
        state.optimizer.zero_grad(set_to_none=True)
        if self._pool is None:
            self._pool = graph.pool()
        g = _Graph(graph, k, inputs, lrs, outputs, launches, seconds,
                   torch.cuda.memory_reserved(self.device) - reserved)
        g.collectives = {n: v for n, v in counted.items() if "." in n}
        g.remat = remat
        g.marks = marks
        self.graphs[key] = g
        return g

    def _replay(self, state: TrainState, g: _Graph) -> Metrics:
        tracer = get_tracer()
        sched = state.scheduler
        if g.lrs is not None:
            from pdnlp_tpu_torch.train.optim import advance_schedule, group_lrs

            with tracer.span("lr_rows"):
                rows = torch.tensor(group_lrs(sched, g.k), dtype=torch.float32)
                g.lrs.copy_(rows.pin_memory(), non_blocking=True)
        if g.remat:
            # each recompute's state at its forward's offset (host values:
            # the replay's prologue fills the device copies from them)
            seed = state.generator.initial_seed()
            base = state.generator.get_offset()
            for r, offset in g.remat:
                r.manual_seed(seed)
                r.set_offset(base + offset)
        with tracer.span("graph_replay"):
            tracer.device_replay(g.marks, state.step)
            g.graph.replay()
        g.replays += 1
        state.step += g.k
        if sched is not None:
            advance_schedule(sched, g.k)
        _add_counts({**g.launches, **g.collectives}, 1)
        # copied out now: a later replay of another graph of the shared
        # pool may reuse this one's output memory
        with tracer.span("outputs"):
            return {m: v.clone() for m, v in g.outputs.items()}


def build_multi_step(train_step: Callable, device, stage=None
                     ) -> _MultiStep:
    """The K-step dispatch over ``train_step`` (:class:`_MultiStep`)."""
    return _MultiStep(train_step, device, stage)


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
    # a wrapper's forward (zero's gather into fresh tensors) runs under
    # no_grad, not inference_mode
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
