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

Under zero (``parallel.sharding.ZeroObjective``) the parameters are
``Shard(0)`` DTensors and AdamW is :class:`ZeroAdamW`: the same update on
each rank's shards as plain tensors, capturable as above, its moments
built up front as DTensors placed as the parameters.

``--offload_opt_state`` (JAX's ``pinned_host`` moments, the DeepSpeed
``offload_optimizer`` analog) builds :class:`OffloadAdamW`: the float
moments live in host memory (pinned when a card exists), the params and
gradients stay on the device, and each step stages the moments onto the
device a chunk at a time on a side stream, runs the same AdamW update
there, and copies them back (:meth:`OffloadAdamW.step`).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from pdnlp_tpu_torch.parallel.sharding import as_placed, local_shard


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
        return warmup_cosine(lr, w, total_steps)
    raise ValueError(f"unknown lr_schedule {args.lr_schedule!r} "
                     "(warmup_linear|warmup_cosine)")


def warmup_cosine(lr: float, warmup: int, total_steps: int
                  ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, total_steps)``:
    a linear rise over ``warmup`` updates, then a cosine to 0 over the
    remaining ``total_steps - warmup`` (raises when none remain, as optax
    does)."""
    decay = total_steps - warmup
    if decay <= 0:
        raise ValueError(f"warmup_cosine needs total_steps > warmup "
                         f"steps, got {total_steps} <= {warmup}")

    def cosine(c):
        if c < warmup:
            return _linear(0.0, lr, warmup, c)
        t = min(c - warmup, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return cosine


def pretrain_schedule(lr: float, total_steps: int) -> Callable[[int], float]:
    """Masked-LM pretraining's rate: warmup over the first 6% of the
    updates (at least one), then cosine decay to 0 — JAX
    ``train/pretrain.py``'s ``warmup_cosine_decay_schedule(0, lr,
    max(1, total * 6 // 100), total)``, whose warmup is not
    ``--warmup_ratio``'s ``int(total * ratio)``."""
    return warmup_cosine(lr, max(1, total_steps * 6 // 100), total_steps)


def build_optimizer(model: torch.nn.Module, args, total_steps=None,
                    schedule: Optional[Callable[[int], float]] = None,
                    capturable: Optional[bool] = None):
    """``(AdamW, LambdaLR or None)`` from ``Args`` (lr 3e-5, betas
    0.9/0.999, eps 1e-6, decay 0.01 by default).  Step the scheduler after
    each optimizer step: update ``k`` (from 0) then runs at
    ``schedule(k)``.  ``schedule`` (the rate at each update count) takes
    the place of ``--lr_schedule``'s, as the JAX ``build_optimizer``'s
    does: pretraining passes :func:`pretrain_schedule`.  Capturable on a
    card under ``--fuse_steps`` above 1 (module docstring), unless
    ``capturable`` says otherwise (a path that runs its steps one at a
    time); the state is allocated up front on every device
    (:func:`init_state`), and under ``--offload_opt_state`` its moments
    moved to host memory (:class:`OffloadAdamW`).  Over zero's sharded
    parameters (DTensors) it is :class:`ZeroAdamW`."""
    params = list(model.parameters())
    sharded = any(hasattr(p, "to_local") for p in params)
    if capturable is None:
        capturable = getattr(args, "fuse_steps", 1) > 1
    capturable = capturable and params[0].device.type == "cuda"
    lr = args.learning_rate
    if capturable:
        lr = torch.tensor(float(lr), dtype=torch.float32,
                          device=params[0].device)
    groups = decay_groups(model, args.weight_decay)
    if capturable:      # one rate tensor per group, as LambdaLR fills them
        for g in groups[1:]:
            g["lr"] = lr.clone()
    offload = getattr(args, "offload_opt_state", False)
    cls = OffloadAdamW if offload else \
        ZeroAdamW if sharded else torch.optim.AdamW
    opt = cls(groups, lr=lr, betas=(args.adam_b1, args.adam_b2),
              eps=args.adam_eps, capturable=capturable)
    init_state(opt)
    if offload:
        opt.park()
    if schedule is None:
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


class ZeroAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` over zero's ``Shard(0)`` DTensor parameters
    whose update runs on each rank's shards as plain tensors: the stock
    ``step`` (the same foreach or per-tensor arithmetic, capturable or
    not), fed this rank's blocks of the parameters, their gradients and
    the moments.  AdamW is elementwise, so the shards' update is the whole
    tensors' update, placed (JAX's zero step's values).  The state is
    keyed and saved by the DTensor parameters (DTensor moments), and the
    update dispatches no DTensor op: nothing on the host between the
    kernels a captured graph records.  Its state is built up front
    (:func:`init_state`)."""

    def _init_group(self, group, params, grads, exp_avgs, exp_avg_sqs,
                    max_exp_avg_sqs, state_steps):
        for p in group["params"]:
            if p.grad is None:
                continue
            st = self.state[p]
            params.append(local_shard(p))
            grads.append(local_shard(p.grad))
            exp_avgs.append(local_shard(st["exp_avg"]))
            exp_avg_sqs.append(local_shard(st["exp_avg_sq"]))
            state_steps.append(st["step"])
        return False


#: AdamW's float moments: what ``--offload_opt_state`` keeps in host memory
MOMENTS = ("exp_avg", "exp_avg_sq")


class OffloadAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` whose float moments live in host memory
    between steps — JAX's ``--offload_opt_state`` (``parallel/
    execution.py``: the moments in ``pinned_host``, staged to the device
    for the update and back).  At rest each moment is this rank's shard
    as a plain host tensor, pinned when a card exists (:meth:`park`).

    :meth:`step` splits the parameters that have gradients into chunks
    of about :attr:`CHUNK_BYTES` of moments (one parameter at least) and, on a
    card, pipelines them over a side stream: chunk ``i + 1``'s moments are
    copied host -> device while AdamW updates chunk ``i`` on the current
    stream, and chunk ``i``'s copy back follows its update, so at most
    three chunks' moments are on the device at once.  Each chunk's update
    is ``AdamW.step`` over that chunk alone (the other gradients held
    aside), so every parameter gets the arithmetic of the on-device run,
    bit for bit.  A host read of the moments (a snapshot) calls
    :meth:`wait` first.  Not capturable: the host-side staging runs every
    step (JAX refuses offload with fused steps too)."""

    #: moment bytes staged per chunk
    CHUNK_BYTES = 32 * 2 ** 20

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._copy = None
        #: host <-> device bytes the last step moved (both ways)
        self.staged_bytes = 0

    def _stream(self, device):
        if device.type != "cuda":
            return None
        if self._copy is None:
            self._copy = torch.cuda.Stream(device)
        return self._copy

    def wait(self) -> None:
        """Block until every copy back to host memory has landed."""
        if self._copy is not None:
            self._copy.synchronize()

    @torch.no_grad()
    def park(self) -> None:
        """Move every moment still on a device (a fresh init, a loaded
        state dict) to host memory."""
        pin = torch.cuda.is_available()
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state.get(p, {})
                for k in MOMENTS:
                    if k not in st:
                        continue
                    v = local_shard(st[k])
                    if v.device.type == "cpu" and (v.is_pinned() or not pin):
                        st[k] = v
                        continue
                    host = torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=pin)
                    host.copy_(v)
                    st[k] = host

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        self.park()

    def _chunks(self, params):
        chunks, size = [], None
        for p in params:
            nbytes = 2 * local_shard(p).numel() * 4
            if size is None or size + nbytes > self.CHUNK_BYTES:
                chunks.append([])
                size = 0
            chunks[-1].append(p)
            size += nbytes
        return chunks

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OffloadAdamW.step takes no closure")
        live = [p for g in self.param_groups for p in g["params"]
                if p.grad is not None]
        if not live:
            return None
        device = local_shard(live[0]).device
        copy = self._stream(device)
        main = torch.cuda.current_stream(device) if copy is not None \
            else None
        grads = {p: p.grad for p in live}
        self.staged_bytes = 0

        def on_copy():
            return torch.cuda.stream(copy) if copy is not None \
                else contextlib.nullcontext()

        def stage_in(chunk):
            hosts = []
            with on_copy():
                for p in chunk:
                    st = self.state[p]
                    for k in MOMENTS:
                        host = st[k]
                        dev = torch.empty(host.shape, dtype=host.dtype,
                                          device=device)
                        dev.copy_(host, non_blocking=True)
                        if copy is not None:
                            dev.record_stream(main)
                        st[k] = as_placed(dev, p)
                        hosts.append((st, k, host))
                        self.staged_bytes += 2 * host.numel() * \
                            host.element_size()
            return hosts, copy.record_event() if copy is not None else None

        chunks = self._chunks(live)
        try:
            staged = stage_in(chunks[0])
            for i, chunk in enumerate(chunks):
                hosts, ready = staged
                if i + 1 < len(chunks):
                    staged = stage_in(chunks[i + 1])
                if ready is not None:
                    main.wait_event(ready)
                mine = {id(p) for p in chunk}
                for p in live:
                    p.grad = grads[p] if id(p) in mine else None
                super().step()
                done = main.record_event() if main is not None else None
                with on_copy():
                    if done is not None:
                        copy.wait_event(done)
                    for st, k, host in hosts:
                        host.copy_(local_shard(st[k]), non_blocking=True)
                        st[k] = host
        finally:
            for p in live:
                p.grad = grads[p]
        return None


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
