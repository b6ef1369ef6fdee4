"""``Accelerator`` — HF Accelerate's analog: write single-device code, call
``prepare``, and it runs data-parallel.  The twin of
``pdnlp_tpu/train/accel.py`` and of the entry script
``multi-tpu-accelerate-cls.py``, whose user-written loop :func:`main`
keeps.

``Accelerator(args, mode)`` joins the process group of ``args`` and the
environment (``parallel.runtime.init_runtime``; one rank per card) and
builds the ``("data",)`` mesh.  ``prepare(state, *loaders)`` then takes the
pieces the user built single-device style:

- the train state is placed by ``mode``: its objective is rebuilt over the
  mesh's group and wrapped in DDP (``"dp"``) or placed by
  ``parallel.sharding.ZeroObjective`` (``"zero"``, whose sharded
  parameters get a new AdamW with the same groups and schedule, whose
  EMA, if kept, is placed as the params are, and whose matmul weights
  under ``--grads_dtype compute`` are gathered in bf16,
  ``parallel.sharding.wrap``);
- each loader is re-batched by ``batch_mult`` (1: a rank feeds one card),
  a ``LengthGroupedSampler`` rebuilt at the scaled batch (on this rank's
  shard of the same seeded global batches), and a plain sampler
  resharded over the ranks (``DistributedShardSampler``), so ``len`` of a
  prepared loader is the global step count;
- batches arrive as tensors on the rank's device.

``compile_step`` / ``compile_eval`` return the user's step and eval run on
the prepared state: the wrapper's gradient reduction inside, the
metrics summed (and the eval's per-example arrays gathered) over the
ranks.  They run eagerly — the counterpart of ``jax.jit`` here, as in
``train.single`` without ``--fuse_steps``; nothing is captured.

    python -m pdnlp_tpu_torch.train.accel --data_path data/train.json \\
        [--dtype bfloat16] [--accel_config machine.json] [--device cpu]
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pdnlp_tpu_torch.data.loader import DataLoader
from pdnlp_tpu_torch.data.pipeline import to_device
from pdnlp_tpu_torch.data.sampler import (
    DistributedShardSampler, LengthGroupedSampler,
)
from pdnlp_tpu_torch.parallel.mesh import local_batch_mult, make_mesh
from pdnlp_tpu_torch.parallel.runtime import init_runtime


class _PreparedLoader:
    """A loader whose batches arrive as tensors on the rank's device."""

    def __init__(self, loader: DataLoader, device: torch.device):
        self._loader = loader
        self._device = device

    def __len__(self):
        return len(self._loader)

    def set_epoch(self, epoch: int) -> None:
        self._loader.set_epoch(epoch)

    def __iter__(self):
        for batch in self._loader:
            yield to_device(batch, self._device)


class Accelerator:
    """The runtime and ``prepare``: the reference script's
    ``Accelerator()`` then one ``prepare`` call."""

    def __init__(self, args=None, mode: str = "dp"):
        from pdnlp_tpu_torch.parallel.sharding import check_mode
        from pdnlp_tpu_torch.utils.config import Args

        check_mode(mode)
        self.args = args if args is not None else Args()
        init_runtime(self.args)
        self.dtype = self.args.dtype
        self.mode = mode
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if self.args.device.startswith("cuda") else torch.device("cpu")
        self.mesh = make_mesh(num_devices=self.args.num_devices,
                              shape=self.args.mesh_shape,
                              device_type=self.device.type)
        if mode not in ("dp", "zero"):
            raise ValueError(f"the Accelerator places dp or zero, not "
                             f"{mode!r}: use train.multi --strategy {mode}")
        from pdnlp_tpu_torch.parallel.mesh import mesh_shape
        from pdnlp_tpu_torch.parallel.sharding import check_mesh

        check_mesh(mode, mesh_shape(self.mesh))
        self.num_devices = self.mesh.size()
        # prepare() scales loader batches by this; anything sized in steps
        # (the schedule, total_step) is counted on the prepared loaders
        self.batch_mult = local_batch_mult(self.mesh)
        self.process_index = dist.get_rank()
        self.is_main_process = self.process_index == 0
        self._prepared = False

    # ------------------------------------------------------- machine config
    @classmethod
    def from_config(cls, path: str, args=None) -> "Accelerator":
        """An ``Accelerator`` from a machine-config file, accelerate's
        ``default_config.yaml`` analog: JSON, or YAML when ``yaml`` imports.
        The keys (HF's names; others are ignored):

        - ``num_processes`` -> ``Args.num_devices``, checked against the
          world size (every rank is a device of the mesh);
        - ``mesh_shape`` -> the mesh's axes (``data``; another axis of one
          rank is replicated over, as JAX's dp placement does);
        - ``mixed_precision`` ``bf16``/``fp16`` -> bf16 compute;
        - ``distributed_type: DEEPSPEED`` -> mode ``zero``, else ``dp``
          (a ``mode`` key names it directly);
        - ``num_machines`` > 1, ``machine_rank``, ``main_process_ip``,
          ``main_process_port`` -> the rendezvous: ``host:port``, a world
          of ``num_processes`` ranks (``num_machines`` when absent), and
          with one process per machine ``machine_rank`` as the rank (else
          the launcher's environment names it).
        """
        with open(path) as f:
            text = f.read()
        try:
            cfg = json.loads(text)
        except ValueError:
            try:
                import yaml
            except ImportError:
                raise ValueError(
                    f"{path}: not JSON, and YAML needs the yaml package, "
                    "which is not installed — write the config as JSON"
                ) from None
            cfg = yaml.safe_load(text)
        from pdnlp_tpu_torch.utils.config import Args

        base = args if args is not None else Args()
        over: Dict[str, Any] = {}
        if cfg.get("num_processes"):
            over["num_devices"] = int(cfg["num_processes"])
        if cfg.get("mesh_shape"):
            over["mesh_shape"] = {str(k): int(v)
                                  for k, v in cfg["mesh_shape"].items()}
        mp = str(cfg.get("mixed_precision", "no")).lower()
        if mp in ("bf16", "fp16", "bfloat16"):
            over["dtype"] = "bfloat16"
        machines = int(cfg.get("num_machines", 1))
        if machines > 1:
            host = cfg.get("main_process_ip", "127.0.0.1")
            port = cfg.get("main_process_port", 12355)
            over["coordinator_address"] = f"{host}:{port}"
            world = int(cfg.get("num_processes") or machines)
            over["num_processes"] = world
            if world == machines:
                over["process_id"] = int(cfg.get("machine_rank", 0))
        mode = ("zero" if str(cfg.get("distributed_type", "")).upper()
                == "DEEPSPEED" else "dp")
        return cls(args=base.replace(**over), mode=cfg.get("mode", mode))

    # ------------------------------------------------------------- prepare
    def prepare(self, state, *loaders: DataLoader) -> Tuple:
        """``(state, *loaders)`` distributed (module docstring) — the
        ``model, optimizer, loaders = accelerator.prepare(...)`` call."""
        if state is not None:
            self._place(state)
        prepared = [_PreparedLoader(self._rebatch(ld), self.device)
                    for ld in loaders]
        self._prepared = True
        return (state, *prepared)

    def _place(self, state) -> None:
        from pdnlp_tpu_torch.parallel.sharding import wrap
        from pdnlp_tpu_torch.train.precision import resolve_dtype
        from pdnlp_tpu_torch.train.steps import TrainObjective, compute_grads

        # JAX's Accelerator jits its step over the global batch: an MoE
        # model's routing is the global batch's here too
        objective = TrainObjective(state.model, self.args, self.device,
                                   group=self.mesh.get_group(),
                                   global_aux=True)
        compute = compute_grads(self.args) and self.mode == "zero"
        state.objective = wrap(
            objective, self.mode, self.mesh, self.device,
            compute_dtype=resolve_dtype(self.args.dtype) if compute
            else None)
        if self.mode == "zero":
            if state.ema is not None:
                # the EMA's values placed as zero placed the params: one
                # shard per rank
                from pdnlp_tpu_torch.train.trainer import _placed_like

                live = state.model.state_dict()
                state.ema = {k: _placed_like(v.detach().cpu(), live[k])
                             for k, v in state.ema.items()}
            # zero replaced the parameters with their shards: AdamW over
            # the new ones, with the same schedule
            from pdnlp_tpu_torch.train.optim import build_optimizer

            lr = self.args.learning_rate
            fn = state.scheduler.lr_lambdas[0] \
                if state.scheduler is not None else None
            state.optimizer, state.scheduler = build_optimizer(
                state.model, self.args,
                schedule=None if fn is None else (lambda c: lr * fn(c)))

    def _rebatch(self, loader: DataLoader) -> DataLoader:
        world = dist.get_world_size()
        rank = dist.get_rank()
        sampler = loader.sampler
        if hasattr(sampler, "chunks"):
            # a batching sampler owns the chunk size: rebuild it at the
            # scaled batch, on this rank's shard of the same global batches
            sampler = LengthGroupedSampler(
                sampler.lengths, loader.batch_size * self.batch_mult,
                buckets=sampler.buckets,
                num_shards=world if world > 1 else sampler.num_shards,
                shard_id=rank if world > 1 else sampler.shard_id,
                shuffle=sampler.shuffle, seed=sampler.seed,
                drop_last=sampler.drop_last)
        elif world > 1 and sampler.num_shards != world:
            # each rank feeds a disjoint shard, or the global batch would
            # hold the same examples world times over
            sampler = DistributedShardSampler(
                sampler.num_examples, world, rank, shuffle=sampler.shuffle,
                seed=sampler.seed, drop_last=sampler.drop_last)
        return DataLoader(
            loader.data, loader.collator, loader.batch_size * self.batch_mult,
            sampler=sampler, drop_last=loader.drop_last,
            prefetch=loader.prefetch, encoded=loader.encoded)

    def _check_prepared(self, what: str) -> None:
        if not self._prepared:
            raise RuntimeError(f"call prepare(state, ...) before {what}")

    def compile_step(self, fn: Callable) -> Callable:
        """The user's train step ``fn(state, batch) -> metrics`` on the
        prepared state: the placement's gradient reduction runs inside
        (the objective is wrapped), and the metrics — each rank's share —
        are summed over the ranks."""
        self._check_prepared("compile_step")
        group = self.mesh.get_group()

        def step(state, batch):
            metrics = fn(state, batch)
            if dist.get_world_size(group) > 1:
                both = torch.stack([metrics["loss"], metrics["accuracy"]])
                dist.all_reduce(both, group=group)
                metrics = {"loss": both[0], "accuracy": both[1]}
            return metrics

        return step

    def compile_eval(self, fn: Callable) -> Callable:
        """The user's eval step ``fn(model, params, batch) -> metrics`` on
        the prepared state: its sums all-reduced and its per-example arrays
        (``pred``, ``label``, ``ew``) gathered over the ranks."""
        self._check_prepared("compile_eval")
        group = self.mesh.get_group()

        def ev(model, params, batch):
            m = fn(model, params, batch)
            if dist.get_world_size(group) == 1:
                return m
            from pdnlp_tpu_torch.parallel.collectives import output_reduce

            sums = torch.stack([m["loss_sum"], m["weight"],
                                m["correct"].to(m["loss_sum"].dtype)])
            dist.all_reduce(sums, group=group)
            pred, label, ew = output_reduce(m["pred"], m["label"], m["ew"])
            return {"loss_sum": sums[0], "weight": sums[1],
                    "correct": sums[2], "pred": pred, "label": label,
                    "ew": ew}

        return ev

    # ------------------------------------------------------------- helpers
    def gather(self, x) -> Any:
        """Device values to the host (numpy), a dict of them leaf by leaf —
        also the completion barrier."""
        if isinstance(x, dict):
            return {k: self.gather(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    def print(self, *a, **kw) -> None:
        if self.is_main_process:
            print(*a, **kw)


def main(args) -> float:
    """The accelerate script's loop, written single-device style and made
    data-parallel by ``prepare`` / ``compile_step`` / ``compile_eval``:
    ``total_step`` is counted on the prepared loader, so it is the global
    step count.  Returns the training wall time in minutes."""
    import time

    from pdnlp_tpu_torch.data.corpus import LABELS
    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train.setup import setup_data, setup_model
    from pdnlp_tpu_torch.train.steps import build_eval_step, build_train_step
    from pdnlp_tpu_torch.utils.logging import fmt_elapsed_minutes, fmt_train
    from pdnlp_tpu_torch.utils.metrics import classification_report

    if args.accel_config:
        # the machine config as a file: mesh, precision and rendezvous
        # from the file, every other field from the command line
        accelerator = Accelerator.from_config(args.accel_config, args=args)
        args = accelerator.args
    else:
        accelerator = Accelerator(args, mode=args.mode)

    # the user's single-device setup; the schedule is sized on the
    # prepared loader's steps (a rank feeds 1/world of the examples)
    train_loader, dev_loader, tok = setup_data(args)
    world = dist.get_world_size()
    per_rank = -(-len(train_loader.sampler) // world)
    steps_per_epoch = -(-per_rank // (args.train_batch_size
                                      * accelerator.batch_mult))
    cfg, state = setup_model(args, tok.vocab_size,
                             total_steps=steps_per_epoch * args.epochs)

    # the one distributed-awareness step
    state, train_loader, dev_loader = accelerator.prepare(
        state, train_loader, dev_loader)
    train_step = accelerator.compile_step(
        build_train_step(args, accelerator.device))
    eval_step = accelerator.compile_eval(
        build_eval_step(args, forward=state.objective))

    total_step = len(train_loader) * args.epochs
    accelerator.print(f"devices: {accelerator.num_devices}  "
                      f"steps/epoch: {len(train_loader)}")
    start = time.time()
    gstep = 0
    metrics = None
    pending = None  # the previous line's loss, done by now: no stall
    for epoch in range(1, args.epochs + 1):
        train_loader.set_epoch(epoch - 1)
        for batch in train_loader:
            metrics = train_step(state, batch)
            gstep += 1
            if gstep % args.log_every == 0:
                if pending is not None:
                    e, s, loss = pending
                    accelerator.print(fmt_train(
                        e, args.epochs, s, total_step,
                        float(accelerator.gather(loss))))
                pending = (epoch, gstep, metrics["loss"])
    if pending is not None:
        e, s, loss = pending
        accelerator.print(fmt_train(e, args.epochs, s, total_step,
                                    float(accelerator.gather(loss))))
    if metrics is not None:
        float(accelerator.gather(metrics["loss"]))  # completion barrier
    minutes = (time.time() - start) / 60
    accelerator.print(fmt_elapsed_minutes(minutes))

    # the user's eval loop over the prepared dev loader
    y_true, y_pred = [], []
    loss_sum = weight = correct = 0.0
    for batch in dev_loader:
        m = accelerator.gather(eval_step(state.model, None, batch))
        loss_sum += float(m["loss_sum"])
        weight += float(m["weight"])
        correct += float(m["correct"])
        real = m["ew"] > 0
        y_pred.extend(np.asarray(m["pred"])[real].tolist())
        y_true.extend(np.asarray(m["label"])[real].tolist())
    weight = max(weight, 1.0)
    accelerator.print(f"test loss：{loss_sum / weight:.6f} "
                      f"accuracy：{correct / weight:.4f}")
    accelerator.print(classification_report(y_true, y_pred, LABELS))

    # every rank gathers (a collective under zero); rank 0 writes
    params = ckpt.consolidate(state.model)
    if accelerator.is_main_process:
        ckpt.save_params(args.ckpt_path(), params, model_name=args.model,
                         vocab_size=cfg.vocab_size)
    return minutes


if __name__ == "__main__":
    import sys

    from pdnlp_tpu_torch.parallel.runtime import shutdown
    from pdnlp_tpu_torch.utils.config import Args, parse_cli

    try:
        main(parse_cli(sys.argv[1:], base=Args(strategy="accelerate")))
    finally:
        shutdown()
