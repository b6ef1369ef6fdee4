"""One shared parallel runner behind the data-parallel entry points — the
twin of ``pdnlp_tpu/train/run.py``.

The experiment is assembled once and the strategy is three knobs:

- ``mode``: ``"dp"`` (replicated state: DDP) or ``"zero"`` (every weight
  and moment sharded: FSDP2, DeepSpeed ZeRO-3's analog);
- ``explicit_collectives``: no wrapper; the step all-reduces the
  gradients itself, in bf16 on the wire (Horovod's analog);
- ``scale_batch``: ``True`` gives every rank ``train_batch_size`` rows, so
  the global batch grows with the ranks and the steps shrink (DDP's
  ``DistributedSampler`` math: 288 single, 144 at 2-way); ``False`` keeps
  ``nn.DataParallel``'s semantics: one ``train_batch_size``-row global
  batch split over the ranks, the step count unchanged.
"""
from __future__ import annotations

from typing import Tuple

import torch

from pdnlp_tpu_torch.data.corpus import LABELS
from pdnlp_tpu_torch.data.pipeline import setup_pipeline
from pdnlp_tpu_torch.data.sampler import resolve_length_mode
from pdnlp_tpu_torch.parallel.execution import (
    make_parallel_eval_step, make_parallel_train_step,
    make_shardmap_train_step, setup_sharded_model,
)
from pdnlp_tpu_torch.parallel.mesh import local_data_extent, make_mesh
from pdnlp_tpu_torch.parallel.runtime import init_runtime
from pdnlp_tpu_torch.train.setup import setup_data
from pdnlp_tpu_torch.train.trainer import Trainer
from pdnlp_tpu_torch.utils.logging import rank0_print
from pdnlp_tpu_torch.utils.metrics import classification_report


def build_parallel_trainer(args, *, mode: str = "dp",
                           explicit_collectives: bool = False,
                           scale_batch: bool = True
                           ) -> Tuple[Trainer, object, object]:
    """``(trainer, train_loader, dev_loader)`` wired for the strategy, on
    the process group of ``args`` and the environment (joined here when it
    is not yet).  Refuses, as JAX does, the length modes on the
    explicit-collectives step."""
    if explicit_collectives and resolve_length_mode(args) != "full":
        raise ValueError(
            "--length_mode bucket/pack is wired into the dp/zero strategies "
            "only — the explicit-collectives (shardmap) step is the fixed-"
            "width twin of JAX's shard_map program; use dp or zero")
    rank, world = init_runtime(args)
    device = torch.device("cuda", torch.cuda.current_device()) \
        if args.device.startswith("cuda") else torch.device("cpu")
    mesh = make_mesh(num_devices=args.num_devices, shape=args.mesh_shape,
                     device_type=device.type)
    num_shards, shard_id, mult = local_data_extent(mesh)
    train_loader, dev_loader, tok = setup_data(
        args, num_shards=num_shards, shard_id=shard_id,
        device_batch_mult=mult, scatter=not scale_batch)
    cfg, state = setup_sharded_model(
        args, tok.vocab_size, mesh, mode,
        total_steps=len(train_loader) * args.epochs,
        explicit_collectives=explicit_collectives)
    if explicit_collectives:
        train_step = make_shardmap_train_step(args, mesh, device)
    else:
        train_step = make_parallel_train_step(args, mesh, device)
    pipeline = setup_pipeline(args, train_loader, device)
    trainer = Trainer(args, cfg, state, train_step,
                      make_parallel_eval_step(args, state), device,
                      pipeline=pipeline)
    global_batch = args.train_batch_size * (num_shards if scale_batch else 1)
    rank0_print(
        f"mesh: {{'data': {num_shards}}}  process {rank}/{world}  mode: "
        f"{mode}{' +explicit collectives' if explicit_collectives else ''}"
        f"  backend: {torch.distributed.get_backend()}  device: "
        f"{device.type}  model: {args.model}  dtype: {args.dtype}  global "
        f"batch: {global_batch}  steps/epoch: {len(train_loader)}  "
        f"pipeline: {pipeline.mode}")
    return trainer, train_loader, dev_loader


def try_resume(trainer: Trainer, args) -> None:
    """Restore the resume snapshot when ``--resume_from`` names one that
    exists (``auto``: ``args.resume_path()``); a file whose retained
    previous is corrupt too starts the run from scratch, loudly."""
    import os

    from pdnlp_tpu_torch.train import checkpoint as ckpt

    if not (args.resume_from and os.path.exists(args.resume_path())):
        return
    try:
        trainer.load_resume(args.resume_path())
    except ckpt.CorruptCheckpointError as e:
        rank0_print(f"WARNING: resume snapshot unusable ({e}) — no valid "
                    "previous snapshot retained either; starting from "
                    "scratch")
        return
    rank0_print(f"resumed from {args.resume_path()} at step "
                f"{trainer.state.step}")


def run_parallel(args, **strategy) -> float:
    """Train and test; returns wall-clock minutes."""
    trainer, train_loader, dev_loader = build_parallel_trainer(args,
                                                               **strategy)
    try_resume(trainer, args)
    minutes = trainer.train(train_loader, dev_loader)
    result = trainer.test(dev_loader)
    rank0_print(f"test loss：{result['loss']:.6f} "
                f"accuracy：{result['accuracy']:.4f}")
    rank0_print(classification_report(result["y_true"], result["y_pred"],
                                      LABELS))
    return minutes
