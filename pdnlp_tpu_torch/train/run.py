"""One shared parallel runner behind the multi-rank entry points — the
twin of ``pdnlp_tpu/train/run.py``.

The experiment is assembled once and the strategy is three knobs:

- ``mode``: ``"dp"`` (replicated state: DDP), ``"zero"`` (every weight
  and moment sharded: DeepSpeed ZeRO-3's analog), ``"tp"`` (heads
  and MLP features split over the ``model`` axis) or ``"ep"`` (an MoE
  model's experts split over the ``expert`` axis); every rank of one
  model or expert group feeds the same rows;
- ``explicit_collectives``: no wrapper; the step all-reduces the
  gradients itself, in bf16 on the wire (Horovod's analog);
- ``scale_batch``: ``True`` gives every rank ``train_batch_size`` rows, so
  the global batch grows with the ranks and the steps shrink (DDP's
  ``DistributedSampler`` math: 288 single, 144 at 2-way); ``False`` keeps
  ``nn.DataParallel``'s semantics: one ``train_batch_size``-row global
  batch split over the ranks, the step count unchanged.

Sequence and pipeline parallelism have their own assembly beside it
(:func:`build_sp_trainer`, :func:`build_pipeline_trainer`), as in JAX:
the same data, model and ``Trainer``, with the sp or pp placement and
steps.
"""
from __future__ import annotations

from typing import Tuple

import torch

from pdnlp_tpu_torch.data.corpus import LABELS
from pdnlp_tpu_torch.data.pipeline import setup_pipeline
from pdnlp_tpu_torch.data.sampler import resolve_length_mode
from pdnlp_tpu_torch.parallel.execution import (
    check_capture_backend, check_strategy, make_parallel_eval_step,
    make_parallel_train_step, make_shardmap_train_step, setup_sharded_model,
)
from pdnlp_tpu_torch.parallel.mesh import (
    local_data_extent, make_mesh, mesh_shape,
)
from pdnlp_tpu_torch.parallel.runtime import init_runtime
from pdnlp_tpu_torch.train.setup import setup_data
from pdnlp_tpu_torch.train.trainer import Trainer
from pdnlp_tpu_torch.utils.logging import rank0_print
from pdnlp_tpu_torch.utils.metrics import classification_report


def build_parallel_trainer(args, *, mode: str = "dp",
                           explicit_collectives: bool = False,
                           scale_batch: bool = True, train_override=None
                           ) -> Tuple[Trainer, object, object]:
    """``(trainer, train_loader, dev_loader)`` wired for the strategy, on
    the process group of ``args`` and the environment (joined here when it
    is not yet).  ``train_override`` swaps the train split's examples (the
    supervised pretraining stage); the dev split and the rest are shared.
    Refuses, as JAX does, ``--offload_opt_state`` with the explicit-
    collectives step, fused steps or tp, and the length modes on the
    explicit-collectives step; and ``--fuse_steps`` above 1 on the card
    over a backend that cannot be captured (``parallel.execution.
    check_capture_backend``).  The dp, zero, tp and ep steps run
    ``--fuse_steps`` K as captured K-step graphs on the card (zero through
    its explicit ZeRO-3 step); the explicit-collectives step runs K = 1,
    as JAX's does."""
    check_strategy(args, mode, explicit_collectives)
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
    if not explicit_collectives:
        check_capture_backend(args, mode, device)
    num_shards, shard_id, mult = local_data_extent(mesh)
    train_loader, dev_loader, tok = setup_data(
        args, num_shards=num_shards, shard_id=shard_id,
        device_batch_mult=mult, scatter=not scale_batch,
        train_override=train_override)
    cfg, state = setup_sharded_model(
        args, tok.vocab_size, mesh, mode,
        total_steps=len(train_loader) * args.epochs,
        explicit_collectives=explicit_collectives)
    if explicit_collectives:
        train_step = make_shardmap_train_step(args, mesh, device)
    else:
        train_step = make_parallel_train_step(args, mesh, device, mode)
    pipeline = setup_pipeline(args, train_loader, device)
    trainer = Trainer(args, cfg, state, train_step,
                      make_parallel_eval_step(args, state), device,
                      pipeline=pipeline, fusable=not explicit_collectives)
    global_batch = args.train_batch_size * (num_shards if scale_batch else 1)
    rank0_print(
        f"mesh: {mesh_shape(mesh)}  process {rank}/{world}  mode: "
        f"{mode}{' +explicit collectives' if explicit_collectives else ''}"
        f"  backend: {torch.distributed.get_backend()}  device: "
        f"{device.type}  model: {args.model}  dtype: {args.dtype}  global "
        f"batch: {global_batch}  steps/epoch: {len(train_loader)}  "
        f"pipeline: {pipeline.mode}")
    return trainer, train_loader, dev_loader


def build_single_trainer(args) -> Tuple[Trainer, object, object]:
    """``(trainer, train_loader, dev_loader)`` on one device, unwrapped:
    ``train.single``'s assembly (the seeded split, the model on
    ``args.device``, the ``--pipeline``, the single-device step, which
    ``--fuse_steps`` captures as CUDA graphs on the card)."""
    from pdnlp_tpu_torch.train.setup import setup_model
    from pdnlp_tpu_torch.train.steps import build_eval_step, build_train_step

    train_loader, dev_loader, tok = setup_data(args)
    cfg, state = setup_model(args, tok.vocab_size,
                             total_steps=len(train_loader) * args.epochs)
    device = next(state.model.parameters()).device
    pipeline = setup_pipeline(args, train_loader, device)
    rank0_print(f"device: {device.type}  model: {args.model}  "
                f"dtype: {args.dtype}  steps/epoch: {len(train_loader)}  "
                f"pipeline: {pipeline.mode}")
    trainer = Trainer(args, cfg, state, build_train_step(args, device),
                      build_eval_step(args), device, pipeline=pipeline)
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
    return _train_and_test(trainer, train_loader, dev_loader)


def _length_refusal(args, what: str) -> None:
    if resolve_length_mode(args) != "full":
        raise ValueError(what)


def _device(args):
    return torch.device("cuda", torch.cuda.current_device()) \
        if args.device.startswith("cuda") else torch.device("cpu")


def build_sp_trainer(args) -> Tuple[Trainer, object, object]:
    """``(trainer, train_loader, dev_loader)`` for the sequence-parallel
    (ring attention) path, default mesh ``{"data": 1, "seq": world}``:
    each rank loads its data shard's rows at full length, and the step
    takes its slice of the sequence (``parallel.sp``).  Refuses, as JAX
    does, the length modes and a mesh whose data and seq axes both span
    processes."""
    from pdnlp_tpu_torch.parallel.mesh import SEQ_AXIS, axis_size
    from pdnlp_tpu_torch.parallel.sp import (
        make_sp_eval_step, make_sp_train_step,
    )

    _length_refusal(
        args, "--length_mode bucket/pack is not wired into the sequence-"
        "parallel TRAINER: the ring/step layer speaks the packed channel "
        "layout (per-hop shard-local masks, cross-shard [CLS] gather), but "
        "this entrypoint's loader assumes one full-width shape per step — "
        "use the dp/zero strategies for length-aware training")
    rank, world = init_runtime(args)
    device = _device(args)
    mesh = make_mesh(num_devices=args.num_devices,
                     shape=args.mesh_shape or {"data": 1, SEQ_AXIS: world},
                     device_type=device.type)
    num_shards, shard_id, mult = local_data_extent(mesh)
    if world > 1 and num_shards > 1 and axis_size(mesh, SEQ_AXIS) > 1:
        raise ValueError(
            "a mesh whose data AND seq axes both span processes needs "
            "per-process partial batches with seq slicing — order the mesh "
            "so one of the two axes stays process-local")
    train_loader, dev_loader, tok = setup_data(
        args, num_shards=num_shards, shard_id=shard_id,
        device_batch_mult=mult)
    cfg, state = setup_sharded_model(
        args, tok.vocab_size, mesh, "sp",
        total_steps=len(train_loader) * args.epochs)
    # resident refused: the ring slices each batch along seq, not the plain
    # data-axis placement the resident gather produces
    pipeline = setup_pipeline(args, train_loader, device,
                              allow_resident=False)
    # the ring step runs one step at a time whatever --fuse_steps (JAX's
    # eff_k)
    trainer = Trainer(args, cfg, state,
                      make_sp_train_step(args, mesh, device),
                      make_sp_eval_step(args, mesh), device,
                      pipeline=pipeline, fusable=False)
    n = axis_size(mesh, SEQ_AXIS)
    rank0_print(f"mesh: {mesh_shape(mesh)}  process {rank}/{world}  ring "
                f"axis: {SEQ_AXIS} (local seq {args.max_seq_len // n})  "
                f"backend: {torch.distributed.get_backend()}  device: "
                f"{device.type}  model: {args.model}  dtype: {args.dtype}  "
                f"steps/epoch: {len(train_loader)}  pipeline: "
                f"{pipeline.mode}")
    return trainer, train_loader, dev_loader


def _train_and_test(trainer, train_loader, dev_loader) -> float:
    minutes = trainer.train(train_loader, dev_loader)
    result = trainer.test(dev_loader)
    rank0_print(f"test loss：{result['loss']:.6f} "
                f"accuracy：{result['accuracy']:.4f}")
    rank0_print(classification_report(result["y_true"], result["y_pred"],
                                      LABELS))
    return minutes


def run_sp(args) -> float:
    """Train and test on the sequence-parallel path; returns wall-clock
    minutes."""
    return _train_and_test(*build_sp_trainer(args))


def build_pipeline_trainer(args) -> Tuple[Trainer, object, object]:
    """``(trainer, train_loader, dev_loader)`` for the pipeline (GPipe)
    path, default mesh ``{"stage": world}``: each rank feeds its data
    shard's rows (the whole batch without a data axis; every stage of a
    pipeline is given the same rows) and holds its stage's layers
    (``parallel.pp``).  Refuses the length modes, as JAX does."""
    from pdnlp_tpu_torch.parallel.mesh import STAGE_AXIS, axis_size
    from pdnlp_tpu_torch.parallel.pp import (
        make_pp_eval_step, make_pp_train_step,
    )

    _length_refusal(
        args, "--length_mode bucket/pack is not supported on the pipeline "
        "(GPipe) path: stages run one fixed microbatch shape and the per-"
        "segment head gather lives on the last stage only — use the "
        "dp/zero strategies")
    rank, world = init_runtime(args)
    device = _device(args)
    mesh = make_mesh(num_devices=args.num_devices,
                     shape=args.mesh_shape or {STAGE_AXIS: world},
                     device_type=device.type)
    num_shards, shard_id, mult = local_data_extent(mesh)
    train_loader, dev_loader, tok = setup_data(
        args, num_shards=num_shards, shard_id=shard_id,
        device_batch_mult=mult)
    cfg, state = setup_sharded_model(
        args, tok.vocab_size, mesh, "pp",
        total_steps=len(train_loader) * args.epochs)
    # resident refused: every stage of a pipeline takes the same rows, not
    # the plain data-axis placement the resident gather produces
    pipeline = setup_pipeline(args, train_loader, device,
                              allow_resident=False)
    trainer = Trainer(
        args, cfg, state,
        make_pp_train_step(args, mesh, device, args.microbatches),
        make_pp_eval_step(args, mesh, device, args.microbatches), device,
        pipeline=pipeline, fusable=False)
    S = axis_size(mesh, STAGE_AXIS)
    rank0_print(f"mesh: {mesh_shape(mesh)}  process {rank}/{world}  stages:"
                f" {S} x {cfg.num_layers // S} layers  microbatches: "
                f"{args.microbatches}  backend: "
                f"{torch.distributed.get_backend()}  device: {device.type}  "
                f"model: {args.model}  dtype: {args.dtype}  steps/epoch: "
                f"{len(train_loader)}  pipeline: {pipeline.mode}")
    return trainer, train_loader, dev_loader


def run_pipeline(args) -> float:
    """Train and test on the pipeline path, resuming first where
    ``--resume_from`` names a snapshot; returns wall-clock minutes."""
    trainer, train_loader, dev_loader = build_pipeline_trainer(args)
    try_resume(trainer, args)
    return _train_and_test(trainer, train_loader, dev_loader)
