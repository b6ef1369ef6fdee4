"""Single-device training — the twin of ``single-tpu-cls.py`` (the
reference's ``single-gpu-cls.py``): one card, batch 32, seq len 128, one
epoch over the seeded 9,200-example split (288 steps), AdamW 3e-5, a
``【train】`` line per step, ``耗时：X分钟``, the checkpoint, then a test
pass over dev with the classification report.

    python -m pdnlp_tpu_torch.train.single --data_path data/train.json \\
        [--dtype bfloat16] [--dev true] [--attn_dropout 0] [--device cpu] \\
        [--length_mode full|bucket|pack] [--length_buckets 32,64,128] \\
        [--pipeline auto|resident|prefetch|sync] [--remat true] \\
        [--fuse_steps 4] [--warmup_compile true] [--grads_dtype compute] \\
        [--resume_every 50] [--resume_from auto|<path>] [--ckpt_async false] \\
        [--trace true] [--trace_dir <d>] [--profile_dir <d>] [--log_every 10] \\
        [--probe_steps 30]

``--length_mode bucket`` pads each batch to the smallest covering width of
``--length_buckets``; ``pack`` puts several examples in each row, with the
segment form of the flash kernels (``data.packing``).  ``--pipeline``
picks how batches reach the card (``data.pipeline``; ``auto`` holds the
split on the card when it can, else prefetches on a side stream).
``--remat true`` recomputes each layer's activations in the backward.
``--fuse_steps`` K runs K steps per dispatch, on the card as one captured
CUDA graph (``train.steps.build_multi_step``); ``--resume_every`` /
``--resume_from`` snapshot and restore the whole train state bit for bit;
``--trace`` writes the phase spans and prints the breakdown table
(``train.trainer``).

Runs on ``cuda`` unless ``--device cpu`` is given.  With ``--attn_dropout``
above 0 (the default 0.1) training attention takes the plain path, as in
the JAX package; at 0 the flash kernels run forward and backward.  The
checkpoint (``<output_dir>/single-cls.pt``) is the port's own format and
``python -m pdnlp_tpu_torch.serve.cli --checkpoint`` serves it.
"""
from __future__ import annotations

import sys

#: JAX training flags whose paths the port does not have yet -> where
#: ROADMAP queues them; a value in the tuple is the one setting allowed
NOT_PORTED = {
    "--elastic": (None, "elastic restart (ROADMAP A11)"),
    "--heartbeat_interval": (None, "heartbeats (ROADMAP A11)"),
    "--metrics_port": (None, "the live exporter in the training loop "
                             "(ROADMAP A9b; serve.cli has it)"),
    "--flight_recorder": (None, "the flight recorder in the training loop "
                                "(ROADMAP A9b; serve.cli has it)"),
    "--init_from": (None, "pretrained warm start (ROADMAP A12)"),
}


def refuse_not_ported(argv, table=NOT_PORTED, prog: str = "train.single"):
    """``argv`` without the flags of ``table`` that carry their one
    allowed value; exits naming the missing path for any other use."""
    out = list(argv)
    for flag, (allowed, what) in table.items():
        if flag not in out:
            continue
        i = out.index(flag)
        value = out[i + 1] if i + 1 < len(out) else None
        if allowed is None or value != allowed:
            sys.exit(f"{prog}: {flag} needs {what}, which the "
                     "PyTorch port does not have yet")
        del out[i:i + 2]
    return out


def main(args) -> float:
    from pdnlp_tpu_torch.data.corpus import LABELS
    from pdnlp_tpu_torch.data.pipeline import setup_pipeline
    from pdnlp_tpu_torch.train.run import try_resume
    from pdnlp_tpu_torch.train.setup import setup_data, setup_model
    from pdnlp_tpu_torch.train.steps import build_eval_step, build_train_step
    from pdnlp_tpu_torch.train.trainer import Trainer
    from pdnlp_tpu_torch.utils.logging import rank0_print
    from pdnlp_tpu_torch.utils.metrics import classification_report

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
    try_resume(trainer, args)
    minutes = trainer.train(train_loader, dev_loader)
    # dev doubles as the test set (single-gpu-cls.py:241-247)
    result = trainer.test(dev_loader)
    rank0_print(f"test loss：{result['loss']:.6f} "
                f"accuracy：{result['accuracy']:.4f}")
    rank0_print(classification_report(result["y_true"], result["y_pred"],
                                      LABELS))
    return minutes


if __name__ == "__main__":
    from pdnlp_tpu_torch.utils.config import Args, parse_cli

    main(parse_cli(refuse_not_ported(sys.argv[1:]),
                   base=Args(strategy="single")))
