"""Offline evaluation sweep — the twin of ``test_tpu.py`` (the reference's
``test.py``): discover every strategy checkpoint under ``--output_dir``,
the port's ``*-cls.pt`` and the JAX package's ``*-cls.msgpack`` and
``model.msgpack`` layouts alike, load each into the model of ``--model``,
evaluate it on the seeded dev split (the training split's seed, so the
dev set is the held-out one) and print the classification report.  A file
that does not fit ``--model`` is skipped with its reason.

    python -m pdnlp_tpu_torch.tools.evaluate [--output_dir output] \\
        [--model bert-base] [--dtype bfloat16] [--device cpu]
"""
from __future__ import annotations

import glob
import os
import sys
from typing import Dict, List


def discover_checkpoints(output_dir: str) -> List[str]:
    """Every strategy checkpoint under ``output_dir``, sorted by name: the
    port's ``*-cls.pt``, JAX's ``*-cls.msgpack``, ``model.msgpack`` and
    the managed-run ``*/model.msgpack``, ``*/checkpoint-*/model.msgpack``
    (``test_tpu.py:discover_checkpoints``)."""
    pats = ("*-cls.pt", "*-cls.msgpack", "model.msgpack",
            os.path.join("*", "model.msgpack"),
            os.path.join("*", "checkpoint-*", "model.msgpack"))
    return sorted({p for pat in pats
                   for p in glob.glob(os.path.join(output_dir, pat))})


def main(args) -> Dict[str, float]:
    from pdnlp_tpu_torch.data.corpus import LABELS
    from pdnlp_tpu_torch.train import checkpoint as ckpt
    from pdnlp_tpu_torch.train.setup import setup_data, setup_model
    from pdnlp_tpu_torch.train.steps import build_eval_step
    from pdnlp_tpu_torch.train.trainer import Trainer
    from pdnlp_tpu_torch.utils.logging import rank0_print
    from pdnlp_tpu_torch.utils.metrics import classification_report

    _, dev_loader, tok = setup_data(args)
    cfg, state = setup_model(args, tok.vocab_size)
    device = next(state.model.parameters()).device
    template = {k: v.detach().cpu() for k, v in
                state.model.state_dict().items()}
    paths = discover_checkpoints(args.output_dir)
    if not paths:
        rank0_print(f"no checkpoints under {args.output_dir}/ "
                    "(run a training entry point first)")
        return {}
    eval_step = build_eval_step(args)
    results = {}
    for path in paths:
        name = os.path.relpath(path, args.output_dir)
        rank0_print(f"\n======== {name} ========")
        try:
            sd = ckpt.load_params(path, template, model_name=args.model)
        except Exception as e:  # e.g. a checkpoint of another --model
            rank0_print(f"skipped (incompatible with --model {args.model}): "
                        f"{type(e).__name__}: {e}")
            continue
        state.model.load_state_dict(sd)
        trainer = Trainer(args, cfg, state, None, eval_step, device)
        r = trainer.test(dev_loader)
        rank0_print(f"test loss：{r['loss']:.6f} accuracy：{r['accuracy']:.4f}")
        rank0_print(classification_report(r["y_true"], r["y_pred"], LABELS))
        results[name] = r["accuracy"]
    return results


if __name__ == "__main__":
    from pdnlp_tpu_torch.utils.config import Args, parse_cli

    main(parse_cli(sys.argv[1:], base=Args()))
