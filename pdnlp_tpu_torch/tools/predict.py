"""Single-text inference sweep — the twin of ``predict_tpu.py`` (the
reference's ``predict.py``): pick a seeded dev example whose label is
厌恶 (disgust, id 3), or take ``--text``, run it through every strategy
checkpoint under ``--output_dir`` (the port's ``.pt`` and the JAX
package's ``.msgpack`` alike) and print ``预测`` (predicted) against
``真实`` (true) for each, in the JAX script's format.

    python -m pdnlp_tpu_torch.tools.predict [--output_dir output] \\
        [--text "自定义文本"] [--device cpu]
"""
from __future__ import annotations

import os
import random
import sys
from typing import Dict, Optional


def pick_sample(args, want_label: int = 3):
    """A dev example with the wanted label (``predict_tpu.py``'s pick)."""
    from pdnlp_tpu_torch.data.corpus import load_data, split_data

    _, dev = split_data(load_data(args.data_path), seed=args.seed,
                        limit=args.data_limit, ratio=args.ratio)
    rng = random.Random(args.seed)
    candidates = [ex for ex in dev if ex[1] == want_label]
    return rng.choice(candidates) if candidates else rng.choice(dev)


def main(args, text: Optional[str] = None,
         true_label: Optional[int] = None) -> Dict[str, int]:
    from pdnlp_tpu_torch.data.corpus import id2label
    from pdnlp_tpu_torch.serve.engine import InferenceEngine
    from pdnlp_tpu_torch.tools.evaluate import discover_checkpoints
    from pdnlp_tpu_torch.utils.logging import rank0_print

    if text is None:
        text, true_label = pick_sample(args)
    rank0_print(f"文本：{text}")
    engine = InferenceEngine(args)     # one engine, every checkpoint
    preds = {}
    for path in discover_checkpoints(args.output_dir):
        name = os.path.relpath(path, args.output_dir)
        try:
            engine.load_checkpoint(path)
        except Exception as e:  # e.g. a checkpoint of another --model
            rank0_print(f"{name}  skipped (incompatible with --model "
                        f"{args.model}): {type(e).__name__}: {e}")
            continue
        pred = int(engine.classify_texts([text])[0][0])
        preds[name] = pred
        true_s = id2label.get(true_label, "?") if true_label is not None \
            else "?"
        rank0_print(f"{name}  预测：{id2label[pred]}  真实：{true_s}")
    if not preds:
        rank0_print(f"no checkpoints under {args.output_dir}/")
    return preds


if __name__ == "__main__":
    from pdnlp_tpu_torch.utils.config import Args, parse_cli, pop_cli_flag

    argv, text = pop_cli_flag(sys.argv[1:], "--text")
    main(parse_cli(argv, base=Args()), text=text)
