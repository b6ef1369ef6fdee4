"""Offline int8 weight quantization of a saved checkpoint — the twin of
``scripts/quantize_ckpt.py``.

Writes the artifact ``--serve_dtype int8`` loads as it is: every dense
block's weight as per-output-channel symmetric int8 plus one fp32 scale per
output channel (``serve.quant``, the same math the engine applies when it
quantizes a float checkpoint on the fly).  Weight-only calibration: no
data, no device.

    python -m pdnlp_tpu_torch.tools.quantize_ckpt output/single-cls.pt
    # -> output/single-cls.int8.pt + a per-block error report
    python -m pdnlp_tpu_torch.tools.quantize_ckpt output/dp-cls.msgpack
    # -> output/dp-cls.int8.msgpack (flax's bytes, as the JAX script's)

The output goes through ``train.checkpoint``'s publish (atomic, with a
CRC32 manifest).  ``--kv_calib`` (the KV-cache scale tables of generative
decoding) is refused: decoding is ROADMAP A10.
"""
from __future__ import annotations

import argparse
import os
import sys


def artifact_path(checkpoint: str) -> str:
    """``<stem>.int8.msgpack`` for a ``.msgpack``, ``<stem>.int8.pt``
    otherwise."""
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    ext = ".msgpack" if ckpt.is_msgpack(checkpoint) else ".pt"
    stem = checkpoint[: -len(ext)] if checkpoint.endswith(ext) \
        else checkpoint
    return f"{stem}.int8{ext}"


def main(argv=None) -> int:
    from pdnlp_tpu_torch.serve.quant import (
        is_quantized, quant_error_report, quantize_state,
    )
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--kv_calib" in argv:
        print("quantize_ckpt: --kv_calib calibrates the int8 KV cache of "
              "generative decoding, which the PyTorch port does not have "
              "yet (ROADMAP A10)", file=sys.stderr)
        return 2
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint", help="params checkpoint (.pt or .msgpack)")
    p.add_argument("-o", "--output", default=None,
                   help="artifact path (default: <stem>.int8.<ext>)")
    ns = p.parse_args(argv)

    raw = ckpt.load_raw(ns.checkpoint)
    sd = ckpt.params_from_raw(raw, ns.checkpoint)
    if is_quantized(sd):
        print(f"{ns.checkpoint} is already an int8 artifact", file=sys.stderr)
        return 1
    qsd = quantize_state(sd)
    report = quant_error_report(sd, qsd)
    if not report:
        print(f"{ns.checkpoint}: no dense blocks found — not a params "
              "checkpoint?", file=sys.stderr)
        return 1
    out = ns.output or artifact_path(ns.checkpoint)
    model = raw.get("model", "") if isinstance(raw, dict) else ""
    ckpt.save_params(out, qsd, model_name=model,
                     vocab_size=int(sd["embeddings.word"].shape[0]))

    in_bytes = os.path.getsize(ns.checkpoint)
    print(f"wrote {out}  ({in_bytes / 1e6:.1f} MB -> "
          f"{os.path.getsize(out) / 1e6:.1f} MB)")
    print(f"{'block':<28} {'max|dW|':>10} {'rel':>8}")
    for name, (err, rel) in sorted(report.items()):
        print(f"{name:<28} {err:>10.2e} {rel:>8.2%}")
    worst = max(rel for _, rel in report.values())
    print(f"worst per-block relative error: {worst:.2%} "
          "(symmetric per-channel int8 bound: <= 1/127 of the channel amax)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
