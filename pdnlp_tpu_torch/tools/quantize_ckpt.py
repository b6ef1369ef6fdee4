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
CRC32 manifest).

``--kv_calib MODEL`` also writes the int8 KV-cache scale tables of
generative decoding (``--kv_dtype int8``): per-(layer, head, channel)
symmetric scales from the seeded synthetic causal forward of
``models.decoder.calibrate_kv_scales`` on the CPU — the computation a
decode engine runs when it calibrates itself, so on the same device the
two give the same bytes.  They land beside the INPUT checkpoint as
``<stem>.kvscales.msgpack`` (flax's bytes, through ``train/msgpack.py``,
with a manifest), which the decode engine loads when the checkpoint swaps
in.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch


def artifact_path(checkpoint: str) -> str:
    """``<stem>.int8.msgpack`` for a ``.msgpack``, ``<stem>.int8.pt``
    otherwise."""
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    ext = ".msgpack" if ckpt.is_msgpack(checkpoint) else ".pt"
    return f"{ckpt.stem(checkpoint)}.int8{ext}"


def emit_kv_scales(state_dict, model: str, checkpoint: str) -> str:
    """Calibrate and publish the int8 KV scale tables for ``checkpoint``'s
    weights: ``<stem>.kvscales.msgpack``, manifest-verified."""
    from pdnlp_tpu_torch.models import convert
    from pdnlp_tpu_torch.models.bert import BertClassifier
    from pdnlp_tpu_torch.models.config import get_config
    from pdnlp_tpu_torch.models.decoder import calibrate_kv_scales
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    vocab = int(state_dict["embeddings.word"].shape[0])
    cfg = get_config(model, vocab_size=vocab,
                     num_labels=int(state_dict["classifier.weight"].shape[0]))
    net = BertClassifier(cfg)
    net.load_state_dict(state_dict)
    k_scale, v_scale = calibrate_kv_scales(net.eval())
    out = ckpt.stem(checkpoint) + ".kvscales.msgpack"
    ckpt.save(out, convert.kv_scales_to_jax(torch.from_numpy(k_scale),
                                            torch.from_numpy(v_scale)))
    print(f"wrote {out}  (KV scale tables {k_scale.shape}, model={model}, "
          f"vocab={vocab})")
    return out


def main(argv=None) -> int:
    from pdnlp_tpu_torch.serve.quant import (
        is_quantized, quant_error_report, quantize_state,
    )
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint", help="params checkpoint (.pt or .msgpack)")
    p.add_argument("-o", "--output", default=None,
                   help="artifact path (default: <stem>.int8.<ext>)")
    p.add_argument("--kv_calib", default=None, metavar="MODEL",
                   help="also write the int8 KV-cache scale tables for this "
                        "registry model (generative decoding, --kv_dtype "
                        "int8): a seeded synthetic causal forward on the CPU")
    ns = p.parse_args(argv)

    raw = ckpt.load_raw(ns.checkpoint)
    sd = ckpt.params_from_raw(raw, ns.checkpoint)
    if is_quantized(sd):
        print(f"{ns.checkpoint} is already an int8 artifact", file=sys.stderr)
        return 1
    if ns.kv_calib:
        emit_kv_scales(sd, ns.kv_calib, ns.checkpoint)
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
