"""Per-output-channel symmetric int8 weight quantization for the serve
forward — the twin of ``pdnlp_tpu/serve/quant.py`` on the port's
``state_dict``.

``serve_dtype int8`` keeps the dense weights as int8 plus one fp32 scale
per output channel; activations stay bf16, and the scale multiplies the
matmul OUTPUT (``x @ (q * s) == (x @ q) * s`` for per-column scales), as
in the JAX ``_dense`` (``models.bert._dense``).

The port stores ``nn.Linear`` weights ``[out, in]`` — the transpose of the
JAX ``[in, out]`` kernel — so the amax runs over the last axis here and
the scale is one per ROW of the torch weight.  The int8 bytes and scales
equal JAX's ``quantize_params`` on the same weights, bit for bit, once
transposed: the same float32 division and the same round-half-to-even
(``torch.round`` as ``np.rint``).

Scope, as in JAX: q/k/v/o, the MLP up/down, pooler and classifier — every
``<name>.weight`` of an ``nn.Linear`` — and the MoE expert stacks, each
``<name>.kernel`` ``[E, in, out]`` with a ``<name>.bias`` (the JAX layout:
the amax runs over ``in``, one scale per expert and output channel,
:func:`quantize_kernel`).  Embeddings, LayerNorms, biases and the bias-less
MoE gate stay fp32.  A quantized block in a ``state_dict`` is ``<name>.weight``
(int8 ``[out, in]``), ``<name>.qscale`` (fp32 ``[out]``) and
``<name>.bias`` (fp32); :func:`is_quantized` recognizes a
``tools.quantize_ckpt`` artifact by its ``qscale`` entries, and
``models.convert`` maps them onto the JAX tree's ``qscale`` leaves.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

#: marker suffix: a dense block carrying one is quantized
QSCALE = "qscale"


def dense_names(state_dict: Mapping[str, torch.Tensor]) -> Tuple[str, ...]:
    """The module names of the quantizable dense blocks: every ``<name>``
    with a 2-D ``<name>.weight`` and a ``<name>.bias``."""
    return tuple(k[: -len(".weight")] for k, v in state_dict.items()
                 if k.endswith(".weight") and v.ndim == 2
                 and k[: -len(".weight")] + ".bias" in state_dict)


def expert_names(state_dict: Mapping[str, torch.Tensor]
                 ) -> Tuple[str, ...]:
    """The module names of the quantizable expert stacks: every
    ``<name>`` with a 3-D ``<name>.kernel`` and a ``<name>.bias``."""
    return tuple(k[: -len(".kernel")] for k, v in state_dict.items()
                 if k.endswith(".kernel") and v.ndim == 3
                 and k[: -len(".kernel")] + ".bias" in state_dict)


def quantize_kernel(kernel: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A kernel in the JAX layout ``[..., in, out]`` (an expert stack) ->
    ``(int8, fp32 [..., out])``: JAX's ``quantize_dense`` — amax over
    ``in`` (axis -2), the same division and rounding."""
    w = kernel.detach().to(torch.float32)
    amax = w.abs().amax(dim=-2)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[..., None, :]), -127, 127)
    return q.to(torch.int8), scale


def quantize_dense(weight: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One torch weight ``[out, in]`` -> ``(int8 [out, in], fp32 [out])``:
    amax over the contraction (input) axis, scale ``amax / 127`` (1 where
    the row is all zero), ``round(w / scale)`` clipped to +-127."""
    w = weight.detach().to(torch.float32)
    amax = w.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_state(state_dict: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """A float ``state_dict`` -> its int8 serving form; everything outside
    the dense blocks passes through.  An already quantized block (one with
    a ``qscale``) passes through unchanged."""
    out = dict(state_dict)
    for name in dense_names(state_dict):
        if f"{name}.{QSCALE}" in state_dict:
            continue
        q, s = quantize_dense(state_dict[f"{name}.weight"])
        out[f"{name}.weight"] = q
        out[f"{name}.{QSCALE}"] = s
        out[f"{name}.bias"] = state_dict[f"{name}.bias"].to(torch.float32)
    for name in expert_names(state_dict):
        if f"{name}.{QSCALE}" in state_dict:
            continue
        q, s = quantize_kernel(state_dict[f"{name}.kernel"])
        out[f"{name}.kernel"] = q
        out[f"{name}.{QSCALE}"] = s
        out[f"{name}.bias"] = state_dict[f"{name}.bias"].to(torch.float32)
    return out


def dequantize_dense(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 weight -> its fp32 approximation (error reports and tests)."""
    return q.to(torch.float32) * scale.to(torch.float32)[..., None]


def is_quantized(state_dict: Mapping[str, torch.Tensor]) -> bool:
    """True when any dense block carries a ``qscale``."""
    return any(k.endswith("." + QSCALE) for k in state_dict)


def quant_error_report(state_dict: Mapping[str, torch.Tensor],
                       qstate: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Tuple[float, float]]:
    """``{name: (max_abs_err, rel_err)}`` per quantized block — the
    ``tools.quantize_ckpt`` summary (``rel_err`` over the block's amax)."""
    out: Dict[str, Tuple[float, float]] = {}
    for name in dense_names(state_dict):
        if f"{name}.{QSCALE}" not in qstate:
            continue
        w = state_dict[f"{name}.weight"].detach().to(torch.float32)
        dq = dequantize_dense(qstate[f"{name}.weight"],
                              qstate[f"{name}.{QSCALE}"])
        err = float((w - dq).abs().max())
        denom = float(w.abs().max()) or 1.0
        out[name] = (err, err / denom)
    for name in expert_names(state_dict):
        if f"{name}.{QSCALE}" not in qstate:
            continue
        w = state_dict[f"{name}.kernel"].detach().to(torch.float32)
        dq = (qstate[f"{name}.kernel"].to(torch.float32)
              * qstate[f"{name}.{QSCALE}"].to(torch.float32)[..., None, :])
        err = float((w - dq).abs().max())
        denom = float(w.abs().max()) or 1.0
        out[name] = (err, err / denom)
    return out
