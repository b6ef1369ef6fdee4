"""Mixed precision (``pdnlp_tpu/train/precision.py``): ``--dtype
bfloat16`` computes matmuls and activations in bf16 over fp32 master
weights (cast at each matmul, so gradients land in fp32), with LayerNorm,
softmax, logits and the loss in fp32.  bf16 has fp32's exponent range, so
there is no loss scaler."""
from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "f32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def resolve_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; use one of "
                         f"{sorted(_DTYPES)}") from None
