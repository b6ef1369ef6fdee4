"""Seeded weights, made on the device in one large draw: every matrix
from a normal of the configuration's ``initializer_range``, biases zero,
LayerNorm scales one; a mixture of experts' experts are independent
draws.  The benchmark hands the same weights to the program and to the
reference."""
from __future__ import annotations

from typing import Dict

import torch

from gpubench.reference.model import param_shapes


def make(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(cfg)
    total = sum(_numel(s) for s, kind in shapes.values() if kind == "matrix")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    flat.mul_(cfg["initializer_range"])
    out, off = {}, 0
    for name, (shape, kind) in shapes.items():
        if kind == "matrix":
            n = _numel(shape)
            out[name] = flat[off:off + n].view(shape)
            off += n
        elif kind == "scale":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy ``weights`` into ``model``'s parameters, name for name; every
    parameter must be covered, shape for shape."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(
            "the program's parameters differ from the configuration's: "
            f"only in the program {sorted(set(params) - set(weights))[:5]}, "
            f"only in the configuration "
            f"{sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            w = weights[name]
            if tuple(p.shape) != tuple(w.shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, "
                                 f"configuration {tuple(w.shape)}")
            p.copy_(w)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
