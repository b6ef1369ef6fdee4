"""Determinism (``pdnlp_tpu/utils/seeding.py``).

The host RNGs (``random``, ``numpy``) and PyTorch's CPU default stream are
seeded so the split and shuffle repeat; the model's randomness flows
through explicit ``torch.Generator``s — one for weight init (on the CPU, so
one seed gives the same weights on any device) and one for dropout (on the
training device) — the twins of the JAX package's explicit keys.  Nothing
on the training path draws from a global device stream.
"""
from __future__ import annotations

import random
from typing import Tuple

import numpy as np
import torch


def set_seed(seed: int = 123, device="cpu"
             ) -> Tuple[torch.Generator, torch.Generator]:
    """Seed ``random``, ``numpy`` and ``torch``; return ``(init, dropout)``
    generators, the first on the CPU, the second on ``device``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    init = torch.Generator().manual_seed(seed)
    dropout = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return init, dropout
