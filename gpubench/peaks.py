"""The yardstick: the card's published peaks and the operations and bytes
that each measured piece of work needs.

Peaks are those of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).
Attention counts only the (query, key) pairs its segments need; expert
products count the assignments that keep a slot.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def elem_bytes(dtype: str) -> int:
    return 4 if dtype == "float32" else 2


def bound_s(nbytes: float, flops: float, dtype: str):
    """(least seconds, what sets it): bytes over the memory rate or
    operations over the peak rate of the type, the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def needed_pairs(seg: np.ndarray) -> int:
    """The (query, key) pairs attention needs on packed rows ``seg``
    ``[B, S]`` (1-based segments, 0 = padding): same-segment pairs, and
    every key for a padding query."""
    pairs = 0
    S = seg.shape[1]
    for row in seg:
        _ids, counts = np.unique(row[row > 0], return_counts=True)
        pairs += int((counts.astype(np.int64) ** 2).sum())
        pairs += int((row == 0).sum()) * S
    return pairs


def attention_fwd_bound(seg: np.ndarray, N: int, D: int, dtype: str):
    """The forward: q, k, v read and o written once, plus the int32
    segment ids; the two products over the needed pairs."""
    B, S = seg.shape
    nbytes = 4 * B * S * N * D * elem_bytes(dtype) + B * S * 4
    flops = 4 * D * N * needed_pairs(seg)
    return bound_s(nbytes, flops, dtype)


def attention_bwd_bound(seg: np.ndarray, N: int, D: int, dtype: str):
    """The backward: q, k, v, o and dO read and dq, dk, dv written once,
    plus the segment ids; the four products dV, dP, dQ and dK over the
    needed pairs (the scores' recompute is not needed work)."""
    B, S = seg.shape
    nbytes = 8 * B * S * N * D * elem_bytes(dtype) + B * S * 4
    flops = 8 * D * N * needed_pairs(seg)
    return bound_s(nbytes, flops, dtype)


def expert_products_bound(kept_per_expert, H: int, I: int, dtype: str):
    """One layer's expert products, forward (up, down) and backward (each
    one's two products), over ``kept_per_expert`` assignments each: every
    product reads its two operands and writes its result once."""
    e = elem_bytes(dtype)
    rows = int(sum(kept_per_expert))
    E = len(kept_per_expert)
    nbytes = e * (2 * (rows * H + E * H * I + rows * I)      # up, d(x)
                  + 2 * (rows * I + E * I * H + rows * H)    # down, d(h)
                  + (rows * I + rows * H + E * I * H)        # d(down)
                  + (rows * H + rows * I + E * H * I))       # d(up)
    flops = 6 * 2 * rows * H * I
    return bound_s(nbytes, flops, dtype)


def step_flops(cfg: Dict, tokens: int, examples: int, pairs: int) -> float:
    """Model operations of training steps over ``tokens`` real tokens,
    ``examples`` examples and ``pairs`` same-segment (query, key) pairs:
    6 x the matrix parameters each token or example passes through (the
    top-k experts' for an MoE layer), plus attention's products forward
    (4 x width per pair) and backward (8 x).  Nothing recomputed counts."""
    H, I, L = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["num_hidden_layers"]
    E = cfg.get("moe_experts", 0)
    ffn = 2 * H * I * (cfg["moe_top_k"] if E else 1) + (H * E if E else 0)
    per_token = L * (4 * H * H + ffn)
    per_example = H * H + H * cfg["num_labels"]
    return 6.0 * (per_token * tokens + per_example * examples) \
        + 12.0 * H * L * pairs


def share_pct(bound: Optional[float], seconds: Optional[float]):
    """100 x bound / measured, or None where either is missing."""
    if bound is None or not seconds or seconds <= 0:
        return None
    return 100.0 * bound / seconds
