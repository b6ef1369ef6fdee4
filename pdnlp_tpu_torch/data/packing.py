"""Packed serving batches: many requests per fixed-width row.

The serving half of ``pdnlp_tpu/data/packing.py``: :func:`pack_id_lists`
bin-packs ragged token-id lists into one ``[rows, seq_len]`` batch with
segment channels, and :func:`segment_bias` is the block-diagonal mask the
plain attention path builds from them (the flash kernel computes the same
mask in-kernel from the IDs instead).  Packing itself is numpy on the host,
byte for byte the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def pack_id_lists(
    id_lists: Sequence[Sequence[int]],
    seq_len: int,
    rows: int,
    max_segments: int,
    pad_id: int = 0,
) -> Tuple[Dict[str, np.ndarray], List[Optional[Tuple[int, int]]]]:
    """Bin-pack ragged token-id lists into ONE fixed ``[rows, seq_len]``
    packed batch.

    The caller's order is the priority order: placement is first-fit over
    the open rows in order, and a list that fits nowhere right now is
    skipped while later, shorter lists may still fill the gaps it left.
    Positions restart per segment, so each request sees exactly the
    position embeddings of its own padded forward.

    Returns ``(batch, placements)``: ``placements[i]`` is the ``(row, slot)``
    the ``i``-th list landed at, or ``None`` if it did not fit.  ``batch``
    always has the full ``rows x seq_len`` shape (unused rows stay padding).
    """
    S, R, M = int(seq_len), int(rows), int(max_segments)
    if R < 1 or M < 1:
        raise ValueError(f"need rows >= 1 and max_segments >= 1, "
                         f"got rows={R} max_segments={M}")
    input_ids = np.full((R, S), pad_id, np.int32)
    segment_ids = np.zeros((R, S), np.int32)
    position_ids = np.zeros((R, S), np.int32)
    cls_pos = np.zeros((R, M), np.int32)
    used = [0] * R     # tokens occupied per row
    segs = [0] * R     # segments opened per row
    opened = 0         # rows touched so far (first-fit opens them in order)
    placements: List[Optional[Tuple[int, int]]] = []
    for ids in id_lists:
        L = len(ids)
        if L > S:
            raise ValueError(f"list of {L} tokens exceeds the {S}-token "
                             "pack width — truncate before packing")
        if L == 0:
            # a phantom segment's cls_positions entry would alias the next
            # segment's offset and hand its caller a neighbor's logits
            raise ValueError("empty id list cannot be packed — reject "
                             "empty requests before batch formation")
        row = next((r for r in range(opened)
                    if segs[r] < M and used[r] + L <= S), None)
        if row is None:
            if opened >= R:
                placements.append(None)  # full batch: ride the next one
                continue
            row = opened
            opened += 1
        off = used[row]
        input_ids[row, off: off + L] = np.asarray(ids, np.int32)
        segment_ids[row, off: off + L] = segs[row] + 1
        position_ids[row, off: off + L] = np.arange(L, dtype=np.int32)
        cls_pos[row, segs[row]] = off
        placements.append((row, segs[row]))
        used[row] += L
        segs[row] += 1
    batch = {
        "input_ids": input_ids,
        "segment_ids": segment_ids,
        "position_ids": position_ids,
        "attention_mask": (segment_ids > 0).astype(np.int32),
        "token_type_ids": np.zeros((R, S), np.int32),
        "cls_positions": cls_pos,
    }
    return batch, placements


def segment_bias(segment_ids: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B, S]`` segment IDs -> ``[B, 1, S, S]`` additive attention bias:
    0 where query and key share a nonzero segment, -1e9 elsewhere.

    Built only by the plain attention path; the flash kernel derives the
    same mask on chip from the IDs."""
    q = segment_ids[:, :, None]
    k = segment_ids[:, None, :]
    same = ((q == k) & (q > 0)).to(dtype)
    return ((1.0 - same) * -1e9)[:, None, :, :]
