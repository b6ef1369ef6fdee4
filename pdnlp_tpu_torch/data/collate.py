"""Padded serving batches: ragged token-id lists -> one fixed-shape batch
(the serving half of ``pdnlp_tpu/data/collate.py``, numpy on the host)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]


def pad_ids_to_bucket(id_lists: Sequence[Sequence[int]], seq_len: int,
                      rows: int = 0, pad_id: int = 0) -> Batch:
    """Ragged token-id lists -> one fixed ``[rows, seq_len]`` batch.

    Every row pads to the bucket length and the row count pads up to
    ``rows`` with zero-weight filler rows (all-zero attention mask), so one
    forward shape per ``(seq_len, rows)`` covers every batch in the bucket.
    A row longer than ``seq_len`` is a caller bug and raises.
    """
    n = len(id_lists)
    rows = max(rows, n)
    input_ids = np.full((rows, seq_len), pad_id, dtype=np.int32)
    attention_mask = np.zeros((rows, seq_len), dtype=np.int32)
    for i, ids in enumerate(id_lists):
        if len(ids) > seq_len:
            raise ValueError(f"row {i} has {len(ids)} tokens > bucket "
                             f"{seq_len} — pick_bucket must cover its rows")
        input_ids[i, : len(ids)] = ids
        attention_mask[i, : len(ids)] = 1
    w = np.zeros((rows,), np.float32)
    w[:n] = 1.0
    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "token_type_ids": np.zeros((rows, seq_len), dtype=np.int32),
        "example_weight": w,
    }
