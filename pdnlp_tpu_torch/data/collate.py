"""Batch collation, numpy on the host (``pdnlp_tpu/data/collate.py``).

Training batches have a fixed shape: the last, short batch is padded with
zero-weight filler rows (``example_weight`` 0, label 0, all-zero mask),
which contribute no loss and are left out of the metrics.  Serving batches
(``pad_ids_to_bucket``) pad ragged requests to a bucket width the same way.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from pdnlp_tpu_torch.data.tokenizer import WordPieceTokenizer

Batch = Dict[str, np.ndarray]


class Collator:
    """``(text, label)`` examples -> one ``[rows, max_seq_len]`` batch."""

    def __init__(self, tokenizer: WordPieceTokenizer, max_seq_len: int = 128):
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len

    def __call__(self, examples: Sequence[Tuple[str, int]],
                 pad_to: int = 0, seq_len: int = 0) -> Batch:
        """Encode ``examples``; pad the batch up to ``pad_to`` rows and the
        token columns to ``seq_len`` (a length bucket) or ``max_seq_len``."""
        enc = self.tokenizer.encode_batch([t for t, _ in examples],
                                          seq_len or self.max_seq_len)
        n = len(examples)
        rows = max(pad_to, n)
        batch = {k: _pad_rows(v, rows) for k, v in enc.items()}
        lab = np.zeros((rows,), dtype=np.int32)
        lab[:n] = [label for _, label in examples]
        batch["label"] = lab
        batch["example_weight"] = _weights(n, rows)
        return batch


class EncodedDataset:
    """The whole split tokenized once into contiguous arrays: a batch is a
    numpy fancy-index, the same bytes as :class:`Collator` gives."""

    def __init__(self, data: Sequence[Tuple[str, int]],
                 tokenizer: WordPieceTokenizer, max_seq_len: int = 128):
        self.arrays = dict(tokenizer.encode_batch([t for t, _ in data],
                                                  max_seq_len))
        self.arrays["label"] = np.asarray([l for _, l in data], np.int32)
        self.n = len(data)
        self.seq_len = max_seq_len

    def __len__(self) -> int:
        return self.n

    def lengths(self) -> np.ndarray:
        """Real tokens per example, [CLS] and [SEP] included: what the
        length-grouped sampler buckets on."""
        return self.arrays["attention_mask"].sum(axis=1).astype(np.int64)

    def take(self, indices: Sequence[int], pad_to: int = 0,
             seq_len: int = 0) -> Batch:
        """Assemble a batch by row indices; pad with zero-weight filler.

        ``seq_len`` narrows the token columns to a bucket width: an example
        that fits the bucket holds only [PAD] (zeros) beyond it, so the
        slice is the direct encoding at ``seq_len``, byte for byte.  Only
        the full-width ``[N, seq_len]`` channels are sliced; per-segment
        channels of packed rows keep their width.  A dataset that carries
        its own ``example_weight`` (packed rows: ``[N, M]``) keeps it."""
        idx = np.asarray(indices, np.int64)
        rows = max(pad_to, len(idx))
        batch = {}
        for k, v in self.arrays.items():
            g = v[idx]
            if seq_len and v.ndim == 2 and v.shape[1] == self.seq_len \
                    and seq_len < self.seq_len:
                g = g[:, :seq_len]
            batch[k] = _pad_rows(g, rows)
        if "example_weight" not in batch:
            batch["example_weight"] = _weights(len(idx), rows)
        return batch


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _weights(n: int, rows: int) -> np.ndarray:
    w = np.zeros((rows,), np.float32)
    w[:n] = 1.0
    return w


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
    return {
        "input_ids": input_ids,
        "attention_mask": attention_mask,
        "token_type_ids": np.zeros((rows, seq_len), dtype=np.int32),
        "example_weight": _weights(n, rows),
    }
