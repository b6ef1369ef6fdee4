"""The benchmark's own derivation of the training batches from the raw
corpus: the seeded split, one token per character, best-fit-decreasing
packing into fixed-width rows and the seeded epoch order.

Plain Python and NumPy.  It reads the corpus and vocabulary files that the
benchmark wrote and works out, independently of the program under test,
which rows each optimizer step should carry.  The rules are those of the
fine-tuning recipe the program implements (a 92/8 style split under a
seeded ``random.Random`` shuffle, ``[CLS] text [SEP]`` truncated to the row
width, longest-first best-fit packing with a segment cap, one
``RandomState(seed + epoch)`` permutation of the packed rows per epoch, the
short last batch padded with all-zero rows).
"""
from __future__ import annotations

import bisect
import json
import random
from typing import Dict, List, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP = "[PAD]", "[UNK]", "[CLS]", "[SEP]"


def read_vocab(path: str) -> Dict[str, int]:
    with open(path, encoding="utf-8") as f:
        words = [line.rstrip("\n") for line in f if line.rstrip("\n")]
    return {w: i for i, w in enumerate(words)}


def read_corpus(path: str) -> List[Tuple[str, int]]:
    with open(path, encoding="utf-8") as f:
        return [("".join(t.split(" ")).strip(), int(y))
                for t, y in json.load(f)]


def split(examples: Sequence[Tuple[str, int]], seed: int, limit: int,
          ratio: float) -> List[Tuple[str, int]]:
    """The training part of the seeded split."""
    data = list(examples[:limit])
    random.Random(seed).shuffle(data)
    return data[:int(len(data) * ratio)]


def encode(texts: Sequence[str], vocab: Dict[str, int], width: int
           ) -> List[np.ndarray]:
    """``[CLS] chars [SEP]`` ids per text, cut to ``width`` tokens."""
    unk, cls, sep = vocab[UNK], vocab[CLS], vocab[SEP]
    out = []
    for t in texts:
        ids = [vocab.get(c, unk) for c in t.lower() if not c.isspace()]
        out.append(np.asarray([cls] + ids[:width - 2] + [sep], np.int32))
    return out


def bfd_rows(lengths: np.ndarray, width: int, cap: int) -> List[List[int]]:
    """Best-fit decreasing: items longest first (ties by index), each into
    the open row with the least free room that holds it (ties to the lower
    row), a new row when none does; a row closes at ``cap`` items or when
    full."""
    rows: List[List[int]] = []
    free: List[tuple] = []                       # sorted (room, row)
    for i in np.argsort(-np.asarray(lengths), kind="stable").tolist():
        n = int(lengths[i])
        j = bisect.bisect_left(free, (n, -1))
        if j < len(free):
            room, r = free.pop(j)
            rows[r].append(i)
            if len(rows[r]) < cap and room - n > 0:
                bisect.insort(free, (room - n, r))
        else:
            rows.append([i])
            if cap > 1 and width - n > 0:
                bisect.insort(free, (width - n, len(rows) - 1))
    return rows


class Packed:
    """The packed training rows: token ids, segment ids (1-based, 0 =
    padding), positions restarting per segment, each segment's [CLS]
    offset, label and weight (0 = empty slot)."""

    def __init__(self, ids: Sequence[np.ndarray], labels: Sequence[int],
                 width: int, cap: int):
        lengths = np.asarray([len(x) for x in ids], np.int64)
        rows = bfd_rows(lengths, width, cap)
        n = len(rows)
        self.width, self.cap, self.n = width, cap, n
        self.input_ids = np.zeros((n, width), np.int32)
        self.segment_ids = np.zeros((n, width), np.int32)
        self.position_ids = np.zeros((n, width), np.int32)
        self.cls_positions = np.zeros((n, cap), np.int32)
        self.label = np.zeros((n, cap), np.int32)
        self.example_weight = np.zeros((n, cap), np.float32)
        self.row_tokens = np.zeros((n,), np.int64)
        self.row_pairs = np.zeros((n,), np.int64)
        self.row_examples = np.zeros((n,), np.int64)
        for r, members in enumerate(rows):
            off = 0
            for s, e in enumerate(members):
                L = int(lengths[e])
                self.input_ids[r, off:off + L] = ids[e]
                self.segment_ids[r, off:off + L] = s + 1
                self.position_ids[r, off:off + L] = np.arange(L)
                self.cls_positions[r, s] = off
                self.label[r, s] = labels[e]
                self.example_weight[r, s] = 1.0
                self.row_pairs[r] += L * L
                off += L
            self.row_tokens[r] = off
            self.row_examples[r] = len(members)

    def batch(self, rows: np.ndarray) -> Dict[str, np.ndarray]:
        """The channels of ``rows`` (index ``n`` = an all-zero filler
        row)."""
        out = {}
        for k in ("input_ids", "segment_ids", "position_ids",
                  "cls_positions", "label", "example_weight"):
            a = getattr(self, k)
            a = np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)])
            out[k] = a[rows]
        out["attention_mask"] = (out["segment_ids"] > 0).astype(np.int32)
        out["token_type_ids"] = np.zeros_like(out["input_ids"])
        return out


def epoch_steps(n_rows: int, rows: int, seed: int, epoch: int) -> np.ndarray:
    """``[steps, rows]`` row indices of one epoch: the seeded permutation
    cut into batches, the last one filled up with the filler index
    ``n_rows``."""
    order = np.random.RandomState(seed + epoch).permutation(n_rows)
    steps = -(-n_rows // rows)
    out = np.full((steps * rows,), n_rows, np.int64)
    out[:n_rows] = order
    return out.reshape(steps, rows)


def derive(corpus_path: str, vocab_path: str, seed: int, limit: int,
           ratio: float, width: int, cap: int) -> Packed:
    """Corpus and vocabulary files -> the packed training rows."""
    train = split(read_corpus(corpus_path), seed, limit, ratio)
    ids = encode([t for t, _ in train], read_vocab(vocab_path), width)
    return Packed(ids, [y for _, y in train], width, cap)
