"""Corpus reading, the seeded split and the label names
(``pdnlp_tpu/data/corpus.py``).

``load_data`` reads ``train.json`` — one JSON array of ``[text, label]``
pairs, text pre-tokenized with spaces — and re-joins each text by
stripping the spaces.  ``split_data`` takes the first 10,000 examples,
shuffles them under seed 123 and cuts 92/8 into train and dev; dev doubles
as the test set.
"""
from __future__ import annotations

import json
import random
from typing import List, Sequence, Tuple

Example = Tuple[str, int]

# 6-class Chinese emotion labels: other / like / sad / disgust / anger / happy
LABELS = ["其他", "喜好", "悲伤", "厌恶", "愤怒", "高兴"]
id2label = {i: name for i, name in enumerate(LABELS)}


def load_data(path: str) -> List[Example]:
    """Read the corpus and strip pre-tokenization spaces."""
    with open(path, encoding="utf-8") as f:
        raw = json.load(f)
    return [("".join(text.split(" ")).strip(), int(label))
            for text, label in raw]


def split_data(
    data: Sequence[Example],
    seed: int = 123,
    limit: int = 10_000,
    ratio: float = 0.92,
) -> Tuple[List[Example], List[Example]]:
    """Seeded shuffle + split; returns (train, dev)."""
    data = list(data[:limit])
    random.Random(seed).shuffle(data)
    cut = int(len(data) * ratio)
    return data[:cut], data[cut:]
