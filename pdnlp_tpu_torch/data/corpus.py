"""Corpus reading and the label names (``pdnlp_tpu/data/corpus.py``).

``load_data`` reads ``train.json`` — one JSON array of ``[text, label]``
pairs, text pre-tokenized with spaces — and re-joins each text by
stripping the spaces.
"""
from __future__ import annotations

import json
from typing import List, Tuple

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
