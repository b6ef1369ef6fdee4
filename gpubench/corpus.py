"""The traffic generator: a traffic mix's parameter file and ``--seed`` ->
a classification corpus in the training script's format (a JSON array of
``[text, label]``) and its vocabulary file.

The vocabulary has the published 21,128 entries: the five specials, then
one CJK character per entry.  Characters are drawn Zipf-distributed over
the character entries, and the label is the first character's vocabulary
index modulo the number of labels, so the task can be learned.

Document lengths come from the mix's own fixed ``length_seed``: every
``--seed`` trains on the same multiset of lengths, so the work of a run
does not change with its seed.  The seed picks the order of the lengths,
the characters and so the labels.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
VOCAB_SIZE = 21_128


def characters(n: int = VOCAB_SIZE - len(SPECIALS)) -> List[str]:
    """``n`` CJK characters: the unified block from U+4E00, then extension
    A from U+3400."""
    chars = [chr(c) for c in range(0x4E00, 0xA000)]
    chars += [chr(c) for c in range(0x3400, 0x4DC0)]
    return chars[:n]


def lengths(spec: Dict, count: int) -> np.ndarray:
    """``count`` document lengths in characters, from the mix's
    ``lengths`` entry and its ``length_seed``."""
    rng = np.random.RandomState(int(spec["length_seed"]))
    kind = spec["lengths"]["kind"]
    if kind == "mixture":
        parts = spec["lengths"]["parts"]                 # [share, lo, hi]
        share = np.asarray([p[0] for p in parts], np.float64)
        which = rng.choice(len(parts), size=count, p=share / share.sum())
        lo = np.asarray([p[1] for p in parts])[which]
        hi = np.asarray([p[2] for p in parts])[which]
        return lo + np.floor(rng.random_sample(count) * (hi - lo + 1)
                             ).astype(np.int64)
    if kind == "lognormal":
        ln = spec["lengths"]
        x = rng.lognormal(np.log(ln["median"]), ln["sigma"], size=count)
        return np.clip(np.rint(x), ln["min"], ln["max"]).astype(np.int64)
    raise ValueError(f"unknown length kind {kind!r}")


def zipf_ranks(rng: np.random.RandomState, n_items: int, s: float,
               count: int) -> np.ndarray:
    """``count`` draws of a rank in ``[0, n_items)`` with probability
    proportional to ``1 / (rank + 1) ** s``."""
    w = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** s
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random_sample(count),
                                      side="right"), n_items - 1)


def documents(spec: Dict, seed: int) -> List[Tuple[str, int]]:
    """The mix's training and held-out documents for ``seed``."""
    count = int(spec["documents"]) + int(spec["heldout_documents"])
    lens = lengths(spec, count)
    rng = np.random.RandomState(seed)
    lens = lens[rng.permutation(count)]
    chars = np.asarray(characters())
    ranks = zipf_ranks(rng, len(chars), float(spec["zipf_s"]),
                       int(lens.sum()))
    labels = int(spec["labels"])
    out, off = [], 0
    for n in lens.tolist():
        r = ranks[off:off + n]
        off += n
        first = int(r[0]) + len(SPECIALS)
        out.append(("".join(chars[r].tolist()), first % labels))
    return out


def write(spec: Dict, seed: int, folder: str) -> Dict[str, str]:
    """Write ``corpus.json`` and ``vocab.txt`` for ``seed`` into
    ``folder``; returns their paths."""
    os.makedirs(folder, exist_ok=True)
    corpus = os.path.join(folder, "corpus.json")
    vocab = os.path.join(folder, "vocab.txt")
    with open(corpus, "w", encoding="utf-8") as f:
        json.dump(documents(spec, seed), f, ensure_ascii=False)
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(SPECIALS + characters()) + "\n")
    return {"corpus": corpus, "vocab": vocab}


def split_ratio(spec: Dict) -> float:
    """The train share whose ``int(n * ratio)`` is exactly the mix's
    ``documents``."""
    n = int(spec["documents"]) + int(spec["heldout_documents"])
    ratio = (int(spec["documents"]) + 0.5) / n
    if int(n * ratio) != int(spec["documents"]):
        raise ValueError("no split ratio gives the mix's document count")
    return ratio
