"""BERT-style WordPiece tokenizer with a corpus-built vocabulary.

The port's own copy of ``pdnlp_tpu/data/tokenizer.py`` (same ids, byte for
byte): every CJK char is its own token, latin words are greedy-matched with
``##`` continuations, and encoding frames ``[CLS] tokens [SEP]``.
``data.native.attach`` binds the C++ encoder (``csrc/wordpiece.cpp``, built
into the port's build directory) to a tokenizer: ``encode_batch``,
``encode_ids`` and ``encode_ragged`` then run natively, with the same ids.
"""
from __future__ import annotations

import collections
import os
import unicodedata
from typing import Dict, Iterable, List, Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = [PAD, UNK, CLS, SEP, MASK]
DEFAULT_VOCAB_SIZE = 21_128  # shape parity with chinese-bert-wwm-ext


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lower: bool = True) -> List[str]:
    """Whitespace/punct split with each CJK char isolated (BERT basic tokenizer)."""
    if lower:
        text = text.lower()
    out: List[str] = []
    buf: List[str] = []

    def flush():
        if buf:
            out.append("".join(buf))
            buf.clear()

    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        if ch.isspace():
            flush()
        elif _is_cjk(cp) or _is_punct(ch):
            flush()
            out.append(ch)
        else:
            buf.append(ch)
    flush()
    return out


def wordpiece(token: str, vocab: Dict[str, int], max_chars: int = 100) -> List[str]:
    """Greedy longest-match-first subword split; whole-token [UNK] on failure."""
    if len(token) > max_chars:
        return [UNK]
    pieces: List[str] = []
    start = 0
    while start < len(token):
        end = len(token)
        cur = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                cur = sub
                break
            end -= 1
        if cur is None:
            return [UNK]
        pieces.append(cur)
        start = end
    return pieces


def build_vocab(
    texts: Iterable[str],
    size: int = DEFAULT_VOCAB_SIZE,
    min_freq: int = 1,
) -> List[str]:
    """Deterministic corpus-driven vocab: specials, then tokens by (-freq, token).

    Whole basic-tokens are kept, plus ``##``-suffix pieces of every non-CJK
    token so OOV latin words still decompose instead of collapsing to [UNK].
    """
    counts: collections.Counter = collections.Counter()
    for text in texts:
        for tok in basic_tokenize(text):
            counts[tok] += 1
            if len(tok) > 1 and not _is_cjk(ord(tok[0])):
                for i in range(1, len(tok)):
                    counts["##" + tok[i]] += 1
    ranked = sorted(
        (t for t, c in counts.items() if c >= min_freq),
        key=lambda t: (-counts[t], t),
    )
    return SPECIALS + ranked[: size - len(SPECIALS)]


def save_vocab(vocab: Sequence[str], path: str) -> None:
    """Atomic write: concurrent processes building the same deterministic
    vocab race harmlessly through the rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    os.replace(tmp, path)


def load_vocab(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.rstrip("\n")]


class WordPieceTokenizer:
    """Text -> ``[CLS] ids [SEP]`` token ids over a fixed vocabulary."""

    def __init__(self, vocab: Sequence[str], lower: bool = True):
        self.vocab_list = list(vocab)
        self.vocab = {t: i for i, t in enumerate(self.vocab_list)}
        self.lower = lower
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        self._native = None  # set by data.native.attach()

    @property
    def vocab_size(self) -> int:
        return len(self.vocab_list)

    def tokenize(self, text: str) -> List[str]:
        pieces: List[str] = []
        for tok in basic_tokenize(text, self.lower):
            pieces.extend(wordpiece(tok, self.vocab))
        return pieces

    def encode_ids(self, text: str, max_len: int = 128) -> List[int]:
        """Unpadded ``[CLS] ids [SEP]``, truncated to ``max_len``."""
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 ([CLS]+[SEP]), got {max_len}")
        if self._native is not None:
            return self.encode_ragged([text], max_len)[0]
        ids = [self.vocab.get(p, self.unk_id) for p in self.tokenize(text)]
        return [self.cls_id] + ids[: max_len - 2] + [self.sep_id]

    def encode_ragged(self, texts: Sequence[str], max_len: int = 128) -> List[List[int]]:
        """Unpadded ``[CLS] ids [SEP]`` per text — true lengths pick the
        serving bucket before ``data.collate.pad_ids_to_bucket`` fixes the
        shape."""
        if self._native is not None:
            b = self._native.encode_batch(texts, max_len)
            return [row[:n].tolist() for row, n in
                    zip(b["input_ids"], b["attention_mask"].sum(axis=1))]
        return [self.encode_ids(t, max_len) for t in texts]

    def encode_batch(self, texts: Sequence[str],
                     max_len: int = 128) -> Dict[str, np.ndarray]:
        """Fixed-width training encoding: ``[CLS] ids [SEP]`` truncated and
        padded with [PAD] to ``max_len``; int32 ``input_ids``,
        ``attention_mask`` and (all-zero) ``token_type_ids``."""
        if self._native is not None:
            return self._native.encode_batch(texts, max_len)
        n = len(texts)
        input_ids = np.full((n, max_len), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((n, max_len), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = self.encode_ids(text, max_len)
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": np.zeros((n, max_len), dtype=np.int32),
        }


def get_or_build_vocab(args) -> List[str]:
    """Load the cached corpus vocab, building it from ``args.data_path`` on
    first use."""
    from pdnlp_tpu_torch.data.corpus import load_data

    if os.path.exists(args.vocab_path):
        return load_vocab(args.vocab_path)
    vocab = build_vocab(t for t, _ in load_data(args.data_path))
    save_vocab(vocab, args.vocab_path)
    return vocab
