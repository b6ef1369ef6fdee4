"""ctypes binding for the C++ WordPiece tokenizer — the port's twin of
``pdnlp_tpu/data/native.py``, over the same source.

The library is built at first use, into ``pdnlp_tpu_torch/build/``
(gitignored), from the repo's ``csrc/wordpiece.cpp`` and a ``tables.h``
generated beside a copy of it by ``csrc/gen_tables.py`` (the tables are
not in git).  It is named by a hash of the sources, the flags and the
interpreter's Unicode version (the tables come from its ``unicodedata``),
written under a temporary name and renamed into place, so processes racing
on one build both end up with a whole library.  Nothing is written into
``csrc/``, and a ``tables.h`` or library found there is never used: the
build is always this checkout's own.

``attach(tokenizer)`` keeps the JAX contract: it binds the native encoder
when the build succeeds, else leaves the pure-Python path in place and
returns False.  The two encoders are bit for bit the same (the Unicode
tables are generated from Python's ``unicodedata``); ctypes releases the
GIL during ``wp_encode_batch``, so tokenizing in one thread overlaps device
work in another.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import unicodedata
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "csrc" / "wordpiece.cpp"
GEN_TABLES = _REPO / "csrc" / "gen_tables.py"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_LOCK = threading.Lock()


def _target() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + GEN_TABLES.read_bytes()
        + " ".join(CXX_FLAGS).encode()
        + unicodedata.unidata_version.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwordpiece-{digest}.so"


def build() -> Optional[str]:
    """Compile the shared library if it is not built yet; its path, or
    None when the source or ``g++`` is missing or the build fails."""
    with _LOCK:
        if not (SOURCE.exists() and GEN_TABLES.exists()):
            return None
        target = _target()
        if target.exists():
            return str(target)
        # the source is compiled from a private copy, so its quoted
        # ``#include "tables.h"`` finds the tables generated here
        work = BUILD_DIR / f"{target.stem}.{os.getpid()}.src"
        work.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        try:
            tables = subprocess.run([sys.executable, str(GEN_TABLES)],
                                    capture_output=True, text=True)
            if tables.returncode != 0:
                return None
            (work / "tables.h").write_text(tables.stdout)
            shutil.copyfile(SOURCE, work / SOURCE.name)
            cxx = os.environ.get("CXX", "g++")
            r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                                str(work / SOURCE.name)],
                               capture_output=True, text=True)
        except OSError:
            return None
        finally:
            shutil.rmtree(work, ignore_errors=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, target)
        return str(target)


class NativeEncoder:
    """Wraps one ``wp_create`` handle; mirrors ``encode_batch``'s contract."""

    def __init__(self, vocab: Sequence[str], so_path: str):
        self._lib = ctypes.CDLL(so_path)
        self._lib.wp_create.restype = ctypes.c_void_p
        self._lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        self._lib.wp_destroy.argtypes = [ctypes.c_void_p]
        self._lib.wp_vocab_size.restype = ctypes.c_int32
        self._lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
        self._lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        buf = ("\n".join(vocab) + "\n").encode("utf-8")
        self._handle = self._lib.wp_create(buf, len(buf))
        if not self._handle:
            raise ValueError("vocab is missing required special tokens")
        native_n = self._lib.wp_vocab_size(self._handle)
        if native_n != len(vocab):
            raise ValueError(
                f"vocab has {len(vocab) - native_n} duplicate tokens — native "
                "and Python id assignment would disagree")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.wp_destroy(self._handle)
            self._handle = None

    def encode_batch(self, texts: Sequence[str], max_len: int = 128
                     ) -> Dict[str, np.ndarray]:
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 ([CLS]+[SEP]), got {max_len}")
        n = len(texts)
        raw = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(b) for b in raw], out=offsets[1:])
        blob = b"".join(raw)
        input_ids = np.zeros((n, max_len), dtype=np.int32)
        attention_mask = np.zeros((n, max_len), dtype=np.int32)
        self._lib.wp_encode_batch(self._handle, blob, offsets, n, max_len,
                                  input_ids, attention_mask)
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": np.zeros((n, max_len), dtype=np.int32),
        }


def attach(tokenizer, so_path: Optional[str] = None) -> bool:
    """Bind the native encoder to a ``WordPieceTokenizer``, building the
    library first if needed; True on success (``encode_batch``,
    ``encode_ids`` and ``encode_ragged`` are then native)."""
    so_path = so_path or build()
    if so_path is None or not os.path.exists(so_path):
        return False
    try:
        tokenizer._native = NativeEncoder(tokenizer.vocab_list, so_path)
        return True
    except (OSError, ValueError):
        return False
