"""Whole-file scoring (``pdnlp_tpu/serve/offline.py``): texts are encoded
ragged, grouped by covering bucket, run in fixed-shape batches, and the
results re-assembled in input order — deterministic, no queueing."""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pdnlp_tpu_torch.serve.batcher import (
    DEFAULT_BUCKETS, pick_bucket, usable_buckets,
)
from pdnlp_tpu_torch.serve.engine import InferenceEngine


def score_texts(
    engine: InferenceEngine,
    texts: Sequence[str],
    *,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    batch_size: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """(preds ``[N]``, logits ``[N, num_labels]``) in input order."""
    usable = usable_buckets(buckets, engine.args.max_seq_len)
    # encode truncates to the largest bucket, so every row fits the bucket
    # pick_bucket assigns it
    ids = engine.tokenizer.encode_ragged(texts, usable[-1])
    by_bucket: dict = {}
    for i, row in enumerate(ids):
        by_bucket.setdefault(pick_bucket(len(row), usable), []).append(i)

    logits = np.zeros((len(texts), engine.cfg.num_labels), np.float32)
    rows = engine.pad_rows(batch_size)
    for bucket in sorted(by_bucket):
        order = by_bucket[bucket]
        for start in range(0, len(order), rows):
            chunk = order[start: start + rows]
            engine.metrics.requests_total.inc(len(chunk))
            t0 = time.monotonic()
            out = engine.infer_ids([ids[i] for i in chunk], bucket, rows=rows)
            batch_ms = (time.monotonic() - t0) * 1e3
            engine.metrics.batches_total.inc()
            engine.metrics.batch_occupancy.observe(len(chunk) / rows)
            for j, i in enumerate(chunk):
                # offline latency is the batch's execution time
                engine.metrics.request_latency_ms.observe(batch_ms)
                logits[i] = out[j]
    return np.argmax(logits, axis=-1), logits


def score_file(
    engine: InferenceEngine,
    path: str,
    *,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    batch_size: int = 8,
    limit: Optional[int] = None,
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Classify a text file (one UTF-8 text per line, blanks skipped):
    returns (texts, preds, logits)."""
    with open(path, encoding="utf-8") as f:
        texts = [line.strip() for line in f if line.strip()]
    if limit is not None:
        texts = texts[:limit]
    preds, logits = score_texts(engine, texts, buckets=buckets,
                                batch_size=batch_size)
    return texts, preds, logits
