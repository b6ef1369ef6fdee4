"""Metrics (``pdnlp_tpu/utils/metrics.py``): the serving observability
primitives ``Counter`` / ``Gauge`` / ``Histogram`` (thread-safe,
JSON-snapshot friendly, aggregated by ``serve.metrics.ServeMetrics``) and
``merged_percentiles`` over several histograms' windows, the
input pipeline's ``TransportStats`` and the eval report
``classification_report``, byte for byte."""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np


class Counter:
    """Monotonic event count (thread-safe: batcher worker + submitters)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value (e.g. queue depth)."""

    def __init__(self) -> None:
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Streaming histogram with exact percentiles over a bounded window:
    count/sum/min/max are exact over all observations, percentiles over the
    most recent ``window`` of them.  Thread-safe."""

    def __init__(self, window: int = 8192):
        self._lock = threading.Lock()
        self._window = int(window)
        self._recent: List[float] = []
        self._pos = 0  # ring-buffer cursor once the window is full
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._recent) < self._window:
                self._recent.append(v)
            else:
                self._recent[self._pos] = v
                self._pos = (self._pos + 1) % self._window

    def percentile(self, p: float) -> Optional[float]:
        return (self.percentiles((p,)) or [None])[0]

    def percentiles(self, ps: Sequence[float]) -> Optional[List[float]]:
        """All requested percentiles over one copy of the window."""
        with self._lock:
            if not self._recent:
                return None
            window = np.asarray(self._recent)
        return [float(v) for v in np.percentile(window, list(ps))]

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def snapshot(self) -> Dict[str, Optional[float]]:
        """JSON-ready summary: count/mean/min/max + p50/p95/p99."""
        ps = self.percentiles((50, 95, 99)) or [None, None, None]
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": ps[0],
            "p95": ps[1],
            "p99": ps[2],
        }


def merged_percentiles(hists: Sequence[Histogram],
                       ps: Sequence[float]) -> List[Optional[float]]:
    """Percentiles over the POOLED recent windows of several histograms —
    one fleet-level p99, not an average of per-instrument p99s (averaging
    percentiles understates the tail whenever load is uneven across
    units, which is exactly when the pool-split controller must act).
    Returns ``None`` per requested percentile when no histogram has
    observations yet."""
    windows = []
    for h in hists:
        with h._lock:
            if h._recent:
                windows.append(np.asarray(h._recent))
    if not windows:
        return [None] * len(ps)
    pooled = np.concatenate(windows)
    return [float(v) for v in np.percentile(pooled, list(ps))]


class TransportStats:
    """Host->device transport of one input pipeline (``data.pipeline``).

    Tells *in-loop* uploads (paid per step, inside the epoch: what the
    resident pipeline removes) from *amortized* ones (the one-time upload
    of the split and the per-epoch permutation), and counts the rows and
    token positions fed, real and padding, overall and per token width.
    Thread-safe: the prefetch pipeline records from its upload worker
    while the train loop reads.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.mode: Optional[str] = None
        self.bytes_total = 0        # every host->device upload
        self.bytes_in_loop = 0      # uploads issued per step, in the loop
        self.puts_in_loop = 0
        self.puts_amortized = 0
        self.put_wait_sec = 0.0     # host seconds blocked inside put()
        self.steps = 0              # optimizer steps fed
        self.rows = 0               # label slots fed (filler included)
        self.rows_real = 0          # weight-1 slots (real examples)
        self.tokens = 0             # token positions fed (rows x seq_len)
        self.tokens_real = 0        # attention-mask-1 positions (non-[PAD])
        self.by_bucket: Dict[int, Dict[str, int]] = {}  # seq_len -> counters
        self.in_flight = 0          # uploaded but not yet handed to the loop
        self.in_flight_max = 0

    def record_upload(self, nbytes: int, wait_sec: float,
                      in_loop: bool = True) -> None:
        with self._lock:
            self.bytes_total += int(nbytes)
            self.put_wait_sec += float(wait_sec)
            if in_loop:
                self.bytes_in_loop += int(nbytes)
                self.puts_in_loop += 1
            else:
                self.puts_amortized += 1

    def record_batch(self, steps: int, rows: int, rows_real: int,
                     seq_len: int = 0, tokens: int = 0,
                     tokens_real: int = 0) -> None:
        """``tokens`` positions were paid for (input rows x width; under
        packing fewer than the example count suggests), ``tokens_real``
        of them were not [PAD]; both also per ``seq_len``."""
        with self._lock:
            self.steps += int(steps)
            self.rows += int(rows)
            self.rows_real += int(rows_real)
            if seq_len:
                self.tokens += int(tokens)
                self.tokens_real += int(tokens_real)
                b = self.by_bucket.setdefault(
                    int(seq_len),
                    {"steps": 0, "rows": 0, "rows_real": 0, "tokens": 0,
                     "tokens_real": 0})
                b["steps"] += int(steps)
                b["rows"] += int(rows)
                b["rows_real"] += int(rows_real)
                b["tokens"] += int(tokens)
                b["tokens_real"] += int(tokens_real)

    def put_started(self) -> None:
        with self._lock:
            self.in_flight += 1
            self.in_flight_max = max(self.in_flight_max, self.in_flight)

    def put_delivered(self) -> None:
        with self._lock:
            self.in_flight -= 1

    @property
    def bytes_per_step(self) -> float:
        """In-loop bytes per optimizer step: 0 for the resident pipeline."""
        return self.bytes_in_loop / self.steps if self.steps else 0.0

    @property
    def padding_waste(self) -> float:
        """Fraction of fed label slots that were zero-weight filler."""
        return 1.0 - self.rows_real / self.rows if self.rows else 0.0

    @property
    def padding_waste_tokens(self) -> float:
        """Fraction of fed token positions that were [PAD]: the work the
        length-aware modes (bucket, pack) save."""
        return 1.0 - self.tokens_real / self.tokens if self.tokens else 0.0

    def snapshot(self) -> Dict[str, object]:
        """JSON-ready summary."""
        with self._lock:
            snap = {
                "mode": self.mode,
                "steps": self.steps,
                "puts_in_loop": self.puts_in_loop,
                "puts_amortized": self.puts_amortized,
                "bytes_uploaded_total": self.bytes_total,
                "bytes_uploaded_in_loop": self.bytes_in_loop,
                "bytes_per_step": round(self.bytes_per_step, 2),
                "put_wait_sec": round(self.put_wait_sec, 6),
                "padding_waste_ratio": round(self.padding_waste, 6),
                "padding_waste_tokens": round(self.padding_waste_tokens, 6)
                if self.tokens else None,
                "prefetch_in_flight_max": self.in_flight_max,
            }
            if self.by_bucket:
                snap["by_bucket"] = {
                    str(seq): {
                        **b,
                        "padding_waste_tokens": round(
                            1.0 - b["tokens_real"] / b["tokens"], 6)
                        if b["tokens"] else 0.0,
                    }
                    for seq, b in sorted(self.by_bucket.items())
                }
            return snap


def per_class_stats(y_true: Sequence[int], y_pred: Sequence[int], num_classes: int):
    t = np.asarray(y_true, np.int64)
    p = np.asarray(y_pred, np.int64)
    stats = []
    for c in range(num_classes):
        tp = int(((p == c) & (t == c)).sum())
        fp = int(((p == c) & (t != c)).sum())
        fn = int(((p != c) & (t == c)).sum())
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        stats.append({"precision": prec, "recall": rec, "f1": f1,
                      "support": int((t == c).sum())})
    return stats


def accuracy(y_true, y_pred) -> float:
    t = np.asarray(y_true)
    return float((t == np.asarray(y_pred)).mean()) if len(t) else 0.0


def classification_report(
    y_true: Sequence[int],
    y_pred: Sequence[int],
    target_names: Optional[List[str]] = None,
    num_classes: Optional[int] = None,
) -> str:
    n = num_classes or (len(target_names) if target_names
                        else int(max(max(y_true, default=0), max(y_pred, default=0))) + 1)
    names = target_names or [str(i) for i in range(n)]
    stats = per_class_stats(y_true, y_pred, n)
    total = len(np.asarray(y_true))
    width = max(12, max(len(s) for s in names) + 2)

    lines = [f"{'':>{width}}  precision    recall  f1-score   support", ""]
    for name, s in zip(names, stats):
        lines.append(f"{name:>{width}}  {s['precision']:9.2f} {s['recall']:9.2f} "
                     f"{s['f1']:9.2f} {s['support']:9d}")
    acc = accuracy(y_true, y_pred)
    macro = {k: float(np.mean([s[k] for s in stats])) for k in ("precision", "recall", "f1")}
    wsum = sum(s["support"] for s in stats) or 1
    weighted = {k: float(sum(s[k] * s["support"] for s in stats) / wsum)
                for k in ("precision", "recall", "f1")}
    lines += [
        "",
        f"{'accuracy':>{width}}  {'':9} {'':9} {acc:9.2f} {total:9d}",
        f"{'macro avg':>{width}}  {macro['precision']:9.2f} {macro['recall']:9.2f} "
        f"{macro['f1']:9.2f} {total:9d}",
        f"{'weighted avg':>{width}}  {weighted['precision']:9.2f} {weighted['recall']:9.2f} "
        f"{weighted['f1']:9.2f} {total:9d}",
    ]
    return "\n".join(lines)
