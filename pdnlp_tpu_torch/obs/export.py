"""Trace exporters: Chrome-trace/Perfetto JSON + compact JSONL — the
port's copy of ``pdnlp_tpu/obs/export.py``, record for record, so the
JAX package's ``trace_tpu.py`` reads the port's span files.

Two formats, one span-record schema (``trace.Tracer`` records:
``{"name", "t0", "dur", "tid", "depth", "attrs"?}`` with seconds on the
tracer's monotonic clock):

- **JSONL** (``write_jsonl``/``read_jsonl``) — one span per line, compact,
  append-friendly, what ``Tracer.flush`` writes per process and what
  ``trace_tpu.py`` consumes;
- **Chrome trace** (``to_chrome_trace``/``write_chrome_trace``) — the
  ``traceEvents`` array Perfetto / ``chrome://tracing`` load directly:
  complete events (``"ph": "X"``) with microsecond ``ts``/``dur``, span
  attributes under ``args``.  Every event carries the required
  ``name/ph/ts/pid/tid`` keys (schema-pinned by ``tests/test_obs.py``).

Pure stdlib.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence


def to_chrome_trace(records: Sequence[Dict],
                    process_index: int = 0) -> Dict:
    """Span records -> a Chrome-trace dict (``json.dump`` it as-is)."""
    events = []
    for rec in records:
        events.append({
            "name": rec.get("name", "?"),
            "ph": "X",
            "ts": round(float(rec.get("t0", 0.0)) * 1e6, 3),
            "dur": round(float(rec.get("dur", 0.0)) * 1e6, 3),
            "pid": int(rec.get("pid", process_index)),
            "tid": int(rec.get("tid", 0)),
            "args": dict(rec.get("attrs") or {},
                         depth=int(rec.get("depth", 0))),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _atomic_dump(obj, path: str, *, jsonl: bool = False) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        if jsonl:
            for rec in obj:
                f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        else:
            json.dump(obj, f, indent=2)
    os.replace(tmp, path)


def write_chrome_trace(records: Sequence[Dict], path: str,
                       process_index: int = 0) -> str:
    _atomic_dump(to_chrome_trace(records, process_index), path)
    return path


def write_jsonl(records: Sequence[Dict], path: str,
                process_index: int = 0) -> str:
    """Compact per-process span log (``trace_procN.jsonl``)."""
    out = []
    for rec in records:
        rec = dict(rec)
        rec.setdefault("pid", process_index)
        out.append(rec)
    _atomic_dump(out, path, jsonl=True)
    return path


def read_jsonl(path: str) -> List[Dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def from_chrome_trace(doc: Dict) -> List[Dict]:
    """Chrome-trace dict -> span records (so ``trace_tpu.py`` can
    summarize/diff an already-exported file too)."""
    records = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args") or {})
        depth = args.pop("depth", 0)
        rec = {"name": ev.get("name", "?"),
               "t0": float(ev.get("ts", 0.0)) / 1e6,
               "dur": float(ev.get("dur", 0.0)) / 1e6,
               "tid": int(ev.get("tid", 0)),
               "pid": int(ev.get("pid", 0)),
               "depth": int(depth)}
        if args:
            rec["attrs"] = args
        records.append(rec)
    return records


def load_records(path: str) -> List[Dict]:
    """Sniff + load either format: ``.jsonl`` span logs or Chrome-trace
    JSON (a dict with ``traceEvents``)."""
    with open(path) as f:
        head = f.read(1)
    if path.endswith(".jsonl"):
        return read_jsonl(path)
    with open(path) as f:
        if head == "{":
            doc = json.load(f)
            if "traceEvents" in doc:
                return from_chrome_trace(doc)
            raise ValueError(f"{path}: JSON object without traceEvents — "
                             "not a trace export")
    return read_jsonl(path)
