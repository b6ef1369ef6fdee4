"""Cross-rank trace merge: N per-process span files -> one aligned
timeline (the twin of ``pdnlp_tpu/obs/merge.py``, same offsets and
record schema).

Each rank's :class:`~pdnlp_tpu_torch.obs.trace.Tracer` stamps spans on its
OWN ``perf_counter`` — a monotonic clock with an arbitrary per-process zero.
Merging ``trace_proc<i>.jsonl`` files therefore needs a per-rank offset
into a shared time base before a multi-host stall or an elastic-width
resume is attributable per rank.

Two offset sources, tried in order per file:

1. the ``_clock_sync`` meta record :meth:`Tracer.flush` appends — a pair
   of (tracer ``perf_counter``, wall ``time.time()``) read back-to-back at
   flush time, giving ``offset = wall - mono`` directly;
2. the rank's heartbeat beat payload (``parallel.watchdog.Heartbeat``
   writes ``t`` = wall clock and ``mono`` = ``perf_counter`` in one beat)
   — the path for traces flushed by older code, or killed processes whose
   last flush predates the crash while beats kept landing.

Both estimates share the same structure — one (mono, wall) observation per
rank — so alignment error is bounded by the read-to-read skew of a single
beat/flush (microseconds), far under the millisecond-scale phases the
merged timeline is read for.  A file with NO offset source merges at
offset 0 with a loud ``aligned=False`` in the report.

The merged records are re-based to the FIRST file's clock domain (small
numbers survive the float64 microsecond math in Chrome-trace export), get
``pid`` = rank, and sort by aligned start time.  ``python -m
pdnlp_tpu_torch.tools.trace merge`` fronts this; ``summarize``/``diff``
accept the merged output because :meth:`StepBreakdown.from_records` folds
multi-pid streams per rank.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

#: the flush-time meta record carrying (tracer clock, wall clock)
CLOCK_SYNC = "_clock_sync"

_PROC_RE = re.compile(r"trace_proc(\d+)\.")


def rank_of_path(path: str) -> Optional[int]:
    m = _PROC_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def _offset_from_records(records: Sequence[Dict]) -> Optional[float]:
    """``wall - mono`` from the newest ``_clock_sync`` record."""
    best = None
    for rec in records:
        if rec.get("name") != CLOCK_SYNC:
            continue
        wall = (rec.get("attrs") or {}).get("wall")
        if wall is None:
            continue
        cand = float(wall) - float(rec.get("t0", 0.0))
        best = cand  # records are in ring order: keep the newest
    return best


def _offset_from_heartbeat(hb_dir: str, rank: int) -> Optional[float]:
    """``wall - mono`` from the rank's beat payload (needs the ``mono``
    field the watchdog's beats carry)."""
    import json

    from pdnlp_tpu_torch.parallel.watchdog import heartbeat_file

    try:
        with open(heartbeat_file(hb_dir, rank)) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict) or "mono" not in payload \
            or "t" not in payload:
        return None
    return float(payload["t"]) - float(payload["mono"])


def merge_traces(paths: Sequence[str], hb_dir: Optional[str] = None
                 ) -> Tuple[List[Dict], Dict]:
    """Load + align + interleave per-process traces.

    Returns ``(records, report)``: records carry ``pid`` = rank and
    aligned ``t0`` in the first file's clock domain, sorted by start time;
    the report lists per-rank offsets and whether every file aligned."""
    from pdnlp_tpu_torch.obs.export import load_records

    per_file = []
    for i, path in enumerate(paths):
        records = load_records(path)
        rank = rank_of_path(path)
        if rank is None:
            pids = {int(r.get("pid", i)) for r in records}
            rank = pids.pop() if len(pids) == 1 else i
        offset = _offset_from_records(records)
        source = "clock_sync" if offset is not None else None
        if offset is None and hb_dir:
            offset = _offset_from_heartbeat(hb_dir, rank)
            source = "heartbeat" if offset is not None else None
        per_file.append((path, rank, offset, source, records))

    base = next((off for _, _, off, _, _ in per_file if off is not None),
                None)
    merged: List[Dict] = []
    report: Dict = {"files": [], "aligned": True}
    for path, rank, offset, source, records in per_file:
        if offset is None or base is None:
            shift = 0.0
            if len(per_file) > 1:
                report["aligned"] = False
        else:
            shift = offset - base
        report["files"].append({
            "path": path, "rank": rank,
            "offset_s": round(offset - base, 6)
            if (offset is not None and base is not None) else None,
            "clock_source": source,
        })
        for rec in records:
            if rec.get("name") == CLOCK_SYNC:
                continue  # meta record: consumed here, not a span
            rec = dict(rec)
            rec["pid"] = rank
            rec["t0"] = float(rec.get("t0", 0.0)) + shift
            merged.append(rec)
    merged.sort(key=lambda r: r["t0"])
    report["records"] = len(merged)
    report["ranks"] = sorted({f["rank"] for f in report["files"]})
    return merged, report
