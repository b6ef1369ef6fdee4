"""The canonical per-step phase taxonomy + the per-step aggregator — the
port's copy of ``pdnlp_tpu/obs/phases.py``, serving tables included
(per-replica phases, fill, retries and peak device memory), so a span file
of either package folds into the same table.

Every traced layer names its spans out of ONE vocabulary, so a trace from
the trainer, the input pipeline, and the checkpoint writer composes into a
single per-step breakdown — and ``trace_tpu.py diff`` can compare any two
runs phase by phase:

====================  =====================================================
phase                 host-side meaning
====================  =====================================================
``data_wait``         blocked obtaining the next batch (collation, the
                      prefetch queue, the resident gather dispatch)
``h2d_put``           blocked inside a host->device upload (``put``); the
                      resident pipeline's amortized uploads carry
                      ``in_loop=False``
``step_dispatch``     enqueueing the jitted train step (async: this is
                      dispatch latency, NOT compute)
``device_block``      ``block_until_ready`` on the step's output — where
                      device compute time actually surfaces on the host
``eval``              the in-loop dev pass
``ckpt_save``         the step loop's checkpoint pause — under the async
                      writer (``--ckpt_async``, default) this is the
                      device→host snapshot + enqueue ONLY (serialization
                      and disk ride the writer thread); under
                      ``--ckpt_async false`` it is the full synchronous
                      save.  ``trace_tpu.py diff --ckpt_save_budget``
                      gates its p95
``ckpt_wait``         end-of-run drain of the async checkpoint writer —
                      durability work off the step loop, counted in the
                      runtime but never in ``ckpt_save``'s in-loop p95
``log``               formatting + printing the loss line
====================  =====================================================

:class:`StepBreakdown` folds a span stream into per-step phase totals and
summarizes mean/p50/p95 per phase.  It is a tracer *listener* (feed it via
``tracer.add_listener(breakdown.feed)``): a ``device_block`` span closes
the current step — the traced loop emits exactly one per optimizer-step
group — so fused K-step dispatches aggregate correctly through the
record's ``n`` attribute.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence

PHASES = ("data_wait", "h2d_put", "step_dispatch", "device_block",
          "eval", "ckpt_save", "ckpt_wait", "log")

#: the phase that marks "this optimizer-step group is finished" in a span
#: stream (the traced loop's per-step barrier)
STEP_END_PHASE = "device_block"

#: span attrs tallied as adoption counters (any span name, incl. the serve
#: vocabulary): ``attn_impl`` = the routed attention kernel on a dispatch,
#: ``dtype`` = the serve forward precision (``"int8"`` under weight-
#: quantized serving)
_ADOPTION_ATTRS = ("attn_impl", "dtype")

#: the serve-side span vocabulary: ``queue_wait`` (batcher/router pre-batch
#: wait, ``retry`` attr counts re-dispatched requests), ``forward`` /
#: ``compile`` (engine execution, cache hit vs first-seen shape; packed
#: forwards additionally carry ``packed``/``fill``/``segments`` attrs —
#: token-level fill and riding-request count per batch), ``swap`` (a
#: rolling checkpoint hot-swap).  Generative decoding adds ``prefill``
#: (bucketed causal prompt forward + KV insert, ``streams``/``tokens``
#: attrs) and ``decode`` (ONE fixed-shape step over the slot block,
#: ``live`` attr = rows actually advancing).  Spans carrying a ``replica``
#: attr feed the PER-REPLICA phase tables — one sick replica must show up
#: as itself in ``trace_tpu.py summarize``, not as a pool-average smear.
SERVE_PHASES = ("queue_wait", "forward", "compile", "swap", "prefill",
                "decode")


def _bucket_key(bucket) -> tuple:
    """Numeric-aware sort for bucket labels: widths 16/32/64/128 order by
    VALUE (a plain string sort reads 128 < 16), non-numeric labels after."""
    try:
        return (0, int(bucket), "")
    except (TypeError, ValueError):
        return (1, 0, str(bucket))


def _percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Exact percentile over a sorted list (numpy-free: the CLI must run
    without the training stack)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    k = (len(sorted_vals) - 1) * (p / 100.0)
    lo = int(k)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = k - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


class StepBreakdown:
    """Per-step phase accumulator -> per-phase mean/p50/p95.

    ``feed(record)`` accepts tracer span records; per-STEP totals (a step
    may contain several spans of one phase) are closed by the
    ``device_block`` record and become one observation per phase.  Spans
    whose name is not a known phase are ignored — serve traces flow through
    the same tracer with their own vocabulary — and so are device spans
    (``device=True``: the card's time, not the host's).  Phase seconds are SELF
    time: a phase span nested inside another phase span (same thread,
    contained interval) has its duration subtracted from the enclosing
    one, so sync mode's in-``next`` upload counts as ``h2d_put``, not as
    ``h2d_put`` + ``data_wait`` twice.  ``feed`` is thread-safe — the
    prefetch worker's spans arrive on its own thread.

    ``on_step(step, phases, wall)`` fires as each step closes — the
    regression detector's input — with ``step`` the global step counter
    (from the ``device_block`` record's ``step`` attr when present, else a
    running count), ``phases`` the step's phase->seconds dict, and ``wall``
    the step's total traced seconds.
    """

    def __init__(self, on_step: Optional[Callable[[int, Dict[str, float],
                                                   float], None]] = None):
        self.on_step = on_step
        self.steps = 0            # optimizer steps (fused groups count n)
        self.groups = 0           # dispatch groups (= observations)
        self._current: Dict[str, float] = {}
        self._per_phase: Dict[str, List[float]] = {}
        # per-bucket (the closing record's ``bucket`` attr, e.g. the batch
        # token width under --length_mode bucket) phase totals: the
        # end-of-train table breaks the step phases down per bucket
        self._per_bucket: Dict[object, Dict] = {}
        self._count = 0
        # feed() runs on whichever thread RECORDED the span (tracer
        # listeners fire in-line) — the prefetch worker's h2d_put races the
        # main thread's step spans without this
        self._lock = threading.Lock()
        self._children: Dict[int, List] = {}  # tid -> [(t0, t1, dur, depth)]
        # kernel/precision adoption counters: spans carrying an
        # ``attn_impl`` (train dispatch) or ``dtype`` (serve forward) attr
        # are tallied by value, so ``summarize``/the end-of-train table
        # show WHICH impl the hot path actually ran, not just how long
        self._impls: Dict[str, Dict[str, int]] = {}
        # per-replica serve-phase durations (SERVE_PHASES spans with a
        # ``replica`` attr) + retry counts from queue_wait records
        self._serve: Dict[object, Dict[str, List[float]]] = {}
        self._serve_retries: Dict[object, int] = {}
        # per-replica token-level fill of executed forwards (the ``fill``
        # attr engine spans carry) + how many of them were packed batches
        self._serve_fill: Dict[object, List[float]] = {}
        self._serve_packed: Dict[object, int] = {}
        # device-memory accounting: "hbm" records (obs.memory samplers) and
        # per-forward ``hbm_peak`` span attrs feed the memory columns — the
        # peak is the HBM-budget number, last is the live occupancy
        self._hbm_peak = 0
        self._hbm_last = 0
        self._serve_hbm: Dict[object, int] = {}   # replica -> peak bytes
        # per-rank sub-summaries of a merged multi-process trace
        # (from_records splits by pid so rank A's device_block can never
        # close a step holding rank B's phases)
        self._by_rank: Dict[int, Dict] = {}

    # ------------------------------------------------------------- feeding
    def feed(self, record: Dict) -> None:
        if record.get("device"):        # the card's own time: not a phase
            return
        name = record.get("name")
        attrs = record.get("attrs") or {}
        if name == "hbm":  # memory sample (obs.memory.MemorySampler)
            with self._lock:
                self._hbm_last = int(attrs.get("bytes_in_use", 0))
                self._hbm_peak = max(self._hbm_peak,
                                     int(attrs.get("peak_bytes", 0)))
            return
        for key in _ADOPTION_ATTRS:
            v = attrs.get(key)
            if v is not None:
                with self._lock:
                    by = self._impls.setdefault(key, {})
                    by[str(v)] = by.get(str(v), 0) + 1
        if name in SERVE_PHASES and "replica" in attrs:
            with self._lock:
                per = self._serve.setdefault(attrs["replica"], {})
                per.setdefault(name, []).append(
                    float(record.get("dur", 0.0)))
                retry = attrs.get("retry")
                if retry:
                    self._serve_retries[attrs["replica"]] = \
                        self._serve_retries.get(attrs["replica"], 0) \
                        + int(retry)
                # fill aggregates FORWARD spans only: every compile span
                # is a warmup dummy ([[CLS],[SEP]] at ~0.002 fill) and
                # would drag a healthy replica's reported fill far below
                # its steady state (the router snapshot's fill_ratio
                # already excludes warmups — the two surfaces must agree)
                if name == "forward" and attrs.get("fill") is not None:
                    self._serve_fill.setdefault(
                        attrs["replica"], []).append(float(attrs["fill"]))
                    if attrs.get("packed"):
                        self._serve_packed[attrs["replica"]] = \
                            self._serve_packed.get(attrs["replica"], 0) + 1
                if attrs.get("hbm_peak") is not None:
                    # peak HBM per replica: the engine samples its mesh
                    # slice's allocator before each executed batch
                    self._serve_hbm[attrs["replica"]] = max(
                        self._serve_hbm.get(attrs["replica"], 0),
                        int(attrs["hbm_peak"]))
        if name not in PHASES:
            return
        full = float(record.get("dur", 0.0))
        dur = full
        depth = int(record.get("depth", 0))
        tid = record.get("tid", 0)
        t0 = float(record.get("t0", 0.0))
        t1 = t0 + full
        with self._lock:
            # SELF time, not inclusive time: a phase span can lexically
            # contain another phase span on its thread (sync mode's
            # h2d_put runs inside the data_wait span around ``next``), and
            # spans complete child-first — so subtract already-fed DEEPER
            # spans this one contains, and each second lands in exactly
            # one phase instead of being double-counted.
            pending = self._children.get(tid)
            if pending:
                kept = []
                for c in pending:
                    if c[3] > depth and c[0] >= t0 and c[1] <= t1:
                        dur -= c[2]
                    else:
                        kept.append(c)
                self._children[tid] = kept
            if depth > 0:  # only nested spans can be someone's child
                # the FULL duration: a grandparent subtracts the whole
                # consumed subtree exactly once
                self._children.setdefault(tid, []).append(
                    (t0, t1, full, depth))
                del self._children[tid][:-64]  # bound orphaned children
            self._current[name] = self._current.get(name, 0.0) \
                + max(0.0, dur)
            if name == STEP_END_PHASE:
                attrs = record.get("attrs") or {}
                self._close_step(attrs.get("step"), int(attrs.get("n", 1)),
                                 bucket=attrs.get("bucket"))

    def record(self, phase: str, seconds: float) -> None:
        """Direct accumulation into the open step (tests / non-span use)."""
        with self._lock:
            self._current[phase] = self._current.get(phase, 0.0) \
                + float(seconds)

    def end_step(self, step: Optional[int] = None, n: int = 1) -> None:
        """Close the open step explicitly (loops without a block span)."""
        with self._lock:
            self._close_step(step, n)

    def _close_step(self, step: Optional[int], n: int,
                    bucket=None) -> None:
        # caller holds self._lock
        phases = self._current
        self._current = {}
        if n > 0:  # n=0 marks a trailing partial flush, not a real step
            self.groups += 1
            self.steps += int(n)
        self._count = int(step) if step is not None else self._count + n
        for phase, sec in phases.items():
            self._per_phase.setdefault(phase, []).append(sec)
        if bucket is not None and n > 0:
            b = self._per_bucket.setdefault(
                bucket, {"steps": 0, "groups": 0, "phases": {}})
            b["steps"] += int(n)
            b["groups"] += 1
            for phase, sec in phases.items():
                b["phases"][phase] = b["phases"].get(phase, 0.0) + sec
        if self.on_step is not None:
            self.on_step(self._count, phases, sum(phases.values()))

    def close(self) -> None:
        """Flush a trailing partial step (spans after the last barrier)."""
        with self._lock:
            if self._current:
                self._close_step(None, 0)

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict:
        """JSON-ready per-phase stats: seconds mean/p50/p95/total/count,
        plus share of the traced wall time.  Takes the feed lock: the
        live exporter snapshots a RUNNING breakdown from its own thread,
        and iterating ``_per_phase`` while a first-seen phase key lands
        would raise mid-scrape."""
        with self._lock:
            return self._summary_locked()

    def _summary_locked(self) -> Dict:
        phases = {}
        grand = sum(sum(v) for v in self._per_phase.values()) or 1.0
        for phase, vals in sorted(self._per_phase.items(),
                                  key=lambda kv: -sum(kv[1])):
            s = sorted(vals)
            total = sum(vals)
            phases[phase] = {
                "count": len(vals),
                "total_sec": round(total, 6),
                "mean_sec": round(total / len(vals), 9),
                "p50_sec": round(_percentile(s, 50), 9),
                "p95_sec": round(_percentile(s, 95), 9),
                "share": round(total / grand, 4),
            }
        out = {"steps": self.steps, "groups": self.groups, "phases": phases}
        if self._impls:
            out["impls"] = {k: dict(sorted(v.items(), key=lambda kv: -kv[1]))
                            for k, v in sorted(self._impls.items())}
        if self._serve:
            out["serve_by_replica"] = {
                str(rep): {
                    "retries": self._serve_retries.get(rep, 0),
                    # token-level fill of this replica's executed forwards
                    # (None when its spans predate the fill attr)
                    "fill_mean": (round(sum(self._serve_fill[rep])
                                        / len(self._serve_fill[rep]), 4)
                                  if self._serve_fill.get(rep) else None),
                    "packed_batches": self._serve_packed.get(rep, 0),
                    # peak HBM of this replica's device slice (None on
                    # backends without memory_stats, e.g. CPU)
                    "hbm_peak_gb": (round(
                        self._serve_hbm[rep] / 2**30, 3)
                        if rep in self._serve_hbm else None),
                    "phases": {
                        phase: {
                            "count": len(vals),
                            "total_sec": round(sum(vals), 6),
                            "mean_sec": round(sum(vals) / len(vals), 9),
                            "p95_sec": round(
                                _percentile(sorted(vals), 95), 9),
                        }
                        for phase, vals in sorted(
                            per.items(), key=lambda kv: -sum(kv[1]))
                    },
                }
                for rep, per in sorted(self._serve.items(),
                                       key=lambda kv: _bucket_key(kv[0]))
            }
        if self._per_bucket:
            out["by_bucket"] = {
                str(bucket): {
                    "steps": b["steps"],
                    "groups": b["groups"],
                    "phases": {
                        phase: {
                            "total_sec": round(sec, 6),
                            "mean_sec": round(sec / b["groups"], 9),
                        }
                        for phase, sec in sorted(b["phases"].items(),
                                                 key=lambda kv: -kv[1])
                    },
                }
                for bucket, b in sorted(self._per_bucket.items(),
                                        key=lambda kv: _bucket_key(kv[0]))
            }
        if self._hbm_peak:
            out["memory"] = {
                "peak_bytes": self._hbm_peak,
                "bytes_in_use": self._hbm_last,
                "gb_peak": round(self._hbm_peak / 2**30, 3),
            }
        if self._by_rank:
            out["by_rank"] = {str(rank): s for rank, s
                              in sorted(self._by_rank.items())}
        return out

    @staticmethod
    def from_records(records: Sequence[Dict]) -> "StepBreakdown":
        """Rebuild a breakdown from an exported span stream (the CLI's
        ``summarize``/``diff`` path).

        A MERGED multi-rank trace (``trace_tpu.py merge``) interleaves
        processes; folding it through one accumulator would let rank A's
        ``device_block`` close a step holding rank B's phases.  Records
        are therefore split by ``pid`` and folded per rank; the returned
        breakdown aggregates the per-rank observations (every step of
        every rank is one observation) and keeps each rank's own summary
        under ``summary()["by_rank"]``."""
        by_pid: Dict[int, List[Dict]] = {}
        for rec in records:
            by_pid.setdefault(int(rec.get("pid", 0)), []).append(rec)
        if len(by_pid) <= 1:
            bd = StepBreakdown()
            for rec in records:
                bd.feed(rec)
            bd.close()
            return bd
        merged = StepBreakdown()
        for pid in sorted(by_pid):
            merged._absorb(StepBreakdown.from_records(by_pid[pid]), pid)
        return merged

    def _absorb(self, other: "StepBreakdown", rank: int) -> None:
        """Fold one rank's closed breakdown into this multi-rank one."""
        with self._lock:
            self.steps += other.steps
            self.groups += other.groups
            self._count += other._count
            for phase, vals in other._per_phase.items():
                self._per_phase.setdefault(phase, []).extend(vals)
            for key, by in other._impls.items():
                mine = self._impls.setdefault(key, {})
                for val, n in by.items():
                    mine[val] = mine.get(val, 0) + n
            for rep, per in other._serve.items():
                mine = self._serve.setdefault(rep, {})
                for phase, vals in per.items():
                    mine.setdefault(phase, []).extend(vals)
            for rep, n in other._serve_retries.items():
                self._serve_retries[rep] = \
                    self._serve_retries.get(rep, 0) + n
            for rep, vals in other._serve_fill.items():
                self._serve_fill.setdefault(rep, []).extend(vals)
            for rep, n in other._serve_packed.items():
                self._serve_packed[rep] = \
                    self._serve_packed.get(rep, 0) + n
            for rep, peak in other._serve_hbm.items():
                self._serve_hbm[rep] = max(
                    self._serve_hbm.get(rep, 0), peak)
            for bucket, b in other._per_bucket.items():
                mine = self._per_bucket.setdefault(
                    bucket, {"steps": 0, "groups": 0, "phases": {}})
                mine["steps"] += b["steps"]
                mine["groups"] += b["groups"]
                for phase, sec in b["phases"].items():
                    mine["phases"][phase] = \
                        mine["phases"].get(phase, 0.0) + sec
            self._hbm_peak = max(self._hbm_peak, other._hbm_peak)
            self._hbm_last = max(self._hbm_last, other._hbm_last)
            self._by_rank[rank] = other.summary()


def format_table(summary: Dict) -> str:
    """The phase table: one aligned text block (``trace_tpu.py summarize``
    and the end-of-train print share it)."""
    header = (f"{'phase':<14} {'count':>7} {'total_s':>10} {'mean_ms':>10} "
              f"{'p50_ms':>10} {'p95_ms':>10} {'share':>7}")
    lines = [header, "-" * len(header)]
    for phase, s in summary.get("phases", {}).items():
        lines.append(
            f"{phase:<14} {s['count']:>7d} {s['total_sec']:>10.3f} "
            f"{s['mean_sec'] * 1e3:>10.3f} {s['p50_sec'] * 1e3:>10.3f} "
            f"{s['p95_sec'] * 1e3:>10.3f} {s['share']:>6.1%}")
    lines.append(f"steps: {summary.get('steps', 0)}  "
                 f"dispatch groups: {summary.get('groups', 0)}")
    # memory line (obs.memory samples): the HBM-budget number next to the
    # time budget — absent on backends without memory_stats (CPU)
    mem = summary.get("memory")
    if mem:
        lines.append(f"peak HBM {mem['gb_peak']:.3f} GB "
                     f"(in use {mem['bytes_in_use'] / 2**30:.3f} GB)")
    # adoption line (kernel/precision): which impl the hot path actually
    # ran — `attn_impl: pallas x384` is the pallas-is-default receipt
    for key, by in summary.get("impls", {}).items():
        lines.append(f"{key}: " + "  ".join(
            f"{val} x{n}" for val, n in by.items()))
    # per-replica serve tables (router runs): one block per replica so a
    # slow or retry-heavy replica reads as ITSELF, not a pool average
    for rep, b in summary.get("serve_by_replica", {}).items():
        line = f"replica {rep}: {b['retries']} retried request(s)"
        if b.get("fill_mean") is not None:
            line += (f"  fill {b['fill_mean']:.2f}"
                     f" ({b.get('packed_batches', 0)} packed batch(es))")
        if b.get("hbm_peak_gb") is not None:
            line += f"  peak HBM {b['hbm_peak_gb']:.3f} GB"
        lines.append(line)
        for phase, s in b["phases"].items():
            lines.append(
                f"  {phase:<12} {s['count']:>6d}x {s['total_sec']:>10.3f}s "
                f"total {s['mean_sec'] * 1e3:>10.3f} ms mean "
                f"{s['p95_sec'] * 1e3:>10.3f} ms p95")
    # per-rank lines (merged multi-rank traces): each rank's step count,
    # wall share, and peak HBM — a stalled or memory-pressured rank reads
    # as ITSELF, not as a gang-average smear
    for rank, s in summary.get("by_rank", {}).items():
        total = sum(p["total_sec"] for p in s.get("phases", {}).values())
        line = (f"rank {rank}: {s.get('steps', 0)} steps / "
                f"{s.get('groups', 0)} groups  {total:.3f}s traced")
        rmem = s.get("memory")
        if rmem:
            line += f"  peak HBM {rmem['gb_peak']:.3f} GB"
        lines.append(line)
    # per-bucket breakdown (length-aware runs): one line per bucket x
    # phase so a bucketed run's table shows where each width's time goes
    for bucket, b in summary.get("by_bucket", {}).items():
        lines.append(f"bucket {bucket}: {b['steps']} steps / "
                     f"{b['groups']} groups")
        for phase, s in b["phases"].items():
            lines.append(
                f"  {phase:<12} {s['total_sec']:>10.3f}s total "
                f"{s['mean_sec'] * 1e3:>10.3f} ms/group")
    return "\n".join(lines)
