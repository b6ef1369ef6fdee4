"""Inspect, diff, merge and convert the port's ``pdnlp_tpu_torch.obs``
traces — the twin of ``trace_tpu.py``, same subcommands, exit codes and
output over the same records.

Subcommands:

- ``summarize <trace>`` — the per-phase table (count / total / mean / p50
  / p95 / share) of one trace file; a merged multi-rank trace additionally
  prints per-rank lines (steps, traced wall, peak device memory);
- ``diff <base> <candidate>`` — per-phase mean deltas between two traces;
  exits **1** when any phase's mean grew beyond ``--threshold`` (default
  0.20 = 20%);
- ``merge <trace_proc0.jsonl> <trace_proc1.jsonl> ... -o merged.json`` —
  align per-process monotonic clocks (flush-time ``_clock_sync`` records,
  falling back to heartbeat beat payloads via ``--hb_dir``) and emit ONE
  Perfetto timeline with ``pid`` = rank; ``--jsonl`` keeps the span-log
  format instead (feedable back into ``summarize``/``diff``/``request``);
- ``request <id> <trace...>`` — the hop chain of one served request:
  admission tier, queue, pack placement, dispatch, hedge/requeue,
  shadow/degrade/rollback, completion — with per-hop gap durations; exits
  1 when the chain is missing or incomplete;
- ``decisions <trace...>`` — the serving controller's decision-record
  chains (``pdnlp_tpu_torch.obs.decision``): per actuation, the cause
  metrics, the knob's old -> new value, and the evaluation-window outcome
  (kept / auto-reverted, with the signal delta); exits 1 on a malformed
  chain (an action without an outcome);
- ``export <trace> -o out.json`` — convert a JSONL span log to
  Chrome-trace JSON (load it at https://ui.perfetto.dev).

Accepted inputs everywhere: the per-process ``trace_proc<i>.jsonl`` files
``Tracer.flush`` writes, or an already-exported Chrome-trace ``.json``.
Pure stdlib — it needs no card and does not import torch.

    python -m pdnlp_tpu_torch.tools.trace summarize out/trace/trace_proc0.jsonl
    python -m pdnlp_tpu_torch.tools.trace diff main.jsonl pr.jsonl
    python -m pdnlp_tpu_torch.tools.trace merge out/trace/trace_proc*.jsonl \\
        -o merged.json
    python -m pdnlp_tpu_torch.tools.trace request r12345-7 trace_proc0.jsonl
    python -m pdnlp_tpu_torch.tools.trace decisions trace_proc0.jsonl
"""
from __future__ import annotations

import argparse
import json
import sys

from pdnlp_tpu_torch.obs.decision import format_decisions, validate_decisions
from pdnlp_tpu_torch.obs.export import (
    load_records, write_chrome_trace, write_jsonl,
)
from pdnlp_tpu_torch.obs.merge import merge_traces
from pdnlp_tpu_torch.obs.phases import StepBreakdown, format_table
from pdnlp_tpu_torch.obs.regress import diff_breakdowns
from pdnlp_tpu_torch.obs.request import chain_issues, format_chain, hop_chain


def _summary(path: str):
    return StepBreakdown.from_records(load_records(path)).summary()


def _load_many(paths, hb_dir=None):
    """One or many trace files -> one record stream (clock-aligned when
    several files merge; a file with no clock source gets the same loud
    warning ``merge`` prints — its spans sort on an incomparable clock)."""
    if len(paths) == 1:
        return load_records(paths[0])
    records, report = merge_traces(paths, hb_dir=hb_dir)
    if not report["aligned"]:
        print("WARNING: some files had no _clock_sync record or "
              "heartbeat (--hb_dir) — cross-file ordering is unreliable",
              file=sys.stderr)
    return records


def cmd_summarize(ns) -> int:
    summary = _summary(ns.trace)
    if ns.json:
        print(json.dumps(summary, indent=2))
    else:
        print(format_table(summary))
    return 0


def cmd_diff(ns) -> int:
    base, cand = _summary(ns.base), _summary(ns.candidate)
    diff = diff_breakdowns(base, cand, threshold=ns.threshold,
                           min_mean_sec=ns.min_mean_sec,
                           min_count=ns.min_count,
                           ckpt_save_budget=ns.ckpt_save_budget)
    if ns.json:
        print(json.dumps(diff, indent=2))
    else:
        header = (f"{'phase':<14} {'base_ms':>10} {'cand_ms':>10} "
                  f"{'delta':>8}")
        print(header)
        print("-" * len(header))
        for name, row in diff["phases"].items():
            am, bm, d = (row["base_mean_sec"], row["cand_mean_sec"],
                         row["delta_ratio"])
            mark = "  << REGRESSED" if row["regressed"] else ""
            print(f"{name:<14} "
                  f"{am * 1e3 if am else float('nan'):>10.3f} "
                  f"{bm * 1e3 if bm else float('nan'):>10.3f} "
                  f"{f'{d:+.1%}' if d is not None else 'n/a':>8}{mark}")
        budget = diff.get("ckpt_save_budget")
        if budget is not None:
            p95 = budget["cand_p95_sec"]
            shown = (f"{p95 * 1e3:.3f}ms" if p95 is not None
                     else "n/a (no saves in trace)")
            print(f"ckpt_save p95 {shown} vs budget "
                  f"{budget['budget_sec'] * 1e3:.3f}ms"
                  + ("  << OVER BUDGET" if budget["exceeded"] else ""))
        impls = diff.get("impls")
        if impls and impls["changed"]:
            # a phase delta alongside this line is attributable: the two
            # runs did not execute the same kernels/precision
            print(f"impl mix changed: base={impls['base']} "
                  f"cand={impls['cand']}")
    if diff["regressions"]:
        print(f"REGRESSION: phase(s) {', '.join(diff['regressions'])} mean "
              f"grew >= {ns.threshold:.0%} vs {ns.base}", file=sys.stderr)
        return 1
    return 0


def cmd_merge(ns) -> int:
    records, report = merge_traces(ns.traces, hb_dir=ns.hb_dir)
    out = ns.output or "merged.trace.json"
    if ns.jsonl:
        write_jsonl(records, out)
    else:
        write_chrome_trace(records, out)
    for f in report["files"]:
        off = (f"offset {f['offset_s']:+.6f}s via {f['clock_source']}"
               if f["offset_s"] is not None else "UNALIGNED (no clock "
               "source — offset 0 assumed)")
        print(f"rank {f['rank']}: {f['path']}  {off}")
    print(f"wrote {out} — {report['records']} spans over ranks "
          f"{report['ranks']}"
          + ("" if ns.jsonl else " (pid = rank; load it at "
             "https://ui.perfetto.dev)"))
    if not report["aligned"]:
        print("WARNING: some files had no _clock_sync record or heartbeat "
              "(--hb_dir) — their spans merged unaligned", file=sys.stderr)
    return 0


def cmd_request(ns) -> int:
    records = _load_many(ns.traces, hb_dir=ns.hb_dir)
    chain = hop_chain(records, ns.id)
    if ns.json:
        print(json.dumps({"request_id": ns.id, "hops": chain,
                          "issues": chain_issues(chain)}, indent=2))
    else:
        print(format_chain(chain, ns.id))
    return 0 if chain and not chain_issues(chain) else 1


def cmd_decisions(ns) -> int:
    records = _load_many(ns.traces, hb_dir=ns.hb_dir)
    report = validate_decisions(records)
    if ns.json:
        print(json.dumps(report, indent=2))
    else:
        print(format_decisions(records))
    return 0 if not report["incomplete"] else 1


def cmd_export(ns) -> int:
    out = ns.output or (ns.trace.rsplit(".", 1)[0] + ".chrome.json")
    write_chrome_trace(load_records(ns.trace), out)
    print(f"wrote {out} — load it at https://ui.perfetto.dev "
          "or chrome://tracing")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pdnlp_tpu_torch.tools.trace",
        description="summarize / diff / export pdnlp_tpu_torch.obs traces")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize", help="per-phase table of one trace")
    s.add_argument("trace")
    s.add_argument("--json", action="store_true")
    s.set_defaults(fn=cmd_summarize)

    d = sub.add_parser("diff", help="per-phase delta; exit 1 on regression")
    d.add_argument("base")
    d.add_argument("candidate")
    d.add_argument("--threshold", type=float, default=0.2,
                   help="flag a phase whose mean grew >= this fraction "
                        "(default 0.2)")
    d.add_argument("--min_mean_sec", type=float, default=1e-6,
                   help="phases under this base mean are never flagged "
                        "(noise floor)")
    d.add_argument("--min_count", type=int, default=5,
                   help="phases with fewer observations than this in "
                        "either trace are never flagged (1-2 samples of "
                        "an amortized upload are noise, not a trend)")
    d.add_argument("--ckpt_save_budget", type=float, default=None,
                   help="absolute bound (seconds) on the CANDIDATE trace's "
                        "in-loop ckpt_save p95 — under the async "
                        "checkpointer the phase measures device->host "
                        "snapshot + enqueue only, so a p95 over budget "
                        "means serialization/disk crept back onto the "
                        "step loop; exit 1 when exceeded")
    d.add_argument("--json", action="store_true")
    d.set_defaults(fn=cmd_diff)

    m = sub.add_parser("merge", help="align + merge per-process traces "
                                     "into one Perfetto timeline "
                                     "(pid = rank)")
    m.add_argument("traces", nargs="+",
                   help="trace_proc<i>.jsonl files (rank from filename)")
    m.add_argument("-o", "--output", default=None,
                   help="output path (default merged.trace.json)")
    m.add_argument("--hb_dir", default=None,
                   help="heartbeat dir (watchdog beats carry the wall/"
                        "mono clock pair) — the alignment fallback when a "
                        "trace has no _clock_sync record")
    m.add_argument("--jsonl", action="store_true",
                   help="emit a span-log JSONL instead of Chrome-trace "
                        "JSON (summarize/diff/request consume it)")
    m.set_defaults(fn=cmd_merge)

    r = sub.add_parser("request", help="one request's hop chain with "
                                       "per-hop durations")
    r.add_argument("id", help="the request id (r<pid>-<n>)")
    r.add_argument("traces", nargs="+",
                   help="trace file(s); several are clock-aligned first")
    r.add_argument("--hb_dir", default=None)
    r.add_argument("--json", action="store_true")
    r.set_defaults(fn=cmd_request)

    c = sub.add_parser("decisions", help="control-plane decision chains "
                                         "(cause -> action -> outcome); "
                                         "exit 1 on a malformed chain")
    c.add_argument("traces", nargs="+",
                   help="trace file(s); several are clock-aligned first")
    c.add_argument("--hb_dir", default=None)
    c.add_argument("--json", action="store_true")
    c.set_defaults(fn=cmd_decisions)

    e = sub.add_parser("export", help="JSONL span log -> Chrome-trace JSON")
    e.add_argument("trace")
    e.add_argument("-o", "--output", default=None)
    e.set_defaults(fn=cmd_export)
    return p


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    sys.exit(main())
