"""torchlint CLI — file discovery, rule running, baseline ratchet, exit code.

``python -m pdnlp_tpu_torch.analysis`` lands here.  Exit codes: 0 = clean
vs baseline, 1 = new violations (or any violations with ``--no-baseline``),
2 = usage/parse errors.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from pdnlp_tpu_torch.analysis import baseline as baseline_mod
from pdnlp_tpu_torch.analysis.core import (
    Finding, ProgramInfo, ProgramRule, all_rules, parse_module,
    run_program_rules, run_rules, select_rules,
)
from pdnlp_tpu_torch.analysis.reporters import (
    render_json, render_rule_table, render_sarif, render_summary,
    render_text,
)

#: dirs never descended into when a directory path is scanned
_SKIP_DIRS = {"__pycache__", ".git", "output", "results", "node_modules",
              "tests", "csrc", "build", ".claude"}


def default_paths(root: str = ".") -> List[str]:
    """The port's hazard surface: the package (its entry points are its
    modules) and the card's smoke script."""
    names = ["pdnlp_tpu_torch", "chip_smoke.py"]
    return [os.path.join(root, n) for n in names
            if os.path.exists(os.path.join(root, n))]


def collect_files(paths: List[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d not in _SKIP_DIRS
                                     and not d.startswith("."))
                files += [os.path.join(dirpath, f)
                          for f in sorted(filenames) if f.endswith(".py")]
        elif p.endswith(".py") and os.path.exists(p):
            files.append(p)
        elif not os.path.exists(p):
            raise FileNotFoundError(p)
    seen, out = set(), []
    for f in files:
        key = os.path.abspath(f)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def display_path(path: str, root: str) -> str:
    rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    return rel.replace(os.sep, "/")


def analyze_paths(paths: List[str], root: str = ".",
                  rule_ids: Optional[List[str]] = None,
                  suite: str = "all") -> List[Finding]:
    """Library entrypoint (the pytest ratchet calls this): all findings
    over ``paths``, display paths relative to ``root``.  Per-file tracing
    rules run module by module; the concurrency suite runs once over the
    whole-program :class:`ProgramInfo` built from the same file set."""
    findings: List[Finding] = []
    modules = []
    for path in collect_files(paths):
        mod = parse_module(path, display_path(path, root))
        if mod is None:
            print(f"torchlint: syntax error in {path}, skipped",
                  file=sys.stderr)
            continue
        modules.append(mod)
        findings += run_rules(mod, rule_ids, suite=suite)
    wants_program = any(isinstance(r, ProgramRule)
                        for r in select_rules(rule_ids, suite).values())
    if modules and wants_program:
        findings += run_program_rules(ProgramInfo(modules), rule_ids,
                                      suite=suite)
    return sorted(findings, key=Finding.sort_key)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pdnlp_tpu_torch.analysis",
        description="torchlint: AST-based hazard analyzer of the PyTorch "
                    "port (CUDA graph capture, generators, timing, "
                    "threads, resources; baseline-ratcheted)")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to scan (default: the repo's standard "
                        "hazard surface)")
    p.add_argument("--suite",
                   choices=("tracing", "concurrency", "lifecycle", "all"),
                   default="all",
                   help="rule suite: the per-file tracing rules (R*), the "
                        "whole-program concurrency analyses (T*), the "
                        "resource-lifecycle analyses (L*), or all "
                        "(default: %(default)s)")
    p.add_argument("--format", choices=("text", "json", "sarif"),
                   default=None,
                   help="report format (default: text; sarif emits SARIF "
                        "2.1.0 for CI/editor ingestion)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable JSON report on stdout "
                        "(alias for --format json)")
    p.add_argument("--fix-hints", action="store_true",
                   help="print the suggested rewrite under each finding")
    p.add_argument("--baseline", default=baseline_mod.DEFAULT_BASELINE,
                   help="baseline file for the ratchet (default: %(default)s)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: ANY finding fails")
    p.add_argument("--write-baseline", action="store_true",
                   help="record current findings as the new baseline and "
                        "exit 0")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        print(render_rule_table())
        return 0

    rule_ids = None
    if args.rules:
        rule_ids = [r.strip().upper() for r in args.rules.split(",")
                    if r.strip()]
        unknown = set(rule_ids) - set(all_rules())
        if unknown:
            print(f"torchlint: unknown rule id(s): {', '.join(sorted(unknown))}"
                  f" (known: {', '.join(all_rules())})", file=sys.stderr)
            return 2

    fmt = args.format or ("json" if args.json else "text")
    paths = args.paths or default_paths()
    try:
        findings = analyze_paths(paths, root=".", rule_ids=rule_ids,
                                 suite=args.suite)
    except FileNotFoundError as e:
        print(f"torchlint: no such path: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        if args.suite != "all" or rule_ids:
            # a partial scan must never become THE baseline: it would
            # silently drop every other suite's grandfathered findings
            # and the next full run would re-blame them all as new
            print("torchlint: refusing --write-baseline with --suite/"
                  "--rules filters — the baseline records the FULL "
                  "surface (run without filters)", file=sys.stderr)
            return 2
        baseline_mod.write(findings, args.baseline)
        print(f"torchlint: wrote {len(findings)} finding(s) to {args.baseline}")
        return 0

    baseline_used = False
    new, fixed = list(findings), 0
    if not args.no_baseline and os.path.exists(args.baseline):
        baseline_used = True
        # compare within the scanned scope only: under --suite/--rules a
        # baseline entry for an unscanned rule is out of scope, not fixed
        in_scope = set(select_rules(rule_ids, args.suite))
        entries = [e for e in baseline_mod.load(args.baseline)
                   if e["rule"] in in_scope]
        new, fixed = baseline_mod.compare(findings, entries)

    if fmt == "json":
        print(render_json(findings, new, fixed, baseline_used))
    elif fmt == "sarif":
        print(render_sarif(findings, new, baseline_used))
    else:
        shown = findings if (args.no_baseline or not baseline_used) else new
        if shown:
            print(render_text(shown, new=new, fix_hints=args.fix_hints))
        print(render_summary(findings, new, fixed, baseline_used),
              file=sys.stderr)
        if not baseline_used and not args.no_baseline and findings:
            print(f"torchlint: no baseline at {args.baseline} — every finding "
                  "counts as new (record current state with "
                  "--write-baseline)", file=sys.stderr)

    return 1 if new else 0
