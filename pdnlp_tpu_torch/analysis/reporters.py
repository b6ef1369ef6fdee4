"""torchlint output — text (human, grep-able), JSON (machine) and SARIF
reporters."""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from pdnlp_tpu_torch.analysis.core import Finding, all_rules


def render_text(findings: List[Finding], new: Optional[List[Finding]] = None,
                fix_hints: bool = False) -> str:
    """``path:line:col: RID message`` per finding; new-vs-baseline ones are
    marked, and ``--fix-hints`` appends the suggested rewrite."""
    new_set = set(new or [])
    out: List[str] = []
    for f in findings:
        mark = " [NEW]" if f in new_set else ""
        out.append(f"{f.path}:{f.line}:{f.col + 1}: {f.rule_id}"
                   f"{mark} {f.message}")
        if f.snippet:
            out.append(f"    | {f.snippet}")
        if fix_hints and f.hint:
            out.append(f"    fix: {f.hint}")
    return "\n".join(out)


def render_summary(findings: List[Finding], new: List[Finding],
                   fixed: int, baseline_used: bool) -> str:
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule_id] = by_rule.get(f.rule_id, 0) + 1
    per = ", ".join(f"{rid}:{n}" for rid, n in sorted(by_rule.items()))
    line = f"torchlint: {len(findings)} finding(s)"
    if per:
        line += f" ({per})"
    if baseline_used:
        line += f"; {len(new)} new vs baseline"
        if fixed:
            line += (f", {fixed} fixed (regenerate with "
                     "`python -m pdnlp_tpu_torch.analysis --write-baseline`)")
    return line


def render_json(findings: List[Finding], new: List[Finding], fixed: int,
                baseline_used: bool) -> str:
    return json.dumps({
        "version": 1,
        "summary": {
            "total": len(findings),
            "new": len(new),
            "fixed_vs_baseline": fixed,
            "baseline_used": baseline_used,
        },
        "findings": [f.to_dict() for f in findings],
        "new_findings": [f.to_dict() for f in new],
    }, indent=2)


def render_sarif(findings: List[Finding], new: List[Finding],
                 baseline_used: bool) -> str:
    """SARIF 2.1.0 for CI annotation and editor ingestion.

    Every finding becomes a ``result`` with a physical location
    (1-indexed line/column, matching the text reporter); findings that
    are NEW vs the baseline carry ``level: error``, grandfathered ones
    ``level: note`` — so a SARIF viewer shows the ratchet the same way
    the exit code enforces it.  The fix hint rides in each rule's
    ``help`` and in the result's ``properties.hint``."""
    rules = all_rules()
    used = sorted({f.rule_id for f in findings})
    new_set = set(new)
    rule_descs = [{
        "id": rid,
        "name": rules[rid].name if rid in rules else rid,
        "shortDescription": {"text": rules[rid].name if rid in rules
                             else rid},
        "help": {"text": rules[rid].hint if rid in rules else ""},
    } for rid in used]
    results = [{
        "ruleId": f.rule_id,
        "level": ("error" if (not baseline_used or f in new_set)
                  else "note"),
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": f.line,
                           "startColumn": f.col + 1},
            },
        }],
        "properties": {"hint": f.hint,
                       "new_vs_baseline": (not baseline_used
                                           or f in new_set)},
    } for f in findings]
    return json.dumps({
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "torchlint",
                "rules": rule_descs,
            }},
            "results": results,
        }],
    }, indent=2)


def render_rule_table() -> str:
    """``--list-rules``: id, name, and the generic fix hint per rule."""
    rows = [(r.rule_id, r.name, r.hint) for r in all_rules().values()]
    width = max(len(n) for _, n, _ in rows)
    return "\n".join(f"{rid}  {name:<{width}}  {hint}"
                     for rid, name, hint in rows)
