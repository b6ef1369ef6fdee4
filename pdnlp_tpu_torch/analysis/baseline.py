"""torchlint baseline — the CI ratchet.

The committed ``pdnlp_tpu_torch/analysis/baseline.json`` records the
violations the port already carries; the lint (and its tier-1 pytest wrapper) fails only
when a (file, rule) bucket GROWS.  That makes adoption a ratchet, not a
flag day: existing debt is visible and enumerated, new debt is blocked, and
fixing old findings only ever loosens the gate (with a nudge to regenerate
so the ratchet tightens behind the fix).

Comparison is by per-(file, rule) COUNTS, not exact line numbers — editing
an unrelated part of a file shifts every line below it, and a ratchet that
cried wolf on every shift would be deleted within a week.  Recorded lines
are still kept (for humans, and to pick WHICH findings to blame when a
bucket grows).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from pdnlp_tpu_torch.analysis.core import Finding

DEFAULT_BASELINE = os.path.join("pdnlp_tpu_torch", "analysis",
                                "baseline.json")


def write(findings: List[Finding], path: str) -> None:
    # hand-written "reason" annotations (why a finding is grandfathered,
    # not fixed) survive regeneration for findings still at the same
    # (file, rule, line)
    reasons: Dict[Tuple[str, str, int], str] = {}
    if os.path.exists(path):
        for e in load(path):
            if "reason" in e:
                reasons[(e["file"], e["rule"], e["line"])] = e["reason"]
    entries = []
    for f in findings:
        d = f.to_dict()
        key = (d["file"], d["rule"], d["line"])
        if key in reasons:
            d["reason"] = reasons[key]
        entries.append(d)
    payload = {
        "version": 1,
        "tool": "python -m pdnlp_tpu_torch.analysis",
        "note": ("per-(file,rule) violation counts ratchet tier-1; "
                 "regenerate with `python -m pdnlp_tpu_torch.analysis "
                 "--write-baseline` "
                 "after fixing findings; hand-add \"reason\" keys to "
                 "grandfathered entries (kept across regeneration)"),
        "findings": entries,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def load(path: str) -> List[Dict]:
    with open(path, "r", encoding="utf-8") as f:
        payload = json.load(f)
    return payload.get("findings", [])


def _counts(entries) -> Dict[Tuple[str, str], int]:
    out: Dict[Tuple[str, str], int] = {}
    for e in entries:
        key = (e["file"], e["rule"]) if isinstance(e, dict) \
            else (e.path, e.rule_id)
        out[key] = out.get(key, 0) + 1
    return out


def compare(findings: List[Finding], baseline_entries: List[Dict]
            ) -> Tuple[List[Finding], int]:
    """(new findings, fixed count) vs the baseline.

    A bucket that grew by d blames the d findings whose lines the baseline
    does not record (falling back to the tail of the bucket when lines
    shifted wholesale)."""
    base_counts = _counts(baseline_entries)
    base_lines: Dict[Tuple[str, str], set] = {}
    for e in baseline_entries:
        base_lines.setdefault((e["file"], e["rule"]), set()).add(e["line"])

    new: List[Finding] = []
    cur_counts = _counts(findings)
    for key, cur in sorted(cur_counts.items()):
        base = base_counts.get(key, 0)
        if cur <= base:
            continue
        group = sorted((f for f in findings
                        if (f.path, f.rule_id) == key), key=Finding.sort_key)
        unseen = [f for f in group if f.line not in base_lines.get(key, set())]
        d = cur - base
        blamed = unseen[:d]
        if len(blamed) < d:  # lines shifted wholesale: blame from the tail
            rest = [f for f in group if f not in blamed]
            blamed += rest[-(d - len(blamed)):]
        new.extend(blamed)

    fixed = sum(max(0, base - cur_counts.get(key, 0))
                for key, base in base_counts.items())
    return sorted(new, key=Finding.sort_key), fixed
